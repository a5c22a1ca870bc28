"""Plain PyTorch reference of the SD-1.5 video stylization: the CLIP text
encoder, the UNet run frame by frame with sparse-causal self-attention and
the AdaIN attention shift, the KL autoencoder with the stable-video-diffusion
temporal decoder, DDIM, and the stylization loop with mask blend and AdaIN
re-anchor.

Written from the method's definition (UniVST's ``video_style_transfer``
with its PnP attention patch): phase 1 is the 3-branch [content | style |
stylized] batch, each branch a video of F frames, the style branch's frames
the one style latent repeated; past the shift window the branches no longer
couple and the stylized branch runs alone. Nothing here imports the program.

Layouts: NCHW inside; latents ``[F, h, w, C]`` and frames ``[F, H, W, 3]``
at the edges, as the benchmark's traffic holds them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.common import (
    Conv, Embedding, Linear, Norm, adain, attention, in_stats, resize_mask, shift_beta,
    timestep_embedding, video_attention,
)

BOS, EOS = 49406, 49407


# -- CLIP text encoder --------------------------------------------------------------


class _ClipLayer(nn.Module):
    def __init__(self, d: int, inner: int, heads: int, act: str):
        super().__init__()
        self.heads, self.act = heads, act
        self.self_attn = nn.Module()
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self.self_attn, n, Linear(d, d))
        self.layer_norm1, self.layer_norm2 = Norm(d), Norm(d)
        self.mlp = nn.Module()
        self.mlp.fc1, self.mlp.fc2 = Linear(d, inner), Linear(inner, d)

    def forward(self, x):
        a = self.self_attn
        h = self.layer_norm1.layer(x, 1e-5)
        x = x + a.out_proj(attention(a.q_proj(h), a.k_proj(h), a.v_proj(h), self.heads,
                                     a.q_proj.fp8, causal=True))
        h = self.mlp.fc1(self.layer_norm2.layer(x, 1e-5))
        h = h * torch.sigmoid(1.702 * h) if self.act == "quick_gelu" else F.gelu(h)
        return x + self.mlp.fc2(h)


class ClipText(nn.Module):
    """transformers ``CLIPTextModel[WithProjection]``; ``forward`` returns
    (hidden states after each layer, the embeddings first; the final-normed
    last state; pooled)."""

    def __init__(self, c: dict):
        super().__init__()
        d = c["hidden_size"]
        self.text_model = tm = nn.Module()
        tm.embeddings = nn.Module()
        tm.embeddings.token_embedding = Embedding(c["vocab_size"], d)
        tm.embeddings.position_embedding = Embedding(c["max_position_embeddings"], d)
        tm.encoder = nn.Module()
        tm.encoder.layers = nn.ModuleList(
            [_ClipLayer(d, c["intermediate_size"], c["num_attention_heads"], c["hidden_act"])
             for _ in range(c["num_hidden_layers"])])
        tm.final_layer_norm = Norm(d)
        if c.get("projection_dim"):
            self.text_projection = Linear(d, c["projection_dim"], bias=False)

    def forward(self, ids):
        tm = self.text_model
        e = tm.embeddings
        x = e.token_embedding.weight[ids] + e.position_embedding.weight[None, :ids.shape[1]]
        states = [x]
        for layer in tm.encoder.layers:
            x = layer(x)
            states.append(x)
        last = tm.final_layer_norm.layer(x, 1e-5)
        pooled = last[torch.arange(ids.shape[0], device=ids.device), (ids == EOS).int().argmax(1)]
        if hasattr(self, "text_projection"):
            pooled = self.text_projection(pooled)
        return states, last, pooled


def empty_prompt_ids(length: int = 77, device=None):
    """CLIP's tokens of the empty prompt: BOS, then EOS, padded with EOS."""
    return torch.as_tensor([[BOS] + [EOS] * (length - 1)], device=device)


# -- UNet ----------------------------------------------------------------------------


class _Resnet(nn.Module):
    """ResnetBlock of the pseudo-3D UNet: its group norms take their
    statistics over the whole video (torch GroupNorm on ``[B, C, F, H, W]``)."""

    def __init__(self, cin: int, cout: int, temb: int, groups: int):
        super().__init__()
        self.groups = groups
        self.norm1, self.conv1 = Norm(cin), Conv(cin, cout, 3, padding=1)
        self.time_emb_proj = Linear(temb, cout)
        self.norm2, self.conv2 = Norm(cout), Conv(cout, cout, 3, padding=1)
        if cin != cout:
            self.conv_shortcut = Conv(cin, cout, 1)

    def _norm(self, norm, x, f):
        bf, c, h, w = x.shape
        x5 = x.reshape(bf // f, f, c, h, w).transpose(1, 2)
        return norm.group(x5, self.groups, 1e-5).transpose(1, 2).reshape(bf, c, h, w)

    def forward(self, x, temb, f):
        h = self.conv1(F.silu(self._norm(self.norm1, x, f)))
        h = h + self.time_emb_proj(F.silu(temb)).repeat_interleave(f, 0)[:, :, None, None]
        h = self.conv2(F.silu(self._norm(self.norm2, h, f)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class _Attn(nn.Module):
    def __init__(self, d: int, dctx: int, heads: int):
        super().__init__()
        self.heads = heads
        self.to_q, self.to_k, self.to_v = Linear(d, d, False), Linear(dctx, d, False), Linear(
            dctx, d, False)
        self.to_out = nn.ModuleList([Linear(d, d)])


class _Transformer(nn.Module):
    """Transformer2DModel with one BasicTransformerBlock: per-frame group
    norm, 1x1 conv in, sparse-causal self-attention (with the AdaIN shift on
    a PnP layer), text cross-attention, GEGLU feed-forward, 1x1 conv out."""

    def __init__(self, d: int, dctx: int, heads: int, groups: int, pnp: bool):
        super().__init__()
        self.groups, self.pnp = groups, pnp
        self.norm = Norm(d)
        self.proj_in, self.proj_out = Conv(d, d, 1), Conv(d, d, 1)
        blk = nn.Module()
        blk.norm1, blk.norm2, blk.norm3 = Norm(d), Norm(d), Norm(d)
        blk.attn1, blk.attn2 = _Attn(d, d, heads), _Attn(d, dctx, heads)
        blk.ff = nn.Module()
        blk.ff.net = nn.ModuleList([nn.Module(), nn.Identity(), Linear(4 * d, d)])
        blk.ff.net[0].proj = Linear(d, 8 * d)
        self.transformer_blocks = nn.ModuleList([blk])

    def forward(self, x, ctx, run):
        bf, c, hh, ww = x.shape
        blk = self.transformer_blocks[0]
        h = self.proj_in(self.norm.group(x, self.groups, 1e-6)).flatten(2).transpose(1, 2)
        h = h + self._self_attn(blk.attn1, blk.norm1.layer(h, 1e-5), run)
        a = blk.attn2
        y = blk.norm2.layer(h, 1e-5)
        h = h + a.to_out[0](attention(a.to_q(y), a.to_k(ctx), a.to_v(ctx), a.heads, a.to_q.fp8))
        g, gate = blk.ff.net[0].proj(blk.norm3.layer(h, 1e-5)).chunk(2, -1)
        h = h + blk.ff.net[2](g * F.gelu(gate))
        return x + self.proj_out(h.transpose(1, 2).reshape(bf, c, hh, ww))

    def _self_attn(self, a, y, run):
        q, k, v = a.to_q(y), a.to_k(y), a.to_v(y)
        indices = run["pnp_indices"] if self.pnp and run["stylize"] else run["indices"]
        if self.pnp and run["shift"]:
            # [content | style | stylized]: the stylized branch's q blends the
            # content's; its k, v are the AdaIN of its own on the style's
            m, f = run["method"], run["frames"]
            beta = shift_beta(run["step"], m)
            qn = m["gamma"] * (m["alpha"] * in_stats(q[:f])
                               + (1 - m["alpha"]) * in_stats(q[2 * f:]))

            def kv(x):
                sty = x[f:2 * f]
                # per token over channels; the style's statistics over tokens
                return beta * adain(x[2 * f:], sty, 2, 1) + (1 - beta) * in_stats(sty)

            q = torch.cat([q[:2 * f], qn.to(q.dtype)])
            k = torch.cat([k[:2 * f], kv(k).to(k.dtype)])
            v = torch.cat([v[:2 * f], kv(v).to(v.dtype)])
        out = video_attention(q, k, v, a.heads, run["frames"], indices, a.to_q.fp8)
        return a.to_out[0](out)


class UNet(nn.Module):
    """SD UNet2DConditionModel (CrossAttnDown x3, Down, mid, Up, CrossAttnUp
    x3) run on ``[B*F, C, h, w]`` with frames in the batch."""

    def __init__(self, c: dict):
        super().__init__()
        boc, g = c["block_out_channels"], c["norm_num_groups"]
        heads, dctx, n = c["attention_head_dim"], c["cross_attention_dim"], c["layers_per_block"]
        t = boc[0] * 4
        self.groups = g
        self.conv_in = Conv(c["in_channels"], boc[0], 3, padding=1)
        self.time_embedding = nn.Module()
        self.time_embedding.linear_1, self.time_embedding.linear_2 = Linear(boc[0], t), Linear(t, t)
        attn_down = ["CrossAttn" in s for s in c["down_block_types"]]
        attn_up = ["CrossAttn" in s for s in c["up_block_types"]]
        self.down_blocks = nn.ModuleList()
        prev, skips = boc[0], [boc[0]]
        for i, ch in enumerate(boc):
            blk = nn.Module()
            blk.resnets = nn.ModuleList([_Resnet(prev if j == 0 else ch, ch, t, g)
                                         for j in range(n)])
            if attn_down[i]:
                blk.attentions = nn.ModuleList([_Transformer(ch, dctx, heads, g, False)
                                                for _ in range(n)])
            skips += [ch] * n
            if i < len(boc) - 1:
                blk.downsamplers = nn.ModuleList([nn.Module()])
                blk.downsamplers[0].conv = Conv(ch, ch, 3, stride=2, padding=1)
                skips.append(ch)
            self.down_blocks.append(blk)
            prev = ch
        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList([_Resnet(prev, prev, t, g) for _ in range(2)])
        self.mid_block.attentions = nn.ModuleList([_Transformer(prev, dctx, heads, g, False)])
        self.up_blocks = nn.ModuleList()
        pnp = {(b, j) for b, js in c["pnp_up_attentions"].items() for j in js}
        for i, ch in enumerate(reversed(boc)):
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            for j in range(n + 1):
                blk.resnets.append(_Resnet(prev + skips.pop(), ch, t, g))
                prev = ch
            if attn_up[i]:
                blk.attentions = nn.ModuleList(
                    [_Transformer(ch, dctx, heads, g, (str(i), j) in pnp) for j in range(n + 1)])
            if i < len(boc) - 1:
                blk.upsamplers = nn.ModuleList([nn.Module()])
                blk.upsamplers[0].conv = Conv(ch, ch, 3, padding=1)
            self.up_blocks.append(blk)
        self.conv_norm_out = Norm(boc[0])
        self.conv_out = Conv(boc[0], c["out_channels"], 3, padding=1)

    def forward(self, x, t: float, ctx, run):
        """x ``[B*F, C, h, w]``; ``ctx`` ``[B*F, 77, D]``; ``run`` the step's
        video and style settings. Returns the noise prediction."""
        f = run["frames"]
        b = x.shape[0] // f
        dt = self.conv_in.weight.dtype
        te = timestep_embedding(torch.full((b,), float(t), device=x.device),
                                self.conv_in.weight.shape[0]).to(dt)
        temb = self.time_embedding.linear_2(F.silu(self.time_embedding.linear_1(te)))
        h = self.conv_in(x.to(dt))
        ctx = ctx.to(dt)
        skips = [h]
        for blk in self.down_blocks:
            for j, res in enumerate(blk.resnets):
                h = res(h, temb, f)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h, ctx, run)
                skips.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0].conv(h)
                skips.append(h)
        mb = self.mid_block
        h = mb.resnets[1](mb.attentions[0](mb.resnets[0](h, temb, f), ctx, run), temb, f)
        for blk in self.up_blocks:
            for j, res in enumerate(blk.resnets):
                h = res(torch.cat([h, skips.pop()], 1), temb, f)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h, ctx, run)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0].conv(F.interpolate(h, scale_factor=2.0, mode="nearest"))
        bf, c, hh, ww = h.shape
        h5 = h.reshape(b, f, c, hh, ww).transpose(1, 2)
        h = self.conv_norm_out.group(h5, self.groups, 1e-5).transpose(1, 2).reshape(bf, c, hh, ww)
        return self.conv_out(F.silu(h))


# -- KL autoencoder with the temporal decoder ----------------------------------------


class _VaeResnet(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int, k=3, pad=1):
        super().__init__()
        self.groups = groups
        self.norm1, self.conv1 = Norm(cin), Conv(cin, cout, k, padding=pad)
        self.norm2, self.conv2 = Norm(cout), Conv(cout, cout, k, padding=pad)
        if cin != cout:
            self.conv_shortcut = Conv(cin, cout, 1 if isinstance(k, int) else (1, 1, 1))

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1.group(x, self.groups, 1e-6)))
        h = self.conv2(F.silu(self.norm2.group(h, self.groups, 1e-6)))
        return (self.conv_shortcut(x) if hasattr(self, "conv_shortcut") else x) + h


def _per_frame_norm(norm, x5, groups):
    """Group norm of each frame of ``[B, C, F, H, W]`` on its own."""
    b, c, f, h, w = x5.shape
    x = x5.transpose(1, 2).reshape(b * f, c, h, w)
    return norm.group(x, groups, 1e-6).reshape(b, f, c, h, w).transpose(1, 2)


class _TemporalResnet(_VaeResnet):
    """The frame-axis resnet: (3, 1, 1) convs, zero-padded at the clip's
    ends, with per-frame group norms."""

    def __init__(self, c: int, groups: int):
        super().__init__(c, c, groups, k=(3, 1, 1), pad=(1, 0, 0))

    def forward(self, x5):
        h = self.conv1(F.silu(_per_frame_norm(self.norm1, x5, self.groups)))
        h = self.conv2(F.silu(_per_frame_norm(self.norm2, h, self.groups)))
        return x5 + h


class _STResnet(nn.Module):
    """SpatioTemporalResBlock: a spatial resnet, a temporal resnet on its
    output, blended by ``sigmoid(mix_factor)`` toward the spatial one."""

    def __init__(self, cin: int, cout: int, groups: int):
        super().__init__()
        self.spatial_res_block = _VaeResnet(cin, cout, groups)
        self.temporal_res_block = _TemporalResnet(cout, groups)
        self.time_mixer = nn.Module()
        self.time_mixer.mix_factor = nn.Parameter(torch.empty(()))

    def forward(self, x, f):
        h = self.spatial_res_block(x)
        n, c, hh, ww = h.shape
        t = self.temporal_res_block(h.reshape(n // f, f, c, hh, ww).transpose(1, 2))
        t = t.transpose(1, 2).reshape(n, c, hh, ww)
        a = torch.sigmoid(self.time_mixer.mix_factor.float()).to(h.dtype)
        return a * h + (1 - a) * t


class _VaeAttn(nn.Module):
    def __init__(self, c: int, groups: int):
        super().__init__()
        self.groups = groups
        self.group_norm = Norm(c)
        self.to_q, self.to_k, self.to_v = Linear(c, c), Linear(c, c), Linear(c, c)
        self.to_out = nn.ModuleList([Linear(c, c)])

    def forward(self, x):
        n, c, h, w = x.shape
        y = self.group_norm.group(x, self.groups, 1e-6).flatten(2).transpose(1, 2)
        o = self.to_out[0](attention(self.to_q(y), self.to_k(y), self.to_v(y), 1, self.to_q.fp8))
        return x + o.transpose(1, 2).reshape(n, c, h, w)


class TemporalVAE(nn.Module):
    """diffusers ``AutoencoderKLTemporalDecoder`` (stable-video-diffusion):
    the KL encoder, ``quant_conv``, and the temporal decoder."""

    def __init__(self, c: dict):
        super().__init__()
        boc, g, n = c["block_out_channels"], c["norm_num_groups"], c["layers_per_block"]
        lat = c["latent_channels"]
        self.groups, self.scaling = g, c["scaling_factor"]
        enc = self.encoder = nn.Module()
        enc.conv_in = Conv(c["in_channels"], boc[0], 3, padding=1)
        enc.down_blocks = nn.ModuleList()
        prev = boc[0]
        for i, ch in enumerate(boc):
            blk = nn.Module()
            blk.resnets = nn.ModuleList([_VaeResnet(prev if j == 0 else ch, ch, g)
                                         for j in range(n)])
            if i < len(boc) - 1:
                blk.downsamplers = nn.ModuleList([nn.Module()])
                blk.downsamplers[0].conv = Conv(ch, ch, 3, stride=2)
            enc.down_blocks.append(blk)
            prev = ch
        enc.mid_block = nn.Module()
        enc.mid_block.resnets = nn.ModuleList([_VaeResnet(prev, prev, g) for _ in range(2)])
        enc.mid_block.attentions = nn.ModuleList([_VaeAttn(prev, g)])
        enc.conv_norm_out = Norm(prev)
        enc.conv_out = Conv(prev, 2 * lat, 3, padding=1)
        self.quant_conv = Conv(2 * lat, 2 * lat, 1)

        dec = self.decoder = nn.Module()
        rev = list(reversed(boc))
        dec.conv_in = Conv(lat, rev[0], 3, padding=1)
        dec.mid_block = nn.Module()
        dec.mid_block.resnets = nn.ModuleList([_STResnet(rev[0], rev[0], g) for _ in range(2)])
        dec.mid_block.attentions = nn.ModuleList([_VaeAttn(rev[0], g)])
        dec.up_blocks = nn.ModuleList()
        prev = rev[0]
        for i, ch in enumerate(rev):
            blk = nn.Module()
            blk.resnets = nn.ModuleList([_STResnet(prev if j == 0 else ch, ch, g)
                                         for j in range(n + 1)])
            if i < len(rev) - 1:
                blk.upsamplers = nn.ModuleList([nn.Module()])
                blk.upsamplers[0].conv = Conv(ch, ch, 3, padding=1)
            dec.up_blocks.append(blk)
            prev = ch
        dec.conv_norm_out = Norm(prev)
        dec.conv_out = Conv(prev, c["out_channels"], 3, padding=1)
        dec.time_conv_out = Conv(c["out_channels"], c["out_channels"], (3, 1, 1),
                                 padding=(1, 0, 0))

    def encode(self, x):
        """``[F, C, H, W]`` pixels in [-1, 1] -> (mean, logvar) ``[F, lat, h, w]``."""
        enc = self.encoder
        h = enc.conv_in(x)
        for blk in enc.down_blocks:
            for r in blk.resnets:
                h = r(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0].conv(F.pad(h, (0, 1, 0, 1)))
        mb = enc.mid_block
        h = mb.resnets[1](mb.attentions[0](mb.resnets[0](h)))
        h = enc.conv_out(F.silu(enc.conv_norm_out.group(h, self.groups, 1e-6)))
        mean, logvar = self.quant_conv(h).chunk(2, 1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z):
        """``[F, lat, h, w]`` (unscaled) -> ``[F, 3, H, W]``; the temporal
        layers see these F frames."""
        dec, f = self.decoder, z.shape[0]
        h = dec.conv_in(z)
        mb = dec.mid_block
        h = mb.resnets[1](mb.attentions[0](mb.resnets[0](h, f)), f)
        for blk in dec.up_blocks:
            for r in blk.resnets:
                h = r(h, f)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0].conv(F.interpolate(h, scale_factor=2.0, mode="nearest"))
        h = dec.conv_out(F.silu(dec.conv_norm_out.group(h, self.groups, 1e-6)))
        n, c, hh, ww = h.shape
        h5 = dec.time_conv_out(h.reshape(1, n, c, hh, ww).transpose(1, 2))
        return h5.transpose(1, 2).reshape(n, c, hh, ww)


# -- the model and the stylization ---------------------------------------------------


class SDReference(nn.Module):
    """The three modules under their checkpoint prefixes."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        self.unet = UNet(cfg["unet"])
        self.vae = TemporalVAE(cfg["vae"])
        self.text_encoder = ClipText(cfg["text_encoder"])

    def prompt_context(self):
        """The empty prompt's last hidden state, ``[1, 77, D]`` fp32."""
        ids = empty_prompt_ids(self.cfg["text_encoder"]["max_position_embeddings"],
                               self.unet.conv_in.weight.device)
        return self.text_encoder(ids)[1].float()

    def decode_uint8(self, latents, chunk: int):
        """Latents ``[F, h, w, C]`` -> uint8 frames ``[F, H, W, 3]``, ``chunk``
        frames a temporal-decoder call."""
        dt = self.vae.decoder.conv_in.weight.dtype
        outs = []
        for s in range(0, latents.shape[0], chunk):
            z = (latents[s:s + chunk].float() / self.vae.scaling).to(dt).permute(0, 3, 1, 2)
            px = self.vae.decode(z).float().permute(0, 2, 3, 1)
            outs.append(torch.round(torch.clamp(px / 2 + 0.5, 0, 1) * 255).to(torch.uint8))
        return torch.cat(outs)


class DDIM:
    """diffusers DDIMScheduler (epsilon prediction, eta 0, 'leading'
    spacing); the table in float64, the update in float32."""

    def __init__(self, s: dict):
        betas = np.linspace(s["beta_start"] ** 0.5, s["beta_end"] ** 0.5,
                            s["num_train_timesteps"], dtype=np.float64) ** 2
        self.ac = np.cumprod(1.0 - betas).astype(np.float32)
        self.final = np.float32(1.0) if s["set_alpha_to_one"] else self.ac[0]
        self.train, self.offset = s["num_train_timesteps"], s["steps_offset"]

    def timesteps(self, n: int):
        return (np.arange(n)[::-1] * (self.train // n)).astype(np.int64) + self.offset

    def alpha(self, t: int):
        return self.final if t < 0 else self.ac[min(t, self.train - 1)]

    def move(self, eps, x, a_from, a_to):
        """x at alpha-bar ``a_from`` -> at ``a_to`` along the predicted x0."""
        x0 = (x - float(np.sqrt(1 - a_from)) * eps) / float(np.sqrt(a_from))
        return float(np.sqrt(a_to)) * x0 + float(np.sqrt(1 - a_to)) * eps

    def step(self, eps, t: int, x, n: int):
        return self.move(in_stats(eps), in_stats(x), self.alpha(t),
                         self.alpha(t - self.train // n))


def stylize(ref: SDReference, content, style, init, mask, steps: int):
    """UniVST's stylization of one clip: ``content`` ``[N+1, F, h, w, C]`` and
    ``style`` ``[N+1, 1, h, w, C]`` trajectories (index i is step i's latent),
    ``init`` ``[F, h, w, C]``, ``mask`` ``[F, H, W]``. Returns the stylized
    latents ``[F, h, w, C]`` fp32."""
    m, cfg = ref.cfg["method"], ref.cfg
    sched = DDIM(cfg["scheduler"])
    f = init.shape[0]
    ts = sched.timesteps(steps)
    ctx = ref.prompt_context()
    lo, hi = m["shift_window"]
    mk = in_stats(resize_mask(mask, init.shape[1], init.shape[2]).permute(0, 2, 3, 1))
    x = in_stats(init)
    for i, t in enumerate(ts):
        cnt, sty = in_stats(content[i]), in_stats(style[i])
        if i <= m["blend_hi"] * steps:
            x = (1 - mk) * x + mk * cnt
        if m["adain_lo"] * steps < i <= m["adain_hi"] * steps:
            # per channel over the clip; the style's statistics per frame
            x = (1 - mk) * adain(x, sty, (0, 1, 2), (1, 2)) + mk * cnt
        shift = lo <= i <= hi
        rows = torch.cat([cnt, sty.expand_as(cnt), x]) if shift else x
        run = dict(frames=f, step=i, method=m, stylize=True, shift=shift,
                   indices=tuple(m["frame_indices"]), pnp_indices=tuple(m["pnp_frame_indices"]))
        nb = rows.shape[0] // f
        eps = ref.unet(rows.permute(0, 3, 1, 2), float(t),
                       ctx.expand(rows.shape[0], -1, -1), run)
        eps = in_stats(eps[(nb - 1) * f:]).permute(0, 2, 3, 1)
        x = sched.step(eps, int(t), x, steps)
    return x


def clip_frames(ref: SDReference, inputs: dict, traffic: dict):
    """One clip of the stylization traffic: stylized latents and uint8 frames."""
    lat = stylize(ref, inputs["content"], inputs["style"], inputs["init"], inputs["mask"],
                  traffic["steps"])
    return lat, ref.decode_uint8(lat, traffic["decode_chunk"])


def build(cfg: dict, device, dtype=torch.bfloat16, meta: bool = False) -> SDReference:
    """The reference model, parameters uninitialized (``meta``: on the meta
    device, to read names, shapes and FLOPs)."""
    with torch.device("meta" if meta else device):
        return SDReference(cfg).to(dtype)
