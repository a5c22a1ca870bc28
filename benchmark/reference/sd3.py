"""Plain PyTorch reference of the SD3 video stylization: the text encoders
(CLIP-L, CLIP-bigG, T5-XXL) for the empty prompt, the MMDiT with joint
sparse-causal video attention and the AdaIN attention shift, the 16-channel
KL decoder, the flow-matching schedule and the stylization loop with the
controlled-velocity pull, mask blend and AdaIN re-anchor.

The style branch runs as one frame a step (its frames are the one style
latent repeated): a forward that yields its projected K/V per block, then
the [content | stylized] batch with the shift reading them — the method as
the JAX package and the port define it for SD3. (With frames repeated,
the F-frame style branch of a 3-branch batch would weigh its duplicate
image keys against the context keys of the joint softmax, a different
function; PERF.md records the difference.) Nothing here imports the program.

Layouts: latents ``[F, h, w, C]`` and frames ``[F, H, W, 3]`` at the edges;
tokens ``[B*F, L, D]`` inside.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.common import (
    Conv, Embedding, Linear, Norm, adain, attention, in_stats, resize_mask, shift_beta,
    timestep_embedding, video_attention,
)
from benchmark.reference.sd import ClipText, _VaeAttn, _VaeResnet, empty_prompt_ids

T5_EOS, T5_PAD = 1, 0


# -- T5-XXL encoder -----------------------------------------------------------------


class _RMS(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d))

    def forward(self, x, eps: float = 1e-6):
        xf = in_stats(x)
        return (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
                * in_stats(self.weight)).to(x.dtype)


class T5(nn.Module):
    """transformers ``T5EncoderModel`` (v1.1: gated-gelu, RMS norms, a
    relative position bias from the first block's table shared by all)."""

    def __init__(self, c: dict):
        super().__init__()
        self.c = c
        d, inner = c["d_model"], c["num_heads"] * c["d_kv"]
        self.shared = Embedding(c["vocab_size"], d)
        self.encoder = nn.Module()
        self.encoder.block = nn.ModuleList()
        for i in range(c["num_layers"]):
            blk = nn.Module()
            sa, ff = nn.Module(), nn.Module()
            sa.SelfAttention = nn.Module()
            for n, (a, b) in dict(q=(d, inner), k=(d, inner), v=(d, inner), o=(inner, d)).items():
                setattr(sa.SelfAttention, n, Linear(a, b, bias=False))
            if i == 0:
                sa.SelfAttention.relative_attention_bias = Embedding(
                    c["relative_attention_num_buckets"], c["num_heads"])
            sa.layer_norm = _RMS(d)
            ff.DenseReluDense = nn.Module()
            ff.DenseReluDense.wi_0 = Linear(d, c["d_ff"], bias=False)
            ff.DenseReluDense.wi_1 = Linear(d, c["d_ff"], bias=False)
            ff.DenseReluDense.wo = Linear(c["d_ff"], d, bias=False)
            ff.layer_norm = _RMS(d)
            blk.layer = nn.ModuleList([sa, ff])
            self.encoder.block.append(blk)
        self.encoder.final_layer_norm = _RMS(d)

    def _bias(self, n: int, device):
        c = self.c
        rel = torch.arange(n, device=device)[None, :] - torch.arange(n, device=device)[:, None]
        nb = c["relative_attention_num_buckets"] // 2
        exact = nb // 2
        bucket = (rel > 0).long() * nb
        r = rel.abs()
        large = exact + (torch.log(r.float() / exact + 1e-9)
                         / math.log(c["relative_attention_max_distance"] / exact)
                         * (nb - exact)).long()
        bucket = bucket + torch.where(r < exact, r, large.clamp(max=nb - 1))
        table = self.encoder.block[0].layer[0].SelfAttention.relative_attention_bias.weight
        return table.float()[bucket].permute(2, 0, 1)[None]

    def forward(self, ids):
        c = self.c
        x = self.shared.weight[ids]
        b, n = ids.shape
        bias = self._bias(n, ids.device)
        for blk in self.encoder.block:
            sa, ff = blk.layer
            a = sa.SelfAttention
            h = sa.layer_norm(x)

            def split(y):
                return y.reshape(b, n, c["num_heads"], c["d_kv"]).transpose(1, 2)

            q, k, v = split(a.q(h)), split(a.k(h)), split(a.v(h))
            q, k, v = a.q.cast(q, k, v)
            w = torch.softmax(q.float() @ k.float().transpose(-1, -2) + bias, -1)
            x = x + a.o((w.to(v.dtype) @ v).transpose(1, 2).reshape(b, n, -1))
            h = ff.layer_norm(x)
            d = ff.DenseReluDense
            x = x + d.wo(F.gelu(d.wi_0(h), approximate="tanh") * d.wi_1(h))
        return self.encoder.final_layer_norm(x)


# -- MMDiT ---------------------------------------------------------------------------


def sincos_table(dim: int, size: int) -> torch.Tensor:
    """diffusers' 2-d sin-cos positional table of a ``size`` x ``size``
    grid, ``[size * size, dim]``: the first half of the channels from the
    column coordinate, the second from the row."""
    def axis(d, pos):
        omega = 1.0 / 10000 ** (np.arange(d // 2, dtype=np.float64) / (d / 2.0))
        out = np.outer(pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], 1)

    cols, rows = np.meshgrid(np.arange(size, dtype=np.float64), np.arange(size, dtype=np.float64))
    return torch.as_tensor(np.concatenate([axis(dim // 2, cols), axis(dim // 2, rows)], 1),
                           dtype=torch.float32)


def _ln(x):
    return F.layer_norm(in_stats(x), (x.shape[-1],), eps=1e-6).to(x.dtype)


class _Mlp(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.net = nn.ModuleList([nn.Module(), nn.Identity(), Linear(4 * d, d)])
        self.net[0].proj = Linear(d, 4 * d)

    def forward(self, x):
        return self.net[2](F.gelu(self.net[0].proj(x), approximate="tanh"))


class _Block(nn.Module):
    """A joint block: adaLN-Zero on both streams, joint attention, gated
    gelu-tanh MLPs; the last block updates the image stream only."""

    def __init__(self, d: int, heads: int, last: bool):
        super().__init__()
        self.heads, self.last = heads, last
        self.norm1 = nn.Module()
        self.norm1.linear = Linear(d, 6 * d)
        self.norm1_context = nn.Module()
        self.norm1_context.linear = Linear(d, (2 if last else 6) * d)
        self.attn = nn.Module()
        for n in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj"):
            setattr(self.attn, n, Linear(d, d))
        self.attn.to_out = nn.ModuleList([Linear(d, d)])
        if not last:
            self.attn.to_add_out = Linear(d, d)
            self.ff_context = _Mlp(d)
        self.ff = _Mlp(d)

    def forward(self, x, ctx, temb, run):
        mods = self.norm1.linear(F.silu(temb))[:, None].chunk(6, -1)
        sm, scm, gm, smlp, sclp, gmlp = mods
        cm = self.norm1_context.linear(F.silu(temb))[:, None].chunk(2 if self.last else 6, -1)
        if self.last:
            css, cs = cm
        else:
            cs, css, cgm, csmlp, csclp, cglp = cm
        ax, ac = self._attention(_ln(x) * (1 + scm) + sm, _ln(ctx) * (1 + css) + cs, run)
        x = x + gm * ax
        x = x + gmlp * self.ff(_ln(x) * (1 + sclp) + smlp)
        if self.last:
            return x, None
        ctx = ctx + cgm * ac
        return x, ctx + cglp * self.ff_context(_ln(ctx) * (1 + csclp) + csmlp)

    def _attention(self, x, ctx, run):
        a, f, n = self.attn, run["frames"], x.shape[1]
        q, k, v = a.to_q(x), a.to_k(x), a.to_v(x)
        if run.get("capture") is not None:
            run["capture"].append((k, v))
        elif run.get("style_kv") is not None and run["shift"]:
            m = run["method"]
            beta = shift_beta(run["step"], m)
            sk, sv = run["style_kv"][run["block"]]
            h = self.heads

            def heads(t):
                return t.reshape(t.shape[0], n, h, -1)

            qn = m["gamma"] * (m["alpha"] * in_stats(q[:f])
                               + (1 - m["alpha"]) * in_stats(q[f:]))

            def kv(t, sty):
                # per head: normalized over tokens and channels, the style's
                # statistics over tokens
                sty = heads(sty)
                return (beta * adain(heads(t[f:]), sty, (1, 3), 1)
                        + (1 - beta) * in_stats(sty)).reshape(f, n, -1)

            q = torch.cat([q[:f], qn.to(q.dtype)])
            k = torch.cat([k[:f], kv(k, sk).to(k.dtype)])
            v = torch.cat([v[:f], kv(v, sv).to(v.dtype)])
        cq, ck, cv = a.add_q_proj(ctx), a.add_k_proj(ctx), a.add_v_proj(ctx)
        if run["indices"]:
            out = video_attention(q, k, v, self.heads, f, run["indices"], a.to_q.fp8,
                                  ctx=(cq, ck, cv))
        else:
            out = attention(torch.cat([q, cq], 1), torch.cat([k, ck], 1),
                            torch.cat([v, cv], 1), self.heads, a.to_q.fp8)
        ox = a.to_out[0](out[:, :n])
        return ox, (None if self.last else a.to_add_out(out[:, n:]))


class MMDiT(nn.Module):
    """diffusers ``SD3Transformer2DModel`` (SD3-medium: no q/k norms, no
    dual attention)."""

    def __init__(self, c: dict):
        super().__init__()
        d = c["num_attention_heads"] * c["attention_head_dim"]
        self.c, self.d = c, d
        self._table = None
        self.pos_embed = nn.Module()
        p = c["patch_size"]
        self.pos_embed.proj = Conv(c["in_channels"], d, p, stride=p)
        self.time_text_embed = nn.Module()
        for n, din in (("timestep_embedder", 256),
                       ("text_embedder", c["pooled_projection_dim"])):
            e = nn.Module()
            e.linear_1, e.linear_2 = Linear(din, d), Linear(d, d)
            setattr(self.time_text_embed, n, e)
        self.context_embedder = Linear(c["joint_attention_dim"], d)
        self.transformer_blocks = nn.ModuleList(
            [_Block(d, c["num_attention_heads"], i == c["num_layers"] - 1)
             for i in range(c["num_layers"])])
        self.norm_out = nn.Module()
        self.norm_out.linear = Linear(d, 2 * d)
        self.proj_out = Linear(d, p * p * c["out_channels"])

    def forward(self, x, t: float, context, pooled, run):
        """x ``[B*F, h, w, C]``; ``context`` ``[B*F, Lc, Dc]``, ``pooled``
        ``[B*F, Dp]``; returns the velocity ``[B*F, h, w, C]``."""
        c, dt = self.c, self.proj_out.weight.dtype
        p, ms = c["patch_size"], c["pos_embed_max_size"]
        bf, hh, ww, ch = x.shape
        gh, gw = hh // p, ww // p
        tok = self.pos_embed.proj(x.to(dt).permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        if self._table is None:  # the fixed table, made once
            self._table = sincos_table(self.d, ms).to(x.device).reshape(ms, ms, -1)
        table = self._table
        top, left = (ms - gh) // 2, (ms - gw) // 2
        tok = tok + table[top:top + gh, left:left + gw].reshape(1, gh * gw, -1).to(dt)
        tte = self.time_text_embed
        te = timestep_embedding(torch.full((bf,), float(t), device=x.device), 256).to(dt)
        temb = tte.timestep_embedder.linear_2(F.silu(tte.timestep_embedder.linear_1(te)))
        temb = temb + tte.text_embedder.linear_2(F.silu(tte.text_embedder.linear_1(pooled.to(dt))))
        ctx = self.context_embedder(context.to(dt))
        for i, blk in enumerate(self.transformer_blocks):
            tok, ctx = blk(tok, ctx, temb, dict(run, block=i))
        scale, shift = self.norm_out.linear(F.silu(temb))[:, None].chunk(2, -1)
        out = self.proj_out(_ln(tok) * (1 + scale) + shift)
        out = out.reshape(bf, gh, gw, p, p, c["out_channels"]).permute(0, 1, 3, 2, 4, 5)
        return out.reshape(bf, hh, ww, c["out_channels"])


# -- the 16-channel KL autoencoder -----------------------------------------------


class VAE(nn.Module):
    """diffusers ``AutoencoderKL`` with its quant convs, as the program
    builds it; the decode runs a frame at a time (no frame mixing)."""

    def __init__(self, c: dict):
        super().__init__()
        boc, g, n, lat = (c["block_out_channels"], c["norm_num_groups"], c["layers_per_block"],
                          c["latent_channels"])
        self.groups, self.scaling, self.shift = g, c["scaling_factor"], c["shift_factor"]

        def stack(chs, up):
            blocks = nn.ModuleList()
            prev = chs[0]
            for i, ch in enumerate(chs):
                blk = nn.Module()
                blk.resnets = nn.ModuleList([_VaeResnet(prev if j == 0 else ch, ch, g)
                                             for j in range(n + (1 if up else 0))])
                if i < len(chs) - 1:
                    s = nn.ModuleList([nn.Module()])
                    s[0].conv = Conv(ch, ch, 3, padding=1) if up else Conv(ch, ch, 3, stride=2)
                    setattr(blk, "upsamplers" if up else "downsamplers", s)
                blocks.append(blk)
                prev = ch
            return blocks

        def mid(ch):
            m = nn.Module()
            m.resnets = nn.ModuleList([_VaeResnet(ch, ch, g) for _ in range(2)])
            m.attentions = nn.ModuleList([_VaeAttn(ch, g)])
            return m

        enc = self.encoder = nn.Module()
        enc.conv_in = Conv(c["in_channels"], boc[0], 3, padding=1)
        enc.down_blocks = stack(list(boc), False)
        enc.mid_block = mid(boc[-1])
        enc.conv_norm_out = Norm(boc[-1])
        enc.conv_out = Conv(boc[-1], 2 * lat, 3, padding=1)
        self.quant_conv = Conv(2 * lat, 2 * lat, 1)
        self.post_quant_conv = Conv(lat, lat, 1)
        dec = self.decoder = nn.Module()
        rev = list(reversed(boc))
        dec.conv_in = Conv(lat, rev[0], 3, padding=1)
        dec.mid_block = mid(rev[0])
        dec.up_blocks = stack(rev, True)
        dec.conv_norm_out = Norm(rev[-1])
        dec.conv_out = Conv(rev[-1], c["out_channels"], 3, padding=1)

    def decode(self, z):
        """``[N, lat, h, w]`` normalized latents -> ``[N, 3, H, W]``."""
        dec = self.decoder
        h = dec.conv_in(self.post_quant_conv(z / self.scaling + self.shift))
        m = dec.mid_block
        h = m.resnets[1](m.attentions[0](m.resnets[0](h)))
        for blk in dec.up_blocks:
            for r in blk.resnets:
                h = r(h)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0].conv(F.interpolate(h, scale_factor=2.0, mode="nearest"))
        return dec.conv_out(F.silu(dec.conv_norm_out.group(h, self.groups, 1e-6)))


# -- the model and the stylization -----------------------------------------------


class SD3Reference(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        self.transformer = MMDiT(cfg["transformer"])
        self.vae = VAE(cfg["vae"])
        self.text_encoder = ClipText(cfg["text_encoder"])
        self.text_encoder_2 = ClipText(cfg["text_encoder_2"])
        self.text_encoder_3 = T5(cfg["text_encoder_3"])

    def prompt(self):
        """The empty prompt's (context ``[1, 77 + 256, 4096]``, pooled
        ``[1, 2048]``), fp32: the penultimate CLIP-L and CLIP-G states side by
        side, zero-padded to T5's width, then T5's states; the CLIPs'
        projected EOS states side by side."""
        dev = self.transformer.proj_out.weight.device
        ids = empty_prompt_ids(self.cfg["clip_max_length"], dev)
        sl, _, pl = self.text_encoder(ids)
        sg, _, pg = self.text_encoder_2(ids)
        t5_ids = torch.as_tensor([[T5_EOS] + [T5_PAD] * (self.cfg["t5_max_length"] - 1)],
                                 device=dev)
        ht = self.text_encoder_3(t5_ids)
        clip = torch.cat([sl[-2], sg[-2]], -1).float()
        clip = F.pad(clip, (0, ht.shape[-1] - clip.shape[-1]))
        return torch.cat([clip, ht.float()], 1), torch.cat([pl, pg], -1).float()

    def decode_uint8(self, latents, chunk: int):
        dt = self.vae.decoder.conv_in.weight.dtype
        outs = []
        for s in range(0, latents.shape[0], chunk):
            px = self.vae.decode(latents[s:s + chunk].float().permute(0, 3, 1, 2).to(dt))
            px = px.float().permute(0, 2, 3, 1)
            outs.append(torch.round(torch.clamp(px / 2 + 0.5, 0, 1) * 255).to(torch.uint8))
        return torch.cat(outs)


def sigmas(s: dict, n: int) -> np.ndarray:
    """Flow-matching sigmas, static shift, with the final 0 (float32)."""
    ts = np.linspace(1, s["num_train_timesteps"], n, dtype=np.float64)[::-1]
    x = ts / s["num_train_timesteps"]
    x = s["shift"] * x / (1 + (s["shift"] - 1) * x)
    return np.concatenate([x, [0.0]]).astype(np.float32)


def etas(m: dict, n: int) -> np.ndarray:
    """The controlled-velocity pull: ``eta_base`` on the steps of the
    50-step window ``[eta_start, eta_end)`` scaled to ``n`` steps."""
    s = max(0, min(int(round(m["eta_start_step"] * n / 50)), n - 1))
    e = max(s + 1, min(int(round(m["eta_end_step"] * n / 50)), n))
    out = np.zeros(n, np.float32)
    out[s:e] = m["eta_base"]
    return out


def stylize(ref: SD3Reference, content, style, init, mask, steps: int, prompt=None):
    """One clip: ``content`` ``[N+1, F, h, w, C]``, ``style`` ``[N+1, 1, ...]``,
    ``init`` ``[F, ...]``, ``mask`` ``[F, H, W]``; the pull's target is the
    content's first latent. Returns the stylized latents fp32."""
    m, cfg = ref.cfg["method"], ref.cfg
    f, hh, ww, _ = init.shape
    sg, eta = sigmas(cfg["scheduler"], steps), etas(m, steps)
    ctx, pooled = prompt if prompt is not None else ref.prompt()
    lo, hi = m["shift_window"]
    mk = in_stats(resize_mask(mask, hh, ww).permute(0, 2, 3, 1))
    target = in_stats(content[0])
    x = in_stats(init)
    base = dict(method=m, indices=tuple(m["frame_indices"]))
    for i in range(steps):
        cnt, sty = in_stats(content[i]), in_stats(style[i])
        if i <= m["blend_hi"] * steps:
            x = (1 - mk) * x + mk * cnt
        if m["adain_lo"] * steps <= i <= m["adain_hi"] * steps:
            x = (1 - mk) * adain(x, sty, (1, 2), (1, 2)) + mk * cnt
        sc, sn = float(sg[i]), float(sg[i + 1])
        t = sc * cfg["scheduler"]["num_train_timesteps"]
        if lo <= i <= hi:
            cap = []
            ref.transformer(sty, t, ctx, pooled, dict(base, frames=1, indices=(), capture=cap,
                                                      shift=False, step=i))
            run = dict(base, frames=f, style_kv=cap, shift=True, step=i)
            v = ref.transformer(torch.cat([cnt, x]), t, ctx.expand(2 * f, -1, -1),
                                pooled.expand(2 * f, -1), run)[f:]
        else:
            v = ref.transformer(x, t, ctx.expand(f, -1, -1), pooled.expand(f, -1),
                                dict(base, frames=f, shift=False, step=i))
        v = in_stats(v)
        v = v + float(eta[i]) * (-(target - x) / sc - v)
        x = x + (sn - sc) * v
    return x


def clip_frames(ref: SD3Reference, inputs: dict, traffic: dict, prompt=None):
    lat = stylize(ref, inputs["content"], inputs["style"], inputs["init"], inputs["mask"],
                  traffic["steps"], prompt)
    return lat, ref.decode_uint8(lat, traffic["decode_chunk"])


def build(cfg: dict, device, dtype=torch.bfloat16, meta: bool = False) -> SD3Reference:
    with torch.device("meta" if meta else device):
        return SD3Reference(cfg).to(dtype)
