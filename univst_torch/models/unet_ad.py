"""AnimateDiff-v2 UNet in PyTorch — port of ``univst_tpu/models/unet_ad.py``
(rebuild of backbones/animatediff/models/{unet.py,unet_blocks.py,
motion_module.py,attention.py,resnet.py}).

A per-frame 2D SD UNet plus temporal motion modules:

  * every conv and norm is per-frame 2D (InflatedConv3d / InflatedGroupNorm,
    resnet.py:10-29): no pseudo-3D temporal taps, no cross-frame statistics;
  * spatial attn1 is per-frame self-attention: this backbone builds no
    cross-frame K/V (unet_use_cross_frame_attention=False in
    animatediff-v2.yaml; the PnP patch gets clip_length=None,
    attention.py:344 + pnp_utils.py:59). The SD port's
    ``SpatioTemporalTransformer`` with an empty frame-index set is exactly
    the JAX package's ``ADTransformer`` / ``ADTransformerBlock`` /
    ``ADSelfAttention`` (plain, plain-shift, capture and inject modes), so
    it is reused here;
  * a motion module follows each (resnet, attn) pair of the down and up
    blocks at every resolution, and sits between attn and resnet 1 in the
    mid block (unet_blocks.py:271-277,385-390);
  * each motion module: per-frame GroupNorm -> proj_in -> one transformer
    block of two frame-axis self-attentions with sinusoidal positions (PE
    table of 24) and a GEGLU FF -> proj_out (zero at init) + residual
    (motion_module.py:52-247).

Attribute names follow the diffusers UNet2DConditionModel keys for the 2D
part and the ``mm_sd_v15_v2`` keys for the motion modules
(``{down,up}_blocks.i.motion_modules.j.temporal_transformer.*``,
``mid_block.motion_modules.0.*``). Public tensors keep the JAX layout:
latents ``[B*F, H, W, C]`` in, epsilon out, the captured feature
``[F, H, W, C]``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from univst_torch.models.layers import (
    FeedForwardGEGLU,
    GroupNorm,
    StyleCtx,
    TemporalSelfAttention,
    TimestepEmbedMLP,
    VideoCtx,
    timestep_embedding,
    upsample_nearest_2x,
)
from univst_torch.models.unet_sd import (
    PNP_SLOT_ORDER,
    PNP_UP_ATTENTIONS,
    SpatioTemporalTransformer,
    _Sampler,
)


@dataclasses.dataclass(frozen=True)
class UNetADConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    num_heads: Tuple[int, ...] = (8, 8, 8, 8)
    cross_attention_dim: int = 768
    norm_num_groups: int = 32
    use_linear_projection: bool = False
    down_block_has_attn: Tuple[bool, ...] = (True, True, True, False)
    up_block_has_attn: Tuple[bool, ...] = (False, True, True, True)
    # motion module config (animatediff-v2.yaml:7-14)
    motion_num_heads: int = 8
    motion_num_blocks: int = 1
    motion_attention_layers: int = 2  # ("Temporal_Self", "Temporal_Self")
    motion_pe_max_len: int = 24
    motion_mid_block: bool = True
    capture_up_block: Optional[int] = None

    @staticmethod
    def ad_v2(**kw) -> "UNetADConfig":
        return UNetADConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "UNetADConfig":
        return UNetADConfig(block_out_channels=(32, 64, 64, 64), num_heads=(2, 2, 2, 2),
                            motion_num_heads=2, cross_attention_dim=32, norm_num_groups=8, **kw)


def _sinusoidal_pe(max_len: int, d_model: int) -> torch.Tensor:
    """Sinusoidal positions (motion_module.py PositionalEncoding:229-247),
    computed in float64 and stored as float32, as the JAX package does."""
    position = torch.arange(max_len, dtype=torch.float64)[:, None]
    div_term = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float64)
                         * (-math.log(10000.0) / d_model))
    pe = torch.zeros(max_len, d_model, dtype=torch.float64)
    pe[:, 0::2] = torch.sin(position * div_term)
    pe[:, 1::2] = torch.cos(position * div_term)
    return pe.float()


class PositionalEncoding(nn.Module):
    """Adds the position of each frame to its tokens. The table is a
    non-persistent buffer: checkpoints that carry ``pos_encoder.pe`` have it
    ignored (``convert.load_motion_module``)."""

    def __init__(self, d_model: int, max_len: int):
        super().__init__()
        self.register_buffer("pe", _sinusoidal_pe(max_len, d_model), persistent=False)

    def forward(self, x, num_frames: int):
        if num_frames > self.pe.shape[0]:
            raise ValueError(f"{num_frames} frames exceed the motion module's positional "
                             f"table of {self.pe.shape[0]}")
        bf, l, d = x.shape
        x = x.reshape(bf // num_frames, num_frames, l, d) + self.pe[:num_frames, None].to(x.dtype)
        return x.reshape(bf, l, d)


class TemporalSelfAttentionPE(TemporalSelfAttention):
    """VersatileAttention 'Temporal_Self' (motion_module.py:250-337):
    frame-axis attention at each spatial location, on tokens with the
    sinusoidal frame position added."""

    def __init__(self, dim: int, num_heads: int, pe_max_len: int):
        super().__init__(dim, num_heads)
        self.pos_encoder = PositionalEncoding(dim, pe_max_len)

    def forward(self, x, num_frames: int):
        return super().forward(self.pos_encoder(x, num_frames), num_frames)


class TemporalTransformerBlock(nn.Module):
    def __init__(self, dim: int, cfg: UNetADConfig):
        super().__init__()
        n = cfg.motion_attention_layers
        self.attention_blocks = nn.ModuleList(
            [TemporalSelfAttentionPE(dim, cfg.motion_num_heads, cfg.motion_pe_max_len)
             for _ in range(n)])
        self.norms = nn.ModuleList([nn.LayerNorm(dim, eps=1e-6) for _ in range(n)])
        self.ff = FeedForwardGEGLU(dim)
        self.ff_norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x, num_frames: int):
        for attn, norm in zip(self.attention_blocks, self.norms):
            x = x + attn(norm(x), num_frames)
        return x + self.ff(self.ff_norm(x))


class TemporalTransformer3DModel(nn.Module):
    def __init__(self, dim: int, cfg: UNetADConfig):
        super().__init__()
        # 32 groups and eps 1e-6 whatever the UNet's group count
        # (motion_module.py TemporalTransformer3DModel)
        self.norm = GroupNorm(dim, 32, eps=1e-6)
        self.proj_in = nn.Linear(dim, dim)
        self.transformer_blocks = nn.ModuleList(
            [TemporalTransformerBlock(dim, cfg) for _ in range(cfg.motion_num_blocks)])
        self.proj_out = nn.Linear(dim, dim)

    def forward(self, x, num_frames: int, shard=None):
        """Under a frame ``shard`` the tokens move, after ``proj_in``, to the
        layout of every frame and 1/N of the tokens (``comm.ulysses_to_tokens``,
        one all-to-all; the JAX package's shard_map, unet_ad.py:186-220),
        so the position table and the frame attentions see all F frames;
        after ``proj_out`` they move back (one all-to-all). A token count
        that does not divide the mesh gathers the frames instead."""
        bf, c, hh, ww = x.shape
        tokens = self.proj_in(self.norm(x).flatten(2).transpose(1, 2))
        f = num_frames
        if shard is not None:
            from univst_torch.distributed.comm import ulysses_to_frames, ulysses_to_tokens

            tokens, f = ulysses_to_tokens(tokens, shard, site="motion_module"), shard.num_frames
        for blk in self.transformer_blocks:
            tokens = blk(tokens, f)
        out = self.proj_out(tokens)
        if shard is not None:
            out = ulysses_to_frames(out, shard, hh * ww, site="motion_module")
        return out.transpose(1, 2).reshape(bf, c, hh, ww) + x


class MotionModule(nn.Module):
    """VanillaTemporalModule (motion_module.py:52-162); the identity on a
    single frame."""

    def __init__(self, dim: int, cfg: UNetADConfig):
        super().__init__()
        self.temporal_transformer = TemporalTransformer3DModel(dim, cfg)

    def forward(self, x, video_ctx: VideoCtx):
        if not video_ctx.is_video and video_ctx.shard is None:
            return x
        return self.temporal_transformer(x, video_ctx.num_frames, video_ctx.shard)


class ADResnetBlock(nn.Module):
    """Per-frame 2D resnet (InflatedConv3d + InflatedGroupNorm): statistics
    over each frame alone, no temporal tap."""

    def __init__(self, in_ch: int, out_ch: int, temb_dim: int, groups: int):
        super().__init__()
        self.norm1 = GroupNorm(in_ch, groups, eps=1e-5)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_dim, out_ch)
        self.norm2 = GroupNorm(out_ch, groups, eps=1e-5)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x, temb, num_frames: int):
        h = self.conv1(self.norm1(x, silu=True))
        # temb is per video [B, C]: one copy per frame
        t = self.time_emb_proj(F.silu(temb)).repeat_interleave(num_frames, dim=0)
        h = self.conv2(self.norm2(h + t[:, :, None, None], silu=True))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class _Block(nn.Module):
    """One down / mid / up block: per layer a resnet, the spatial
    transformer (where the level has one) and a motion module."""

    def __init__(self, cfg: UNetADConfig, in_chs: List[int], out_ch: int, temb_dim: int,
                 num_heads: int, has_attn: bool, up_index: Optional[int] = None,
                 downsample: bool = False, upsample: bool = False):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ADResnetBlock(c, out_ch, temb_dim, cfg.norm_num_groups) for c in in_chs])
        self.attentions = None
        if has_attn:
            mods = []
            for i in range(len(in_chs)):
                is_pnp = up_index is not None and (up_index, i) in PNP_UP_ATTENTIONS
                slot = PNP_SLOT_ORDER.index((up_index, i)) if is_pnp else None
                mods.append(SpatioTemporalTransformer(out_ch, cfg, num_heads, apply_pnp=is_pnp,
                                                      pnp_slot=slot))
            self.attentions = nn.ModuleList(mods)
        self.motion_modules = nn.ModuleList([MotionModule(out_ch, cfg) for _ in in_chs])
        self.downsamplers = nn.ModuleList([_Sampler(out_ch, 2)]) if downsample else None
        self.upsamplers = nn.ModuleList([_Sampler(out_ch, 1)]) if upsample else None

    def layer(self, i: int, x, temb, context, video_ctx, style_ctx):
        x = self.resnets[i](x, temb, video_ctx.num_frames)
        if self.attentions is not None:
            x = self.attentions[i](x, context, video_ctx, style_ctx)
        return self.motion_modules[i](x, video_ctx)


class _MidBlock(nn.Module):
    """resnet 0 -> attn -> motion module -> resnet 1 (unet_blocks.py:271-277)."""

    def __init__(self, cfg: UNetADConfig, ch: int, temb_dim: int):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ADResnetBlock(ch, ch, temb_dim, cfg.norm_num_groups) for _ in range(2)])
        self.attentions = nn.ModuleList(
            [SpatioTemporalTransformer(ch, cfg, cfg.num_heads[-1])])
        self.motion_modules = (nn.ModuleList([MotionModule(ch, cfg)]) if cfg.motion_mid_block
                               else None)

    def forward(self, x, temb, context, video_ctx, style_ctx):
        x = self.resnets[0](x, temb, video_ctx.num_frames)
        x = self.attentions[0](x, context, video_ctx, style_ctx)
        if self.motion_modules is not None:
            x = self.motion_modules[0](x, video_ctx)
        return self.resnets[1](x, temb, video_ctx.num_frames)


class UNetAnimateDiff(nn.Module):
    """The AnimateDiff UNet, with the call signature of ``UNetPseudo3D`` so
    the pipeline and method loops serve both. ``forward`` returns
    (eps_prediction, captured_feature).

    Args:
      x: ``[B*F, H, W, C]`` latents, B = branch count (or steps, in the
        batched style capture).
      timestep: scalar, or one timestep per video ``[B]``.
      context: ``[B, 77, Dt]`` text embeddings (or ``[1, 77, Dt]`` shared,
        or one row per frame).
      controlnet_residuals: ``(down, mid)`` SparseControlNet residuals in the
        ``[B*F, H, W, C]`` layout, added to every skip and to the mid state.
    """

    def __init__(self, cfg: UNetADConfig):
        super().__init__()
        self.cfg = cfg
        boc = cfg.block_out_channels
        ch0, n = boc[0], len(boc)
        temb_dim = ch0 * 4
        self.conv_in = nn.Conv2d(cfg.in_channels, ch0, 3, padding=1)
        self.time_embedding = TimestepEmbedMLP(ch0, temb_dim)
        skip_chs = [ch0]
        downs, prev = [], ch0
        for i in range(n):
            downs.append(_Block(cfg, [prev] + [boc[i]] * (cfg.layers_per_block - 1), boc[i],
                                temb_dim, cfg.num_heads[i], cfg.down_block_has_attn[i],
                                downsample=i < n - 1))
            skip_chs += [boc[i]] * (cfg.layers_per_block + (1 if i < n - 1 else 0))
            prev = boc[i]
        self.down_blocks = nn.ModuleList(downs)
        self.mid_block = _MidBlock(cfg, boc[-1], temb_dim)
        ups = []
        rev_ch, rev_heads = list(reversed(boc)), list(reversed(cfg.num_heads))
        for i in range(n):
            in_chs = []
            for _ in range(cfg.layers_per_block + 1):
                in_chs.append(prev + skip_chs.pop())
                prev = rev_ch[i]
            ups.append(_Block(cfg, in_chs, rev_ch[i], temb_dim, rev_heads[i],
                              cfg.up_block_has_attn[i], up_index=i, upsample=i < n - 1))
        self.up_blocks = nn.ModuleList(ups)
        self.conv_norm_out = GroupNorm(ch0, cfg.norm_num_groups, eps=1e-5)
        self.conv_out = nn.Conv2d(ch0, cfg.out_channels, 3, padding=1)

    def motion_modules(self) -> List[MotionModule]:
        return [m for m in self.modules() if isinstance(m, MotionModule)]

    def forward(self, x, timestep, context, video_ctx: VideoCtx,
                style_ctx: Optional[StyleCtx] = None, controlnet_residuals=None):
        cfg = self.cfg
        f = video_ctx.num_frames
        b = x.shape[0] // f
        dtype = self.conv_in.weight.dtype
        t = torch.as_tensor(timestep, dtype=torch.float32, device=x.device).reshape(-1)
        temb = self.time_embedding(timestep_embedding(t.expand(b), cfg.block_out_channels[0])
                                   .to(dtype))
        context = context.to(dtype)

        h = self.conv_in(x.to(dtype).permute(0, 3, 1, 2))
        skips = [h]
        for blk in self.down_blocks:
            for i in range(len(blk.resnets)):
                h = blk.layer(i, h, temb, context, video_ctx, style_ctx)
                skips.append(h)
            if blk.downsamplers is not None:
                h = blk.downsamplers[0].conv(h)
                skips.append(h)
        h = self.mid_block(h, temb, context, video_ctx, style_ctx)

        # SparseControlNet residuals: additive on every skip and the mid state
        if controlnet_residuals is not None:
            down_res, mid_res = controlnet_residuals
            if len(down_res) != len(skips):
                raise ValueError(f"{len(down_res)} down residuals for {len(skips)} skips")
            skips = [s + r.to(dtype).permute(0, 3, 1, 2) for s, r in zip(skips, down_res)]
            h = h + mid_res.to(dtype).permute(0, 3, 1, 2)

        captured = None
        for bi, blk in enumerate(self.up_blocks):
            for i in range(len(blk.resnets)):
                h = blk.layer(i, torch.cat([h, skips.pop()], dim=1), temb, context, video_ctx,
                              style_ctx)
            if blk.upsamplers is not None:
                h = blk.upsamplers[0].conv(upsample_nearest_2x(h))
            if cfg.capture_up_block is not None and bi == cfg.capture_up_block:
                # batch element 0 == branch 0, as the reference saves sample[0]
                captured = h[:f].permute(0, 2, 3, 1)
        h = self.conv_out(self.conv_norm_out(h, silu=True))
        return h.permute(0, 2, 3, 1), captured
