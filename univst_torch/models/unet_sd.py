"""Pseudo-3D SD UNet (SD-1.5 / SD-2.1) in PyTorch — port of
``univst_tpu/models/unet_sd.py``.

A 2D SD UNet run on video with frames folded into the batch: sparse-causal
spatial attention, text cross-attention, and the PnP style shift on the 8
registered decoder attn1 layers. The temporal layers of the inflated model
(dirac temporal convs, zero-init temporal attention) are exact no-ops in
this training-free method, and the SD path elides them
(``temporal_identity``, as the JAX package builds SD);
``temporal_identity=False`` builds the inflated form.

Attribute names follow diffusers' ``UNet2DConditionModel`` so the released
(and the JAX package's synthetic) checkpoints load with ``strict=True``.
Public tensors keep the JAX layout: latents ``[B*F, H, W, C]`` in, epsilon
``[B*F, H, W, C]`` out, the captured feature ``[F, H, W, C]``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from univst_torch.models.layers import (
    CrossAttention,
    FeedForwardGEGLU,
    GroupNorm,
    PseudoConv3d,
    SelfAttention,
    StyleCtx,
    TemporalSelfAttention,
    TimestepEmbedMLP,
    VideoCtx,
    timestep_embedding,
    upsample_nearest_2x,
)

# The 8 decoder attn1 layers the reference registers for the PnP shift:
# up_res_dict = {1: [1, 2], 2: [0, 1, 2], 3: [0, 1, 2]} (pnp_utils.py:104).
PNP_UP_ATTENTIONS = frozenset(
    {(1, 1), (1, 2), (2, 0), (2, 1), (2, 2), (3, 0), (3, 1), (3, 2)}
)
# Slot order of injected style K/V (execution order through the decoder).
PNP_SLOT_ORDER = tuple(sorted(PNP_UP_ATTENTIONS))


def extract_pnp_kv(captured: Dict[int, Tuple[torch.Tensor, torch.Tensor]]) -> tuple:
    """The K/V a capture-mode forward recorded (``StyleCtx.captured``), as a
    tuple of (k, v) pairs in PNP_SLOT_ORDER."""
    if sorted(captured) != list(range(len(PNP_SLOT_ORDER))):
        raise ValueError(f"captured PnP slots {sorted(captured)} are incomplete")
    return tuple(captured[i] for i in range(len(PNP_SLOT_ORDER)))


@dataclasses.dataclass(frozen=True)
class UNetSDConfig:
    """SD-1.5 defaults; SD-2.1-base differs in num_heads/(cross|linear) fields."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    # diffusers 'attention_head_dim' in old SD configs == number of heads
    num_heads: Tuple[int, ...] = (8, 8, 8, 8)
    cross_attention_dim: int = 768
    norm_num_groups: int = 32
    use_linear_projection: bool = False
    down_block_has_attn: Tuple[bool, ...] = (True, True, True, False)
    up_block_has_attn: Tuple[bool, ...] = (False, True, True, True)
    # up block whose output feeds mask propagation; None disables capture
    # (reference default 2, run_content_inversion_sd.py:88)
    capture_up_block: Optional[int] = None
    # the temporal layers are exact no-ops and elided (see module doc);
    # False builds them (the JAX package's UNetSDConfig default)
    temporal_identity: bool = True

    @staticmethod
    def sd15(**kw) -> "UNetSDConfig":
        return UNetSDConfig(**kw)

    @staticmethod
    def sd21(**kw) -> "UNetSDConfig":
        return UNetSDConfig(
            num_heads=(5, 10, 20, 20), cross_attention_dim=1024, use_linear_projection=True, **kw
        )

    @staticmethod
    def tiny(**kw) -> "UNetSDConfig":
        """Small config for tests: same topology, ~1000x fewer FLOPs."""
        return UNetSDConfig(
            block_out_channels=(32, 64, 64, 64), num_heads=(2, 2, 2, 2),
            cross_attention_dim=32, norm_num_groups=8, **kw
        )


class TransformerBlock(nn.Module):
    """Sparse-causal self-attn -> text cross-attn -> GEGLU FF -> temporal
    attn (reference attention.py:156-346; the temporal attention only with
    ``temporal_attn``)."""

    def __init__(self, dim: int, context_dim: int, num_heads: int, apply_pnp: bool,
                 pnp_slot: Optional[int], temporal_attn: bool = False):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn1 = SelfAttention(dim, num_heads, apply_pnp=apply_pnp, pnp_slot=pnp_slot)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.attn2 = CrossAttention(dim, context_dim, num_heads)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)
        self.ff = FeedForwardGEGLU(dim)
        if temporal_attn:
            self.norm_temporal = nn.LayerNorm(dim, eps=1e-6)
            self.attn_temporal = TemporalSelfAttention(dim, num_heads)
        self.temporal_attn = temporal_attn

    def forward(self, x, context, video_ctx: VideoCtx, style_ctx: Optional[StyleCtx]):
        x = x + self.attn1(self.norm1(x), video_ctx, style_ctx)
        x = x + self.attn2(self.norm2(x), context)
        x = x + self.ff(self.norm3(x))
        if self.temporal_attn and (video_ctx.is_video or video_ctx.shard is not None):
            x = x + self.attn_temporal(self.norm_temporal(x), video_ctx.num_frames,
                                       video_ctx.shard)
        return x


class SpatioTemporalTransformer(nn.Module):
    """Per-frame GroupNorm -> proj_in -> block -> proj_out (+ residual);
    reference attention.py:40-153 (diffusers Transformer2DModel keys)."""

    def __init__(self, dim: int, cfg: UNetSDConfig, num_heads: int, apply_pnp: bool = False,
                 pnp_slot: Optional[int] = None, temporal_attn: bool = False):
        super().__init__()
        self.linear = cfg.use_linear_projection
        self.norm = GroupNorm(dim, cfg.norm_num_groups, eps=1e-6)
        if self.linear:
            self.proj_in = nn.Linear(dim, dim)
            self.proj_out = nn.Linear(dim, dim)
        else:
            self.proj_in = nn.Conv2d(dim, dim, 1)
            self.proj_out = nn.Conv2d(dim, dim, 1)
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(dim, cfg.cross_attention_dim, num_heads, apply_pnp, pnp_slot,
                              temporal_attn)])

    def forward(self, x, context, video_ctx: VideoCtx, style_ctx: Optional[StyleCtx]):
        bf, c, hh, ww = x.shape
        h = self.norm(x)
        if self.linear:
            tokens = self.proj_in(h.flatten(2).transpose(1, 2))
        else:
            tokens = self.proj_in(h).flatten(2).transpose(1, 2)
        # text context arrives [B, 77, Dt]; one copy per frame
        if context.shape[0] != bf:
            context = context.repeat_interleave(video_ctx.num_frames, dim=0)
        tokens = self.transformer_blocks[0](tokens, context, video_ctx, style_ctx)
        # back to channels-last [bf, c, hh, ww] through a 4-d view, so that a single frame's
        # batch stride is a whole frame's: cuDNN then keeps channels-last at bf = 1 as at
        # bf > 1, and the GroupNorms that follow stay on the kernel (group_norm.fits)
        if self.linear:
            h = self.proj_out(tokens).reshape(bf, hh, ww, c).permute(0, 3, 1, 2)
        else:
            h = self.proj_out(tokens.reshape(bf, hh, ww, c).permute(0, 3, 1, 2))
        return h + x


class ResnetBlockP3D(nn.Module):
    """ResnetBlockPseudo3D (reference resnet.py:239-397); GroupNorm statistics
    span frames (torch 5D GroupNorm semantics)."""

    def __init__(self, in_ch: int, out_ch: int, temb_dim: int, groups: int,
                 temporal: bool = False):
        super().__init__()
        self.norm1 = GroupNorm(in_ch, groups, eps=1e-5, across_frames=True)
        self.conv1 = PseudoConv3d(in_ch, out_ch, 3, temporal=temporal)
        self.time_emb_proj = nn.Linear(temb_dim, out_ch)
        self.norm2 = GroupNorm(out_ch, groups, eps=1e-5, across_frames=True)
        self.conv2 = PseudoConv3d(out_ch, out_ch, 3, temporal=temporal)
        self.conv_shortcut = PseudoConv3d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x, temb, num_frames: int, shard=None):
        h = self.conv1(self.norm1(x, num_frames, shard, silu=True), num_frames, shard)
        # temb is per video [B, C]: one copy per frame
        t = self.time_emb_proj(F.silu(temb)).repeat_interleave(num_frames, dim=0)
        h = h + t[:, :, None, None]
        h = self.conv2(self.norm2(h, num_frames, shard, silu=True), num_frames, shard)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class _Sampler(nn.Module):
    """Holds the diffusers ``{down,up}samplers.0.conv`` key."""

    def __init__(self, ch: int, stride: int, temporal: bool = False):
        super().__init__()
        self.conv = PseudoConv3d(ch, ch, 3, stride=stride, temporal=temporal)


class DownBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, temb_dim: int, num_heads: int, has_attn: bool,
                 add_downsample: bool, cfg: UNetSDConfig):
        super().__init__()
        n, tmp = cfg.layers_per_block, not cfg.temporal_identity
        self.resnets = nn.ModuleList(
            [ResnetBlockP3D(in_ch if i == 0 else out_ch, out_ch, temb_dim, cfg.norm_num_groups,
                            tmp) for i in range(n)])
        self.attentions = nn.ModuleList(
            [SpatioTemporalTransformer(out_ch, cfg, num_heads, temporal_attn=tmp)
             for _ in range(n)]
        ) if has_attn else None
        self.downsamplers = (nn.ModuleList([_Sampler(out_ch, 2, tmp)]) if add_downsample
                             else None)

    def forward(self, x, temb, context, video_ctx, style_ctx, skips: List[torch.Tensor]):
        for i, res in enumerate(self.resnets):
            x = res(x, temb, video_ctx.num_frames, video_ctx.shard)
            if self.attentions is not None:
                x = self.attentions[i](x, context, video_ctx, style_ctx)
            skips.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0].conv(x, video_ctx.num_frames, video_ctx.shard)
            skips.append(x)
        return x


class MidBlock(nn.Module):
    def __init__(self, ch: int, temb_dim: int, num_heads: int, cfg: UNetSDConfig):
        super().__init__()
        tmp = not cfg.temporal_identity
        self.resnets = nn.ModuleList(
            [ResnetBlockP3D(ch, ch, temb_dim, cfg.norm_num_groups, tmp) for _ in range(2)])
        self.attentions = nn.ModuleList(
            [SpatioTemporalTransformer(ch, cfg, num_heads, temporal_attn=tmp)])

    def forward(self, x, temb, context, video_ctx, style_ctx):
        x = self.resnets[0](x, temb, video_ctx.num_frames, video_ctx.shard)
        x = self.attentions[0](x, context, video_ctx, style_ctx)
        return self.resnets[1](x, temb, video_ctx.num_frames, video_ctx.shard)


class UpBlock(nn.Module):
    def __init__(self, block_index: int, in_chs: List[int], out_ch: int, temb_dim: int,
                 num_heads: int, has_attn: bool, add_upsample: bool, cfg: UNetSDConfig):
        super().__init__()
        tmp = not cfg.temporal_identity
        self.resnets = nn.ModuleList(
            [ResnetBlockP3D(c, out_ch, temb_dim, cfg.norm_num_groups, tmp) for c in in_chs])
        self.attentions = None
        if has_attn:
            mods = []
            for i in range(len(in_chs)):
                is_pnp = (block_index, i) in PNP_UP_ATTENTIONS
                mods.append(SpatioTemporalTransformer(
                    out_ch, cfg, num_heads, apply_pnp=is_pnp,
                    pnp_slot=PNP_SLOT_ORDER.index((block_index, i)) if is_pnp else None,
                    temporal_attn=tmp))
            self.attentions = nn.ModuleList(mods)
        self.upsamplers = nn.ModuleList([_Sampler(out_ch, 1, tmp)]) if add_upsample else None

    def forward(self, x, skips: List[torch.Tensor], temb, context, video_ctx, style_ctx):
        for i, res in enumerate(self.resnets):
            x = res(torch.cat([x, skips.pop()], dim=1), temb, video_ctx.num_frames,
                    video_ctx.shard)
            if self.attentions is not None:
                x = self.attentions[i](x, context, video_ctx, style_ctx)
        if self.upsamplers is not None:
            x = self.upsamplers[0].conv(upsample_nearest_2x(x), video_ctx.num_frames,
                                        video_ctx.shard)
        return x


class UNetPseudo3D(nn.Module):
    """The video UNet. ``forward`` returns (eps_prediction, captured_feature).

    Args:
      x: ``[B*F, H, W, C]`` latents, B = branch count (or steps, in the
        single-frame style pre-pass).
      timestep: scalar, or one timestep per video ``[B]``.
      context: ``[B, 77, Dt]`` text embeddings (or ``[1, 77, Dt]`` shared).
    """

    def __init__(self, cfg: UNetSDConfig):
        super().__init__()
        self.cfg = cfg
        tmp = not cfg.temporal_identity
        boc = cfg.block_out_channels
        ch0 = boc[0]
        temb_dim = ch0 * 4
        n = len(boc)
        self.conv_in = PseudoConv3d(cfg.in_channels, ch0, 3, temporal=tmp)
        self.time_embedding = TimestepEmbedMLP(ch0, temb_dim)
        skip_chs = [ch0]
        downs, prev = [], ch0
        for i in range(n):
            downs.append(DownBlock(prev, boc[i], temb_dim, cfg.num_heads[i],
                                   cfg.down_block_has_attn[i], i < n - 1, cfg))
            skip_chs += [boc[i]] * (cfg.layers_per_block + (1 if i < n - 1 else 0))
            prev = boc[i]
        self.down_blocks = nn.ModuleList(downs)
        self.mid_block = MidBlock(boc[-1], temb_dim, cfg.num_heads[-1], cfg)
        ups = []
        rev_ch, rev_heads = list(reversed(boc)), list(reversed(cfg.num_heads))
        for i in range(n):
            in_chs = []
            for _ in range(cfg.layers_per_block + 1):
                in_chs.append(prev + skip_chs.pop())
                prev = rev_ch[i]
            ups.append(UpBlock(i, in_chs, rev_ch[i], temb_dim, rev_heads[i],
                               cfg.up_block_has_attn[i], i < n - 1, cfg))
        self.up_blocks = nn.ModuleList(ups)
        self.conv_norm_out = GroupNorm(ch0, cfg.norm_num_groups, eps=1e-5, across_frames=True)
        self.conv_out = PseudoConv3d(ch0, cfg.out_channels, 3, temporal=tmp)

    def forward(self, x, timestep, context, video_ctx: VideoCtx,
                style_ctx: Optional[StyleCtx] = None):
        cfg = self.cfg
        f = video_ctx.num_frames
        b = x.shape[0] // f
        dtype = self.conv_in.weight.dtype
        t = torch.as_tensor(timestep, dtype=torch.float32, device=x.device).reshape(-1)
        t_emb = timestep_embedding(t.expand(b), cfg.block_out_channels[0])
        temb = self.time_embedding(t_emb.to(dtype))
        context = context.to(dtype)

        h = self.conv_in(x.to(dtype).permute(0, 3, 1, 2), f, video_ctx.shard)
        skips = [h]
        for blk in self.down_blocks:
            h = blk(h, temb, context, video_ctx, style_ctx, skips)
        h = self.mid_block(h, temb, context, video_ctx, style_ctx)
        captured = None
        for i, blk in enumerate(self.up_blocks):
            n_layers = cfg.layers_per_block + 1
            block_skips = skips[-n_layers:]
            del skips[-n_layers:]
            h = blk(h, block_skips, temb, context, video_ctx, style_ctx)
            if cfg.capture_up_block is not None and i == cfg.capture_up_block:
                # reference saves sample[0] as [F, H, W, C]
                # (unet_3d_condition.py:429-436); batch element 0 == branch 0
                captured = h[:f].permute(0, 2, 3, 1)
        h = self.conv_out(self.conv_norm_out(h, f, video_ctx.shard, silu=True), f,
                          video_ctx.shard)
        return h.permute(0, 2, 3, 1), captured
