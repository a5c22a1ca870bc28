"""Sparse ControlNet for the AnimateDiff backbone — port of
``univst_tpu/models/sparse_controlnet.py`` (rebuild of
backbones/animatediff/models/sparse_controlnet.py:44-587; no CLI of the
reference or of either package builds it, SURVEY.md C20).

  * A conditioning embedding: a conv stack that brings the RGB / scribble
    condition down to latent resolution, with a zero-init output conv
    (sparse_controlnet.py:49-82), or one zero-init conv
    (``use_simplified_condition_embedding``).
  * The AnimateDiff UNet's encoder (down blocks and mid block, with motion
    modules), built from the port's AD UNet blocks. As in the JAX package,
    the per-frame conditioning mask (the "sparse" part: only some frames
    carry a condition) is concatenated onto the noisy latents, so
    ``conv_in`` takes ``in_channels + 1`` channels.
  * A zero-init 1x1 projection of each encoder state: ``(down, mid)``
    residuals in the ``[B*F, h, w, C]`` layout, which
    ``UNetAnimateDiff(controlnet_residuals=...)`` adds to its skips and mid
    state.

The JAX package has no checkpoint layout for this module; the attribute
names are those of the public AnimateDiff SparseCtrl checkpoints (diffusers
``SparseControlNetModel``): ``controlnet_cond_embedding.{conv_in, blocks.i,
conv_out}``, the encoder under the UNet's ``down_blocks.*`` / ``mid_block.*``
keys, ``controlnet_down_blocks.i`` and ``controlnet_mid_block``. One thing
differs from those checkpoints: they concatenate the mask onto the
condition (``controlnet_cond_embedding.conv_in`` takes the extra channel),
where this module follows the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from univst_torch.models.layers import TimestepEmbedMLP, VideoCtx, timestep_embedding
from univst_torch.models.unet_ad import UNetADConfig, _Block, _MidBlock


@dataclasses.dataclass(frozen=True)
class SparseControlNetConfig:
    unet: UNetADConfig = UNetADConfig()
    conditioning_channels: int = 3
    concate_conditioning_mask: bool = True
    use_simplified_condition_embedding: bool = False
    cond_embed_channels: Tuple[int, ...] = (16, 32, 96, 256)

    @staticmethod
    def tiny(**kw) -> "SparseControlNetConfig":
        return SparseControlNetConfig(unet=UNetADConfig.tiny(), cond_embed_channels=(4, 8), **kw)


def _zero_conv(cin: int, cout: int, k: int) -> nn.Conv2d:
    conv = nn.Conv2d(cin, cout, k, padding=k // 2)
    nn.init.zeros_(conv.weight)
    nn.init.zeros_(conv.bias)
    return conv


class ConditioningEmbedding(nn.Module):
    """conv -> (conv, stride-2 conv)* -> zero-init conv out, SiLU between
    (sparse_controlnet.py:49-82)."""

    def __init__(self, in_channels: int, out_channels: int, block_channels: Tuple[int, ...]):
        super().__init__()
        self.conv_in = nn.Conv2d(in_channels, block_channels[0], 3, padding=1)
        blocks = []
        for c_in, c_out in zip(block_channels[:-1], block_channels[1:]):
            blocks.append(nn.Conv2d(c_in, c_in, 3, padding=1))
            blocks.append(nn.Conv2d(c_in, c_out, 3, padding=1, stride=2))
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = _zero_conv(block_channels[-1], out_channels, 3)

    def forward(self, cond):
        h = F.silu(self.conv_in(cond))
        for blk in self.blocks:
            h = F.silu(blk(h))
        return self.conv_out(h)


class SparseControlNet(nn.Module):
    """``forward`` returns ``(down_residuals, mid_residual)`` for
    ``UNetAnimateDiff``.

    Args:
      x: ``[B*F, h, w, C]`` noisy latents.
      timestep: scalar, or one timestep per video ``[B]``.
      context: ``[B, L, Dt]`` text embeddings.
      cond: ``[B*F, H, W, conditioning_channels]`` conditioning frames (0
        where a frame has none); H / h is the embedding's downsampling,
        2 ** (len(cond_embed_channels) - 1).
      cond_mask: ``[B*F, h, w, 1]``, 1 on conditioned frames.
      video_ctx: the frame count, with an empty frame index set (this
        backbone builds no cross-frame K/V), as the AD UNet takes it.
      conditioning_scale: multiplies every residual.
    """

    def __init__(self, cfg: SparseControlNetConfig):
        super().__init__()
        self.cfg = cfg
        u = cfg.unet
        boc = u.block_out_channels
        ch0, n = boc[0], len(boc)
        temb_dim = ch0 * 4
        self.conv_in = nn.Conv2d(u.in_channels + int(cfg.concate_conditioning_mask), ch0, 3,
                                 padding=1)
        self.time_embedding = TimestepEmbedMLP(ch0, temb_dim)
        if cfg.use_simplified_condition_embedding:
            self.controlnet_cond_embedding = _zero_conv(cfg.conditioning_channels, ch0, 3)
        else:
            self.controlnet_cond_embedding = ConditioningEmbedding(
                cfg.conditioning_channels, ch0, cfg.cond_embed_channels)
        downs, res_chs, prev = [], [ch0], ch0
        for i in range(n):
            downs.append(_Block(u, [prev] + [boc[i]] * (u.layers_per_block - 1), boc[i],
                                temb_dim, u.num_heads[i], u.down_block_has_attn[i],
                                downsample=i < n - 1))
            res_chs += [boc[i]] * (u.layers_per_block + (1 if i < n - 1 else 0))
            prev = boc[i]
        self.down_blocks = nn.ModuleList(downs)
        self.mid_block = _MidBlock(u, boc[-1], temb_dim)
        self.controlnet_down_blocks = nn.ModuleList([_zero_conv(c, c, 1) for c in res_chs])
        self.controlnet_mid_block = _zero_conv(boc[-1], boc[-1], 1)

    def forward(self, x, timestep, context, cond, cond_mask, video_ctx: VideoCtx,
                conditioning_scale: float = 1.0):
        b = x.shape[0] // video_ctx.num_frames
        dtype = self.conv_in.weight.dtype
        t = torch.as_tensor(timestep, dtype=torch.float32, device=x.device).reshape(-1)
        ch0 = self.cfg.unet.block_out_channels[0]
        temb = self.time_embedding(timestep_embedding(t.expand(b), ch0).to(dtype))
        cond_lat = self.controlnet_cond_embedding(cond.to(dtype).permute(0, 3, 1, 2))
        h = x.to(dtype).permute(0, 3, 1, 2)
        if self.cfg.concate_conditioning_mask:
            h = torch.cat([h, cond_mask.to(dtype).permute(0, 3, 1, 2)], dim=1)
        h = self.conv_in(h) + cond_lat
        context = context.to(dtype)

        states = [h]
        for blk in self.down_blocks:
            for i in range(len(blk.resnets)):
                h = blk.layer(i, h, temb, context, video_ctx, None)
                states.append(h)
            if blk.downsamplers is not None:
                h = blk.downsamplers[0].conv(h)
                states.append(h)
        h = self.mid_block(h, temb, context, video_ctx, None)

        def out(proj, s):
            return (proj(s) * conditioning_scale).permute(0, 2, 3, 1)

        down = tuple(out(p, s) for p, s in zip(self.controlnet_down_blocks, states))
        return down, out(self.controlnet_mid_block, h)
