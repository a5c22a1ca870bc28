"""Shared building blocks of the video diffusion backbones (PyTorch port of
``univst_tpu/models/layers.py``).

Layouts: feature maps run NCHW inside the modules, ``[B*F, C, H, W]`` with
the frame count carried in a :class:`VideoCtx`; token sequences are
``[B*F, L, D]``. Module attribute names follow the diffusers key names, so
a diffusers-layout state dict loads with ``strict=True``.

The reference's monkey-patched attention state is two explicit arguments:
  * :class:`VideoCtx` — video shape + sparse-causal index sets;
  * :class:`StyleCtx` — step index + shift constants; ``None`` outside
    stylization.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from univst_torch.attention.ops import (
    apply_style_shift,
    apply_style_shift_injected,
    mha,
    video_mha,
)
from univst_torch.core.config import FrameIndex, StyleShiftConfig
from univst_torch.models import group_norm as gn


@dataclasses.dataclass(frozen=True)
class VideoCtx:
    """Video shape and sparse-causal index sets.

    ``frame_indices`` is the model-default index set of every attn1 layer
    (video_diffusion_sd/models/attention.py:356). ``pnp_frame_indices`` is the
    set of the patched decoder layers during stylization (pnp_utils.py:25);
    ``None`` falls back to ``frame_indices``.

    ``shard`` (a ``distributed.comm.FrameShard``: the global frame count,
    this rank's offset, the mesh) marks a frame-parallel forward:
    ``num_frames`` is then this rank's share, and the layers that cross
    frames (the sparse-causal attention, the frame-spanning GroupNorm, the
    temporal taps and attentions) exchange what they read across ranks.
    ``None`` on one device.
    """

    num_frames: int = 1
    frame_indices: Tuple[FrameIndex, ...] = (-1, 0, "first")
    pnp_frame_indices: Optional[Tuple[FrameIndex, ...]] = None
    shard: Optional[object] = None

    @property
    def is_video(self) -> bool:
        return self.num_frames > 1

    @property
    def pnp_indices(self) -> Tuple[FrameIndex, ...]:
        return self.frame_indices if self.pnp_frame_indices is None else self.pnp_frame_indices


@dataclasses.dataclass
class StyleCtx:
    """Per-step stylization context for the PnP attn1 layers.

    Three modes:
      * plain shift (``cfg`` set): 3-branch batch [content | style | stylized];
      * inject (``style_kv`` set): 2-branch batch [content | stylized] with the
        style branch's K/V precomputed per PnP slot, each ``[1, L, D]`` (a
        single style frame) or ``[F, L, D]`` (one per frame);
      * capture (``capture=True``): each PnP attn1 records its projected K/V
        in ``captured[slot]``; no shift is applied.
    """

    step_idx: int = 0
    cfg: Optional[StyleShiftConfig] = None
    style_kv: Optional[Tuple] = None
    capture: bool = False
    captured: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = dataclasses.field(
        default_factory=dict)


def timestep_embedding(timesteps: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal timestep embedding, fp32, as the SD UNet configures diffusers'
    get_timestep_embedding (flip_sin_to_cos=True, freq_shift=0)."""
    t = timesteps.float().reshape(-1)
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    emb = t[:, None] * torch.exp(exponent)[None, :]
    out = torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)
    if dim % 2 == 1:
        out = F.pad(out, (0, 1))
    return out


class TimestepEmbedMLP(nn.Module):
    """linear -> silu -> linear (diffusers TimestepEmbedding)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, out_dim)
        self.linear_2 = nn.Linear(out_dim, out_dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class GroupNorm(nn.Module):
    """GroupNorm over ``[B*F, C, *spatial]`` with optional cross-frame stats.

    torch GroupNorm on the reference's 5D ``[B, C, F, H, W]`` tensors takes its
    statistics over (C/g, F, H, W), spanning frames (ResnetBlockPseudo3D,
    resnet.py:274-296): ``across_frames=True`` reproduces that on the
    frames-in-batch layout, where a bare ``nn.GroupNorm`` would normalize each
    frame alone. ``across_frames=False`` is the per-frame form of the
    transformer blocks and the VAE. Statistics and affine run in fp32 (float64
    on a float64 input: the parity tests' referee).
    Under a frame ``shard`` the frame-spanning statistics combine every
    rank's (``comm.sharded_var_mean``). ``silu=True`` applies the SiLU that
    follows the norm in the resnets.

    A bf16 CUDA input the kernel takes (channels-last, as the UNet and the
    VAEs run: ``group_norm.fits``), outside the sharded frame-spanning form
    and outside autograd, runs the CUDA kernel
    (``group_norm.group_norm_cuda``, the SiLU fused before its one bf16
    rounding); every other call runs the eager chain
    (``group_norm.group_norm_plain``), then ``F.silu``.
    """

    def __init__(self, num_channels: int, num_groups: int = 32, eps: float = 1e-5,
                 across_frames: bool = False):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.across_frames = across_frames
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x, num_frames: int = 1, shard=None, silu: bool = False):
        shard = shard if self.across_frames else None
        frames = num_frames if self.across_frames else 1
        if x.is_cuda:
            grad = torch.is_grad_enabled() and (x.requires_grad or self.weight.requires_grad)
            if (shard is None and x.dtype == torch.bfloat16 and not grad
                    and gn.fits(x, self.num_groups)):
                return gn.launch(x, self.weight, self.bias, self.num_groups, frames, self.eps,
                                 silu)
            gn.group_norm_cuda.eager_cuda += 1
        out = gn.group_norm_plain(x, self.weight, self.bias, self.num_groups, self.eps, frames,
                                  shard)
        return F.silu(out) if silu else out


class GEGLU(nn.Module):
    """diffusers GEGLU: one projection split into value and exact-erf gelu gate."""

    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForwardGEGLU(nn.Module):
    """GEGLU MLP (diffusers FeedForward, activation_fn='geglu'); ``net`` keeps
    the diffusers indices (0: GEGLU, 1: dropout, 2: out)."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(), nn.Linear(dim * mult, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class SelfAttention(nn.Module):
    """Sparse-causal spatial self-attention with the PnP shift.

    SparseCausalAttention (video_diffusion_sd/models/attention.py:349) plus
    the PnP-patched forward (pnp_utils.py:18-100): shift first, then the
    cross-frame K/V.
    """

    def __init__(self, dim: int, num_heads: int, apply_pnp: bool = False,
                 pnp_slot: Optional[int] = None):
        super().__init__()
        self.num_heads = num_heads
        self.apply_pnp = apply_pnp
        self.pnp_slot = pnp_slot
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(dim, dim, bias=False)
        self.to_v = nn.Linear(dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def forward(self, x, video_ctx: VideoCtx, style_ctx: Optional[StyleCtx] = None):
        q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)
        # only the 8 patched decoder layers switch to the PnP index set, and
        # only during stylization (pnp_utils.py:25 vs models/attention.py:356)
        indices = video_ctx.frame_indices
        if self.apply_pnp and style_ctx is not None:
            indices = video_ctx.pnp_indices
            if style_ctx.capture:
                style_ctx.captured[self.pnp_slot] = (k, v)
            elif style_ctx.style_kv is not None:
                sk, sv = style_ctx.style_kv[self.pnp_slot]
                q, k, v = apply_style_shift_injected(
                    q, k, v, sk, sv, style_ctx.step_idx, style_ctx.cfg, video_ctx.num_frames)
            elif style_ctx.cfg is not None:
                q, k, v = apply_style_shift(q, k, v, style_ctx.step_idx, style_ctx.cfg,
                                            video_ctx.num_frames)
        if indices and (video_ctx.is_video or video_ctx.shard is not None):
            out = video_mha(q, k, v, self.num_heads, video_ctx.num_frames, indices,
                            shard=video_ctx.shard)
        else:
            out = mha(q, k, v, self.num_heads)
        return self.to_out[0](out)


class CrossAttention(nn.Module):
    """Text cross-attention (diffusers attn2)."""

    def __init__(self, dim: int, context_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(context_dim, dim, bias=False)
        self.to_v = nn.Linear(context_dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def forward(self, x, context):
        out = mha(self.to_q(x), self.to_k(context), self.to_v(context), self.num_heads)
        return self.to_out[0](out)


class TemporalSelfAttention(nn.Module):
    """Attention over the frame axis at each spatial location (reference
    attention.py:225-233): q/k/v projections on ``[B*F, L, D]``, then one
    attention per (video, token, head) over that video's F frames. The
    reference initializes ``to_out`` to zero, so the inflated SD model equals
    the 2D model until temporal weights load."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(dim, dim, bias=False)
        self.to_v = nn.Linear(dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def forward(self, x, num_frames: int, shard=None):
        if shard is not None:
            # Ulysses: every frame of 1/N of the tokens, and back
            from univst_torch.distributed.comm import ulysses_to_frames, ulysses_to_tokens

            out = self.forward(ulysses_to_tokens(x, shard), shard.num_frames)
            return ulysses_to_frames(out, shard, x.shape[1])
        bf, l, d = x.shape
        f, h = num_frames, self.num_heads
        b, dh = bf // f, d // h

        def frames(t):  # [B*F, L, D] -> [B*L, H, F, dh]
            return t.reshape(b, f, l, h, dh).permute(0, 2, 3, 1, 4).reshape(b * l, h, f, dh)

        # a plain batched product in the JAX package (no Pallas kernel);
        # PyTorch's fused attention here
        out = F.scaled_dot_product_attention(frames(self.to_q(x)), frames(self.to_k(x)),
                                             frames(self.to_v(x)))
        return self.to_out[0](out.reshape(b, l, h, f, dh).permute(0, 3, 1, 2, 4).reshape(bf, l, d))


class PseudoConv3d(nn.Conv2d):
    """The pseudo-3D conv (reference resnet.py:12-80): a 2D conv on each
    frame, then, with ``temporal``, a 1D conv over the frame axis at each
    pixel (``conv_temporal``; dirac-initialized, so the pair equals the 2D
    conv until temporal weights load; none for 1x1 convs or single frames).
    No 2D checkpoint carries that tap and nothing trains it, so the SD path
    elides it (``temporal_identity``, the JAX package's default for SD).
    The weight keeps the diffusers ``Conv2d`` key.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, stride: int = 1,
                 temporal: bool = False):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride, padding=kernel_size // 2)
        self.conv_temporal = None
        if temporal and kernel_size > 1:
            self.conv_temporal = nn.Conv1d(out_ch, out_ch, kernel_size, padding=kernel_size // 2)
            with torch.no_grad():
                nn.init.dirac_(self.conv_temporal.weight)
                nn.init.zeros_(self.conv_temporal.bias)

    def forward(self, x, num_frames: int = 1, shard=None):
        x = super().forward(x)
        if self.conv_temporal is None or (num_frames <= 1 and shard is None):
            return x
        bf, c, h, w = x.shape
        b = bf // num_frames
        x4 = x.reshape(b, num_frames, c, h * w)
        if shard is not None:
            # the +/-1 frame from the neighbour ranks replaces the zero padding
            from univst_torch.distributed.comm import halo_1d

            xt = halo_1d(x4, shard, dim=1).permute(0, 3, 2, 1).reshape(b * h * w, c, -1)
            xt = F.conv1d(xt, self.conv_temporal.weight, self.conv_temporal.bias)
        else:
            xt = self.conv_temporal(x4.permute(0, 3, 2, 1).reshape(b * h * w, c, num_frames))
        xt = xt.reshape(b, h * w, c, num_frames)
        return xt.permute(0, 3, 2, 1).reshape(bf, c, h, w)


def upsample_nearest_2x(x):
    """[N, C, H, W] -> [N, C, 2H, 2W] nearest (reference resnet.py:145)."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")
