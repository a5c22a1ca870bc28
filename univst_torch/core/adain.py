"""AdaIN operators with exact reference semantics (PyTorch port of
``univst_tpu/core/adain.py``).

The reference computes ``F.instance_norm(cnt) * sty_std + sty_mean``
(backbones/video_diffusion_sd/pnp_utils.py:114-139;
backbones/video_diffusion_sd3/pnp_utils.py:289-316). Two quirks are kept on
purpose because output parity depends on them:

  1. the scale/shift statistics use torch's default *unbiased* std (N-1),
     while ``F.instance_norm`` normalizes with the *biased* variance + 1e-5;
  2. ``F.instance_norm`` reads dim 1 as the channel dim, so for a
     ``[B, L, D]`` attention tensor it normalizes each token over D — not
     over the tokens the statistics are taken over.

Layouts follow the JAX package: latents ``[F, H, W, C]``, attention tensors
``[B, L, D]`` (SD) or per head ``[B, heads, N, C]`` / token-major
``[B, N, heads, C]`` (SD3). All statistics are fp32; the result has the content's dtype.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

_EPS = 1e-5  # torch F.instance_norm default

Dims = Union[int, Sequence[int]]


def _std_unbiased(x: torch.Tensor, dim: Dims) -> torch.Tensor:
    """torch.std's default unbiased (N-1) estimator, in fp32, keepdim."""
    return torch.std(x.float(), dim=dim, keepdim=True, unbiased=True)


def _instance_norm(x: torch.Tensor, dim: Dims) -> torch.Tensor:
    """Biased normalization with eps over ``dim``, as F.instance_norm does."""
    x = x.float()
    mean = x.mean(dim=dim, keepdim=True)
    sq = x.square().mean(dim=dim, keepdim=True)
    var = torch.clamp(sq - mean.square(), min=0.0)
    return (x - mean) / torch.sqrt(var + _EPS)


def attention_adain(cnt_feat: torch.Tensor, sty_feat: torch.Tensor) -> torch.Tensor:
    """AdaIN over attention K/V ``[B, L, D]`` tensors (SD variant).

    Style stats are per-(B, D) over tokens L (pnp_utils.py:116-121, dim=[1]);
    normalization is per-(B, L) over D (the F.instance_norm quirk,
    pnp_utils.py:123).
    """
    sty = sty_feat.float()
    out = _instance_norm(cnt_feat, 2) * _std_unbiased(sty, 1) + sty.mean(dim=1, keepdim=True)
    return out.to(cnt_feat.dtype)


def attention_adain_sd3(cnt_feat: torch.Tensor, sty_feat: torch.Tensor) -> torch.Tensor:
    """AdaIN for SD3 per-head K/V ``[B, heads, N, C]``.

    Style stats per-(B, heads, C) over N (sd3 pnp_utils.py:292-295,
    dim=[-2]); normalization per-(B, heads) jointly over (N, C), as
    F.instance_norm treats dims (2, 3) of a 4-d input (sd3 pnp_utils.py:300).
    """
    sty = sty_feat.float()
    out = _instance_norm(cnt_feat, (2, 3)) * _std_unbiased(sty, -2) + sty.mean(dim=-2, keepdim=True)
    return out.to(cnt_feat.dtype)


def attention_adain_sd3_tm(cnt_feat: torch.Tensor, sty_feat: torch.Tensor) -> torch.Tensor:
    """:func:`attention_adain_sd3` on token-major ``[B, N, heads, C]``
    tensors: style stats per-(B, heads, C) over N (axis 1), normalization
    per-(B, heads) over (N, C) = axes (1, 3)."""
    sty = sty_feat.float()
    out = _instance_norm(cnt_feat, (1, 3)) * _std_unbiased(sty, 1) + sty.mean(dim=1, keepdim=True)
    return out.to(cnt_feat.dtype)


def latent_adain(cnt_feat: torch.Tensor, sty_feat: torch.Tensor, shard=None) -> torch.Tensor:
    """Init/anchor latent AdaIN over ``[F, H, W, C]`` latents.

    Style stats per-(F, C) over (H, W) (reference dims [0, 3, 4] with B=1);
    normalization per-C over (F, H, W) — torch instance_norm on a 5D input
    with N=1 (pnp_utils.py:128-139). Under a frame ``shard``
    (``distributed.comm.FrameShard``) the latents hold this rank's frames:
    the normalization's statistics combine every rank's
    (``comm.sharded_var_mean``); the style statistics are per frame.
    """
    sty = sty_feat.float()
    if shard is None:
        cnt = _instance_norm(cnt_feat, (0, 1, 2))
    else:
        from univst_torch.distributed.comm import sharded_var_mean

        x = cnt_feat.float()
        var, mean = sharded_var_mean(x, (0, 1, 2), shard, site="latent_adain")
        cnt = (x - mean) / torch.sqrt(var + _EPS)
    out = cnt * _std_unbiased(sty, (1, 2)) + sty.mean(dim=(1, 2), keepdim=True)
    return out.to(cnt_feat.dtype)


def latent_adain_sd3(cnt_feat: torch.Tensor, sty_feat: torch.Tensor) -> torch.Tensor:
    """SD3 latent AdaIN over ``[F, H, W, C]`` latents: stats and
    normalization both per-(F, C) over (H, W) (sd3 pnp_utils.py:305-316,
    reference layout ``[F, C, H, W]``)."""
    sty = sty_feat.float()
    out = (_instance_norm(cnt_feat, (1, 2)) * _std_unbiased(sty, (1, 2))
           + sty.mean(dim=(1, 2), keepdim=True))
    return out.to(cnt_feat.dtype)
