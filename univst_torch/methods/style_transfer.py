"""AdaIN-guided localized style transfer loops — port of
``univst_tpu/methods/style_transfer.py``.

Rebuild of ``video_style_transfer`` (SD: backbones/video_diffusion_sd/
pipelines/stable_diffusion.py:630-766; SD3: backbones/video_diffusion_sd3/
pipelines/custom_pipeline.py:126-371): the content and style trajectories
are stacked tensors indexed per step, and the mask is resized once up front.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from univst_torch.core.adain import latent_adain, latent_adain_sd3
from univst_torch.core.config import StyleTransferConfig
from univst_torch.core.scheduler import DDIMSchedule, FlowMatchSchedule
from univst_torch.utils.profiling import NO_SPAN, SPANS


def _resize_mask(mask: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[F, H, W] {0,1} mask -> [F, h, w, 1] bilinear (half-pixel centers,
    antialiased when shrinking, as jax.image.resize does; the reference uses
    F.interpolate(..., mode='bilinear'), stable_diffusion.py:689-691)."""
    m = F.interpolate(mask.float()[:, None], size=(h, w), mode="bilinear",
                      align_corners=False, antialias=True)
    return m[:, 0, :, :, None]


def _le(a, b) -> bool:
    """``a <= b`` in float32, as the JAX loop compares step indices."""
    return bool(np.float32(a) <= np.float32(b))


def style_transfer_ddim_steps(
    denoise3: Callable,
    content_chunk,
    style_chunk,
    latents,
    steps,
    ts,
    schedule: DDIMSchedule,
    cfg: StyleTransferConfig,
    mask=None,
    style_kv=None,
    solo: bool = False,
    capture: bool = False,
    eps_hook: Optional[Callable] = None,
    shard=None,
):
    """Run a contiguous segment of the stylization loop (steps/ts of length K,
    trajectory chunks ``[K, F|1, h, w, C]``). ``eps_hook(eps, t, i,
    latents)``, where given, replaces the step's eps before the DDIM update
    (the pixel smoother). ``shard`` (a ``distributed.comm.FrameShard``):
    the latents, trajectories and mask hold this rank's frames, and the
    AdaIN re-anchor's statistics span the ranks.

    Denoiser layouts:
      * ``style_kv=None``: 3-branch — ``denoise3([3F], t, i)``;
      * ``style_kv`` given (tuple over PnP slots of (k, v), each with a
        leading step axis K): 2-branch — ``denoise3([2F], t, i, kv_t)`` with
        the style branch's PnP K/V of step j injected (``kv_t`` holds the
        step's slices, the leading axis dropped); ``style_chunk`` still feeds
        the latent AdaIN re-anchor;
      * ``solo=True``: stylized-only — ``denoise3([F], t, i)`` — for steps past
        the shift window, where the content/style forwards are dead compute;
      * ``capture=True``: 2-branch capture-and-inject —
        ``denoise3([2F], t, i, style_latents_t)`` runs the style branch's
        forward itself (capturing its PnP K/V) and injects that K/V into the
        [content | stylized] batch. The exact decomposition of the 3-branch
        batch (the branches couple only through the attention shift) for
        style frames that are not identical (AnimateDiff: the motion
        modules' frame positions).
    """
    n = cfg.num_steps
    f, h, w, _ = latents.shape
    m = None if mask is None else _resize_mask(mask, h, w).to(latents.dtype)
    for j, (i, t) in enumerate(zip(steps, ts)):
        i, t = int(i), int(t)
        with SPANS.span("step", i=i) if SPANS.on else NO_SPAN:
            cnt_t = content_chunk[j].to(latents.dtype)
            sty_t = style_chunk[j].to(latents.dtype)
            # localized latent blending, i <= 0.9 N (stable_diffusion.py:687-692)
            if m is not None and _le(i, cfg.blend_hi * n):
                latents = (1.0 - m) * latents + m * cnt_t
            # AdaIN re-anchor, 0.8 N < i <= 0.9 N (stable_diffusion.py:694-702)
            if not _le(i, cfg.adain_lo * n) and _le(i, cfg.adain_hi * n):
                anchored = latent_adain(latents, sty_t, shard)
                if m is not None:
                    anchored = (1.0 - m) * anchored + m * cnt_t
                latents = anchored.to(latents.dtype)

            if solo:
                eps = denoise3(latents, t, i)
            elif capture:
                eps = denoise3(torch.cat([cnt_t, latents]), t, i, sty_t)[f:]
            elif style_kv is None:
                eps = denoise3(torch.cat([cnt_t, sty_t, latents]), t, i)[2 * f:]
            else:
                kv_t = tuple((k[j], v[j]) for k, v in style_kv)
                eps = denoise3(torch.cat([cnt_t, latents]), t, i, kv_t)[f:]
            if eps_hook is not None:
                eps = eps_hook(eps, t, i, latents)
            latents = schedule.step(eps, t, latents, n)
    return latents


def style_transfer_rf_steps(
    denoise3: Callable,
    content_chunk,
    style_chunk,
    latents,
    steps,
    s_curr,
    s_next,
    etas,
    img_latents,
    schedule: FlowMatchSchedule,
    cfg: StyleTransferConfig,
    mask=None,
    singleton: bool = False,
    solo: bool = False,
):
    """A contiguous segment of the SD3 stylization loop with the
    controlled-velocity pull toward ``img_latents`` (custom_pipeline.py:
    279-334); steps/sigma pairs/etas of length K, trajectory chunks
    ``[K, F|1, h, w, C]``.

    Denoiser layouts:
      * default: 3-branch — ``denoise3([3F], t, i)``;
      * ``singleton``: 2-branch [content | stylized] —
        ``denoise3([2F], t, i, style_latent)`` with ``style_chunk``
        ``[K, 1, h, w, C]``; the denoiser runs the single-frame style forward
        (capture) and injects its K/V (exact: style frames are identical);
      * ``solo``: stylized-only — ``denoise3([F], t, i)`` — past the shift
        window, where the content/style forwards are dead compute.
    The AdaIN re-anchor uses the content latent under the mask (the
    reference line reads an undefined variable there, custom_pipeline.py:
    303; the SD semantics are the evident intent).
    """
    n = cfg.num_steps
    f, h, w, _ = latents.shape
    m = None if mask is None else _resize_mask(mask, h, w).to(latents.dtype)
    target = img_latents.float()
    scale = np.float32(schedule.cfg.num_train_timesteps)
    for j, (i, sc, sn, eta) in enumerate(zip(steps, s_curr, s_next, etas)):
        i, sc, sn = int(i), np.float32(sc), np.float32(sn)
        with SPANS.span("step", i=i) if SPANS.on else NO_SPAN:
            cnt_t = content_chunk[j].to(latents.dtype)
            sty_t = style_chunk[j].to(latents.dtype)
            if m is not None and _le(i, cfg.blend_hi * n):
                latents = (1.0 - m) * latents + m * cnt_t
            # SD3's re-anchor window is closed at both ends (custom_pipeline.py:295)
            if _le(cfg.adain_lo * n, i) and _le(i, cfg.adain_hi * n):
                anchored = latent_adain_sd3(latents, sty_t)
                if m is not None:
                    anchored = (1.0 - m) * anchored + m * cnt_t
                latents = anchored.to(latents.dtype)

            t = float(sc * scale)
            if solo:
                v = denoise3(latents, t, i)
            elif singleton:
                v = denoise3(torch.cat([cnt_t, latents]), t, i, sty_t)[f:]
            else:
                v = denoise3(torch.cat([cnt_t, sty_t, latents]), t, i)[2 * f:]
            x32 = latents.float()
            v = v.float()
            v = v + float(np.float32(eta)) * (-(target - x32) / float(sc) - v)
            latents = (x32 + float(sn - sc) * v).to(latents.dtype)
    return latents


def style_transfer_rf(denoise3: Callable, content_traj_rev, style_traj_rev, init_latents,
                      img_latents, schedule: FlowMatchSchedule, cfg: StyleTransferConfig,
                      eta_values, mask=None, mu: Optional[float] = None):
    """The whole SD3 stylization loop, 3-branch (see
    :func:`style_transfer_rf_steps`)."""
    n = cfg.num_steps
    sigmas = schedule.sigmas(n, mu=mu)
    return style_transfer_rf_steps(
        denoise3, content_traj_rev[:n], style_traj_rev[:n], init_latents, range(n),
        sigmas[:-1], sigmas[1:], np.asarray(eta_values, np.float32), img_latents, schedule,
        cfg, mask=mask)
