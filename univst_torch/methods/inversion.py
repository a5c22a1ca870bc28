"""DDIM inversion and reconstruction loops — port of the DDIM half of
``univst_tpu/methods/inversion.py``.

The reference's Python loop of UNet calls (inversion_tools/ddim_inversion.py:
71-213) stays a Python loop; the whole trajectory ``[T+1, F, H, W, C]`` is
one stacked tensor and persistence is one host write at the end
(core/trajectory.py keeps the reference's on-disk format).

The denoiser is a plain function ``denoise(latents, t, step_idx) ->
(eps, captured_feature)``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from univst_torch.core.scheduler import DDIMSchedule, EasyInvConfig


def _capture_init(feat: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """What the capture holds before its timestep comes: zeros in the
    feature's shape (the JAX package's ``_capture_init``)."""
    return None if feat is None else torch.zeros_like(feat)


def ddim_invert_segment(
    denoise: Callable,
    carry,
    steps,
    ts,
    schedule: DDIMSchedule,
    num_steps: int,
    easyinv: Optional[EasyInvConfig] = None,
    capture_timestep: Optional[int] = None,
):
    """Segment of the x0 -> xT inversion loop.

    ``carry = (latent, last_latent, captured | None)``; returns
    ``(carry, traj_chunk [K, ...])``. As ddim_loop / ddim_loop_plus
    (ddim_inversion.py:88-167): epsilon is computed at the unblended latent;
    with EasyInv the latent is then blended with the previous step's latent
    before the inverse update.
    """
    latent, last_latent, captured = carry
    traj = []
    for i, t in zip(steps, ts):
        i, t = int(i), int(t)
        eps, feat = denoise(latent, t, i)
        if easyinv is not None and easyinv.blend_gate(i, num_steps):
            w = easyinv.or_latent_idx
            latent = w * latent + (1.0 - w) * last_latent
        last_latent = latent
        latent = schedule.next_step(eps, t, latent, num_steps)
        if feat is not None and capture_timestep is not None:
            if captured is None:
                captured = _capture_init(feat)
            if t == capture_timestep:
                captured = feat
        traj.append(latent)
    return (latent, last_latent, captured), torch.stack(traj)


def ddim_sample_segment(denoise: Callable, latent, steps, ts, schedule: DDIMSchedule,
                        num_steps: int):
    """Segment of the xT -> x0 reconstruction (reference ``reconstruction``,
    stable_diffusion.py:588-614)."""
    for i, t in zip(steps, ts):
        eps, _ = denoise(latent, int(t), int(i))
        latent = schedule.step(eps, int(t), latent, num_steps)
    return latent
