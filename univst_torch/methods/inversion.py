"""DDIM and rectified-flow inversion and reconstruction loops — port of
``univst_tpu/methods/inversion.py``.

The reference's Python loops of denoiser calls (inversion_tools/
ddim_inversion.py:71-213, flow_inversion.py:122-264) stay Python loops; the
whole trajectory ``[T+1, F, H, W, C]`` is one stacked tensor and persistence
is one host write at the end (core/trajectory.py keeps the reference's
on-disk format).

The denoiser is a plain function ``denoise(latents, t, step_idx) ->
(eps_or_velocity, captured_feature)``, so the same loops serve the epsilon
models (SD) and the velocity model (SD3). Sigmas are host float32 numbers;
latents and velocities stay fp32 between steps.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from univst_torch.core.scheduler import DDIMSchedule, EasyInvConfig, FlowMatchSchedule


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


# ---------------------------------------------------------------------------
# Rectified flow (SD3)
# ---------------------------------------------------------------------------


def _f32(x) -> float:
    """A host sigma as the float32 value the JAX loops compute with."""
    return float(np.float32(x))


def rf_invert_segment(denoise: Callable, carry, steps, t_curr, t_prev, train_scale: float,
                      gamma: float = 0.0, target_noise=None,
                      capture_step: Optional[int] = None):
    """Segment of RF-Inversion: forward Euler along the flipped sigma schedule
    (flow_inversion.py:122-188), the velocity pulled toward ``target_noise``
    with weight ``gamma`` (0.0 in all reference runs; the caller hands the
    noise in, so both packages can be given the same draw).

    ``carry = (latent, captured | None)``; returns ``(carry, traj_chunk)``.
    """
    latent, captured = carry
    traj = []
    for i, tc, tp in zip(steps, t_curr, t_prev):
        i, tc, tp = int(i), _f32(tc), _f32(tp)
        v, feat = denoise(latent, _f32(np.float32(tc) * np.float32(train_scale)), i)
        v = v.float()
        if gamma > 0.0:
            tnv = (target_noise.float() - latent.float()) / _f32(np.float32(1.0) - np.float32(tc))
            v = gamma * tnv + (1.0 - gamma) * v
        latent = (latent.float() + _f32(np.float32(tp) - np.float32(tc)) * v).to(latent.dtype)
        captured = _capture(captured, feat, i, capture_step)
        traj.append(latent)
    return (latent, captured), torch.stack(traj)


def _capture(captured, feat, i: int, capture_step: Optional[int]):
    """The feature of step ``capture_step``; zeros before it comes."""
    if feat is None or capture_step is None:
        return captured
    if i == capture_step:
        return feat
    return _capture_init(feat) if captured is None else captured


def _flipped(schedule: FlowMatchSchedule, num_steps: int, mu: Optional[float]):
    fwd = np.flip(schedule.sigmas(num_steps, mu=mu)).copy()  # ascending 0 -> sigma_max
    return fwd[:-1], fwd[1:]


def rf_invert(denoise: Callable, image_latents, schedule: FlowMatchSchedule, num_steps: int,
              gamma: float = 0.0, target_noise=None, capture_step: Optional[int] = None,
              mu: Optional[float] = None):
    """RF-Inversion x0 -> x1: (trajectory ``[N+1, ...]``, captured feature).
    ``gamma > 0`` needs ``target_noise`` (standard normal, the latents' shape)."""
    if gamma > 0.0 and target_noise is None:
        raise ValueError("gamma > 0 requires target_noise")
    t_curr, t_prev = _flipped(schedule, num_steps, mu)
    (_, captured), traj = rf_invert_segment(
        denoise, (image_latents, None), range(len(t_curr)), t_curr, t_prev,
        schedule.cfg.num_train_timesteps, gamma, target_noise, capture_step)
    return torch.cat([image_latents[None], traj]), captured


def rf_solver_segment(denoise: Callable, carry, steps, t_curr, t_prev, train_scale: float,
                      capture_step: Optional[int] = None):
    """Segment of RF-Solver inversion, the second-order midpoint method
    (flow_inversion.py:191-264). Two denoiser calls per step; the feature is
    captured on the first only, like the reference (its ft arguments are not
    passed to the midpoint call, flow_inversion.py:242-249)."""
    latent, captured = carry
    traj = []
    for i, tc, tp in zip(steps, t_curr, t_prev):
        i, tc, tp = int(i), np.float32(tc), np.float32(tp)
        v, feat = denoise(latent, _f32(tc * np.float32(train_scale)), i)
        dt = tp - tc
        img_mid = (latent.float() + _f32(dt / np.float32(2.0)) * v.float()).to(latent.dtype)
        v_mid, _ = denoise(img_mid, _f32((tc + dt / np.float32(2.0)) * np.float32(train_scale)), i)
        latent = FlowMatchSchedule.rf_solver_step(v, v_mid, tc, tp, latent)
        captured = _capture(captured, feat, i, capture_step)
        traj.append(latent)
    return (latent, captured), torch.stack(traj)


def rf_solver_invert(denoise: Callable, image_latents, schedule: FlowMatchSchedule,
                     num_steps: int, capture_step: Optional[int] = None,
                     mu: Optional[float] = None):
    """RF-Solver x0 -> x1: (trajectory ``[N+1, ...]``, captured feature)."""
    t_curr, t_prev = _flipped(schedule, num_steps, mu)
    (_, captured), traj = rf_solver_segment(
        denoise, (image_latents, None), range(len(t_curr)), t_curr, t_prev,
        schedule.cfg.num_train_timesteps, capture_step)
    return torch.cat([image_latents[None], traj]), captured


def rf_sample_segment(denoise: Callable, latent, steps, s_curr, s_next, etas: Sequence[float],
                      img_latents, train_scale: float):
    """Segment of the flow-matching reconstruction with controlled velocity
    (custom_pipeline.py:46-124): v <- v + eta_i * (v_target - v), with
    v_target = -(x_img - x_t) / t pulling toward the clean image latents."""
    target = img_latents.float()
    for i, sc, sn, eta in zip(steps, s_curr, s_next, etas):
        sc, sn = np.float32(sc), np.float32(sn)
        v, _ = denoise(latent, _f32(sc * np.float32(train_scale)), int(i))
        x32 = latent.float()
        v = v.float()
        v = v + _f32(eta) * (-(target - x32) / _f32(sc) - v)
        latent = (x32 + _f32(sn - sc) * v).to(latent.dtype)
    return latent


def rf_sample_controlled(denoise: Callable, inversed_latents, img_latents,
                         schedule: FlowMatchSchedule, num_steps: int, eta_values,
                         mu: Optional[float] = None):
    """x1 -> x0 with the controlled-velocity pull toward ``img_latents``."""
    sigmas = schedule.sigmas(num_steps, mu=mu)
    return rf_sample_segment(denoise, inversed_latents, range(num_steps), sigmas[:-1],
                             sigmas[1:], np.asarray(eta_values, np.float32), img_latents,
                             schedule.cfg.num_train_timesteps)
