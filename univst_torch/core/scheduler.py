"""DDIM and flow-matching schedules and the EasyInv constants (PyTorch port
of ``univst_tpu/core/scheduler.py``).

The alpha-bar table and the sigmas are built in float64 on the host and kept
as float32; every update runs in float32 whatever the model's working type
(the reference upcasts the same way). Timesteps and sigmas are host numbers:
the loops that call these functions run in Python.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class DDIMConfig:
    """The diffusers DDIMScheduler config SD-1.5 / SD-2.1 use."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"  # or "linear"
    steps_offset: int = 1
    set_alpha_to_one: bool = False
    prediction_type: str = "epsilon"
    timestep_spacing: str = "leading"


def _make_betas(cfg: DDIMConfig) -> np.ndarray:
    if cfg.beta_schedule == "scaled_linear":
        return (
            np.linspace(
                cfg.beta_start**0.5, cfg.beta_end**0.5, cfg.num_train_timesteps, dtype=np.float64
            )
            ** 2
        )
    if cfg.beta_schedule == "linear":
        return np.linspace(cfg.beta_start, cfg.beta_end, cfg.num_train_timesteps, dtype=np.float64)
    raise ValueError(f"unsupported beta_schedule: {cfg.beta_schedule}")


class DDIMSchedule:
    """Precomputed float32 alpha-bar table + the DDIM step functions."""

    def __init__(self, cfg: DDIMConfig = DDIMConfig()):
        self.cfg = cfg
        alphas_cumprod = np.cumprod(1.0 - _make_betas(cfg))
        self.alphas_cumprod = alphas_cumprod.astype(np.float32)
        self.final_alpha_cumprod = np.float32(
            1.0 if cfg.set_alpha_to_one else alphas_cumprod[0]
        )

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        """Descending integer timesteps, 'leading' spacing with steps_offset
        (50 steps -> [981, 961, ..., 21, 1] for the SD config)."""
        cfg = self.cfg
        if cfg.timestep_spacing != "leading":
            raise NotImplementedError(cfg.timestep_spacing)
        step_ratio = cfg.num_train_timesteps // num_inference_steps
        ts = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].astype(np.int64)
        return ts + cfg.steps_offset

    def _alpha_at(self, t: int) -> np.float32:
        """alpha_bar(t); a negative t gives final_alpha_cumprod."""
        t = int(t)
        if t < 0:
            return self.final_alpha_cumprod
        return self.alphas_cumprod[min(t, self.cfg.num_train_timesteps - 1)]

    @staticmethod
    def _x0(x, e, a):
        """The predicted x0 of fp32 ``x`` and ``e`` at alpha-bar ``a``."""
        return (x - float(np.sqrt(np.float32(1.0) - a)) * e) / float(np.sqrt(a))

    @classmethod
    def _update(cls, eps, sample, alpha_from, alpha_to):
        """x at alpha_from -> x at alpha_to through the predicted x0, in fp32."""
        x = sample.float()
        e = eps.float()
        a_f, a_t = np.float32(alpha_from), np.float32(alpha_to)
        pred_x0 = cls._x0(x, e, a_f)
        out = float(np.sqrt(a_t)) * pred_x0 + float(np.sqrt(np.float32(1.0) - a_t)) * e
        return out.to(sample.dtype)

    def step(self, eps, t: int, sample, num_inference_steps: int):
        """Deterministic DDIM sampling step x_t -> x_{t-Delta} (eta=0),
        diffusers DDIMScheduler.step with epsilon prediction."""
        step_ratio = self.cfg.num_train_timesteps // num_inference_steps
        return self._update(eps, sample, self._alpha_at(t), self._alpha_at(int(t) - step_ratio))

    def pred_original(self, eps, t: int, sample):
        """The x0 estimate from (x_t, eps), in fp32: the smoother's entry
        point (reference stable_diffusion.py:718)."""
        return self._x0(sample.float(), eps.float(), np.float32(self._alpha_at(t))).to(sample.dtype)

    def return_to_timestep(self, t: int, sample, sample_stabilized):
        """The eps that maps a stabilized x0 back onto x_t (reference
        stable_diffusion.py:782-791)."""
        a = np.float32(self._alpha_at(t))
        eps = ((sample.float() - float(np.sqrt(a)) * sample_stabilized.float())
               / float(np.sqrt(np.float32(1.0) - a)))
        return eps.to(sample.dtype)

    def next_step(self, eps, t: int, sample, num_inference_steps: int):
        """Inverse DDIM update x_{t-Delta} -> x_t used during inversion
        (reference inversion_tools/ddim_inversion.py:190-204)."""
        step_ratio = self.cfg.num_train_timesteps // num_inference_steps
        t_cur = min(int(t) - step_ratio, self.cfg.num_train_timesteps - 1)
        return self._update(eps, sample, self._alpha_at(t_cur), self._alpha_at(t))


@dataclasses.dataclass(frozen=True)
class EasyInvConfig:
    """EasyInv latent-blending constants (reference: ddim_inversion.py:129-133).

    During inversion steps i with inject_steps*N < i < (inject_steps+inject_len)*N
    (and i > 0), the current latent is blended with the previous one:
    ``latent = or_latent_idx * latent + (1 - or_latent_idx) * last_latent``.
    (The reference's fixed-point refinement runs 0 iterations, so it is not
    carried over.)
    """

    or_latent_idx: float = 0.5
    inject_steps: float = 0.05
    inject_len: float = 0.2

    def blend_gate(self, i: int, num_inference_steps: int) -> bool:
        """Does step i apply the EasyInv blend?"""
        lo = np.float32(self.inject_steps * num_inference_steps)
        hi = np.float32((self.inject_steps + self.inject_len) * num_inference_steps)
        fi = np.float32(i)
        return bool(lo < fi < hi and fi > 0)


# ---------------------------------------------------------------------------
# Flow matching (SD3 / SD3.5)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FlowMatchConfig:
    """diffusers FlowMatchEulerDiscreteScheduler config for SD3/SD3.5."""

    num_train_timesteps: int = 1000
    shift: float = 3.0
    use_dynamic_shifting: bool = False
    base_shift: float = 0.5
    max_shift: float = 1.15
    base_image_seq_len: int = 256
    max_image_seq_len: int = 4096


def calculate_shift(image_seq_len: int, base_seq_len: int = 256, max_seq_len: int = 4096,
                    base_shift: float = 0.5, max_shift: float = 1.15) -> float:
    """Dynamic mu for resolution-dependent sigma shifting
    (reference: custom_pipeline.py:374-385)."""
    m = (max_shift - base_shift) / (max_seq_len - base_seq_len)
    b = base_shift - m * base_seq_len
    return image_seq_len * m + b


class FlowMatchSchedule:
    """Sigma schedule + Euler / midpoint step functions for rectified flow."""

    def __init__(self, cfg: FlowMatchConfig = FlowMatchConfig()):
        self.cfg = cfg

    def sigmas(self, num_inference_steps: int, mu: Optional[float] = None) -> np.ndarray:
        """Descending float32 sigmas [s_0 ... s_{N-1}, 0], s_0 = sigma_max
        (FlowMatchEulerDiscreteScheduler.set_timesteps: linspace over train
        timesteps, normalize, dynamic or static shift, append 0)."""
        cfg = self.cfg
        ts = np.linspace(1, cfg.num_train_timesteps, num_inference_steps, dtype=np.float64)[::-1]
        s = ts / cfg.num_train_timesteps
        if cfg.use_dynamic_shifting:
            if mu is None:
                raise ValueError("dynamic shifting requires mu")
            s = np.exp(mu) / (np.exp(mu) + (1.0 / s - 1.0))
        else:
            s = cfg.shift * s / (1.0 + (cfg.shift - 1.0) * s)
        return np.concatenate([s, [0.0]]).astype(np.float32)

    def timesteps(self, num_inference_steps: int, mu: Optional[float] = None) -> np.ndarray:
        """Descending model-facing timesteps = sigma * num_train_timesteps."""
        return self.sigmas(num_inference_steps, mu)[:-1] * self.cfg.num_train_timesteps

    @staticmethod
    def euler_step(velocity, sigma, sigma_next, sample):
        """x_next = x + (sigma_next - sigma) * v, in fp32, both directions
        (denoising descends the sigmas; RF inversion climbs the flipped
        schedule, flow_inversion.py:144-177)."""
        x = sample.float()
        out = x + float(np.float32(sigma_next) - np.float32(sigma)) * velocity.float()
        return out.to(sample.dtype)

    @staticmethod
    def rf_solver_step(velocity, velocity_mid, sigma, sigma_next, sample):
        """Second-order midpoint update (reference: flow_inversion.py:239-253):
        x += dt * v + 0.5 * dt^2 * (v_mid - v) / (dt / 2)."""
        dt = np.float32(sigma_next) - np.float32(sigma)
        x, v, vm = sample.float(), velocity.float(), velocity_mid.float()
        first_order = (vm - v) / float(dt / np.float32(2.0))
        out = x + float(dt) * v + float(np.float32(0.5) * dt * dt) * first_order
        return out.to(sample.dtype)


def scale_eta_window(start_step: int, end_step: int, num_steps: int, base_steps: int = 50):
    """Scale the reference's 50-step eta window constants (25/39,
    flow_inversion.py:61-64) to other step counts, keeping a nonempty window."""
    if num_steps == base_steps:
        return start_step, end_step
    s = int(round(start_step * num_steps / base_steps))
    e = int(round(end_step * num_steps / base_steps))
    s = max(0, min(s, num_steps - 1))
    e = max(s + 1, min(e, num_steps))
    return s, e


def generate_eta_values(timesteps: Sequence[float], start_step: int, end_step: int, eta: float,
                        eta_trend: str = "constant") -> np.ndarray:
    """Controlled-velocity eta schedule (reference: custom_pipeline.py:18-44);
    timesteps decrease and eta is nonzero on [start, end)."""
    n = len(timesteps)
    if not 0 <= start_step < end_step <= n:
        raise ValueError(f"invalid eta window [{start_step}, {end_step}) for {n} steps")
    ts = np.asarray(timesteps, dtype=np.float64)
    etas = np.zeros(n, dtype=np.float32)
    if eta_trend == "constant":
        etas[start_step:end_step] = eta
    elif eta_trend in ("linear_increase", "linear_decrease"):
        total = ts[start_step] - ts[end_step - 1]
        for i in range(start_step, end_step):
            num = ts[start_step] - ts[i] if eta_trend == "linear_increase" else ts[i] - ts[end_step - 1]
            etas[i] = eta * num / total
    else:
        raise NotImplementedError(f"unsupported eta_trend: {eta_trend}")
    return etas
