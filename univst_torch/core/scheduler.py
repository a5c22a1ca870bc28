"""DDIM schedule and EasyInv constants (PyTorch port of the DDIM half of
``univst_tpu/core/scheduler.py``).

The alpha-bar table is built in float64 on the host and kept as float32;
every update runs in float32 whatever the model's working type (the
reference upcasts the same way). Timesteps are Python ints: the loops that
call these functions run in Python.
"""

from __future__ import annotations

import dataclasses

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
    def _update(eps, sample, alpha_from, alpha_to):
        """x at alpha_from -> x at alpha_to through the predicted x0, in fp32."""
        x = sample.float()
        e = eps.float()
        a_f, a_t = np.float32(alpha_from), np.float32(alpha_to)
        pred_x0 = (x - float(np.sqrt(np.float32(1.0) - a_f)) * e) / float(np.sqrt(a_f))
        out = float(np.sqrt(a_t)) * pred_x0 + float(np.sqrt(np.float32(1.0) - a_t)) * e
        return out.to(sample.dtype)

    def step(self, eps, t: int, sample, num_inference_steps: int):
        """Deterministic DDIM sampling step x_t -> x_{t-Delta} (eta=0),
        diffusers DDIMScheduler.step with epsilon prediction."""
        step_ratio = self.cfg.num_train_timesteps // num_inference_steps
        return self._update(eps, sample, self._alpha_at(t), self._alpha_at(int(t) - step_ratio))

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

