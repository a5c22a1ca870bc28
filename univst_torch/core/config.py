"""Typed configuration for the UniVST method surface (PyTorch port of
``univst_tpu/core/config.py``).

The step window and beta schedule are host arithmetic on the Python step
index: PyTorch runs the denoise loops in Python, so nothing here is traced.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

# A cross-frame attention index: 'first' | 'last' | 'mid' or a relative int
# offset clipped to [0, F-1] (reference: video_diffusion_sd/models/attention.py:388-410).
FrameIndex = Union[str, int]


@dataclasses.dataclass(frozen=True)
class StyleShiftConfig:
    """AdaIN-guided attention shift constants for one backbone.

    The stylized branch gets, inside a step-index window:
      q <- gamma * (alpha * q_content + (1 - alpha) * q_stylized)
      k <- beta * adain(k_stylized, k_style) + (1 - beta) * k_style   (same for v)
    with beta linear from beta_max to beta_min.

    ``window_mode`` keeps the per-backbone comparison quirks of the reference:
      * 'sd'  : idx >= eta1 (UNSCALED) and idx <= eta2*N   (sd pnp_utils.py:47)
      * 'ad'  : idx >= eta1*N and idx <  eta2*N            (ad pnp_utils.py:45)
      * 'sd3' : idx >= eta1*N and idx <= eta2*N            (sd3 pnp_utils.py:183)

    ``num_steps`` stays at 50 whatever ``--time_steps`` is: every reference
    backbone hardcodes ``* 50`` in its window and beta formulas.
    """

    alpha: float
    gamma: float
    eta1: float = 0.0
    eta2: float = 0.5
    beta_max: float = 0.9
    beta_min: float = 0.1
    num_steps: int = 50
    window_mode: str = "sd"

    def _bounds(self):
        """(lo, hi, hi_inclusive) of the step window in float step units."""
        n = float(self.num_steps)
        if self.window_mode == "sd":
            return self.eta1, self.eta2 * n, True
        if self.window_mode == "ad":
            return self.eta1 * n, self.eta2 * n, False
        if self.window_mode == "sd3":
            return self.eta1 * n, self.eta2 * n, True
        raise ValueError(self.window_mode)

    def window_gate(self, step_idx: int) -> bool:
        """Does the shift apply at this denoising step index?"""
        i = float(step_idx)
        lo, hi, inclusive = self._bounds()
        return i >= lo and (i <= hi if inclusive else i < hi)

    def beta(self, step_idx: int) -> float:
        """KV-blend weight: linear beta_max -> beta_min over the window
        (reference formula, e.g. sd pnp_utils.py:50), in float32 like the
        JAX package."""
        import numpy as np

        i = np.float32(step_idx)
        n = float(self.num_steps)
        slope = np.float32((self.beta_max - self.beta_min) / (self.eta1 * n - self.eta2 * n))
        return float(slope * (i - np.float32(self.eta2 * n)) + np.float32(self.beta_min))

    def window_end(self) -> int:
        """First step index from which the shift can never fire again."""
        last = -1
        for i in range(self.num_steps):
            if self.window_gate(i):
                last = i
        return last + 1


# Per-backbone presets (constants lifted from the reference pnp modules).
SD_STYLE_SHIFT = StyleShiftConfig(alpha=0.65, gamma=3.0, eta2=0.5, window_mode="sd")
# AnimateDiff's window is steps 0-24 of the 50-step constants: window_end() is 25
AD_STYLE_SHIFT = StyleShiftConfig(alpha=0.8, gamma=2.0, eta2=0.5, window_mode="ad")
# SD3's window is steps 0-30 of the 50-step constants: window_end() is 31
SD3_STYLE_SHIFT = StyleShiftConfig(alpha=0.8, gamma=2.0, eta2=0.6, window_mode="sd3")

# Cross-frame (sparse-causal) KV index presets.
SD_BASE_FRAME_INDICES: Tuple[FrameIndex, ...] = (-1, 0, "first")  # sd attention.py:356
SD_PNP_FRAME_INDICES: Tuple[FrameIndex, ...] = (-1, "first")  # sd pnp_utils.py:25
SD3_FRAME_INDICES: Tuple[FrameIndex, ...] = ("first", -1, 0)  # sd3 pnp_utils.py:27


@dataclasses.dataclass(frozen=True)
class StyleTransferConfig:
    """Pipeline-level stylization constants (reference stable_diffusion.py:687-716)."""

    num_steps: int = 50
    # localized latent blending active for i <= blend_hi * N
    blend_hi: float = 0.9
    # AdaIN re-anchor window (adain_lo * N, adain_hi * N]; SD3 closes both ends
    adain_lo: float = 0.8
    adain_hi: float = 0.9
    # sliding-window pixel smoother (the reference ships it disabled,
    # stable_diffusion.py:715): None or 'pixel'; it runs at the steps
    # [lo, hi) with a +/-radius frame window
    smoother: Optional[str] = None
    smoother_steps: Tuple[int, int] = (20, 25)
    smoother_radius: int = 2
    # SD3 controlled-velocity pull (custom_pipeline.py:157-161, flow_inversion.py:61-64)
    eta_base: float = 0.85
    eta_trend: str = "constant"
    eta_start_step: int = 25
    eta_end_step: int = 39
