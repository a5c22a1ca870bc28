"""Image/latent comparison metrics — the port's own copy of
``univst_tpu/utils/metrics.py`` (pure numpy; the port imports nothing of the
JAX package).

PSNR / SSIM / latent MSE between stylization outputs, and the
reconstruction-fidelity gate (inversion -> reconstruction PSNR against the
input, the reference's own implicit oracle,
inversion_tools/ddim_inversion.py:38-42). SSIM follows Wang et al. 2004 with
the standard 11x11 sigma=1.5 gaussian window, applied per channel and
averaged (skimage.metrics.structural_similarity's defaults for uint8 RGB
inputs with channel_axis=-1, gaussian_weights=True,
use_sample_covariance=False).
"""

from __future__ import annotations

import numpy as np

__all__ = ["psnr", "ssim", "latent_mse", "compare_frame_stacks"]


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 255.0) -> float:
    """Peak signal-to-noise ratio in dB over the full array."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x**2) / (2.0 * sigma**2))
    return g / g.sum()


def _filter2_sep(img: np.ndarray, win: np.ndarray) -> np.ndarray:
    """Separable 'valid' 2-D correlation of [H, W] with the 1-D window."""
    # rows
    n = win.size
    out = np.zeros((img.shape[0], img.shape[1] - n + 1), np.float64)
    for i, w in enumerate(win):
        out += w * img[:, i : i + out.shape[1]]
    out2 = np.zeros((out.shape[0] - n + 1, out.shape[1]), np.float64)
    for i, w in enumerate(win):
        out2 += w * out[i : i + out2.shape[0]]
    return out2


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 255.0) -> float:
    """Mean SSIM between two [H, W] or [H, W, C] images."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    win = _gaussian_window()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    vals = []
    for ch in range(a.shape[-1]):
        x, y = a[..., ch], b[..., ch]
        mx = _filter2_sep(x, win)
        my = _filter2_sep(y, win)
        mxx = _filter2_sep(x * x, win)
        myy = _filter2_sep(y * y, win)
        mxy = _filter2_sep(x * y, win)
        vx = mxx - mx * mx
        vy = myy - my * my
        cxy = mxy - mx * my
        s = ((2 * mx * my + c1) * (2 * cxy + c2)) / (
            (mx * mx + my * my + c1) * (vx + vy + c2)
        )
        vals.append(s.mean())
    return float(np.mean(vals))


def latent_mse(a: np.ndarray, b: np.ndarray) -> float:
    """Mean squared error between two latent arrays of identical shape."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"latent shape mismatch: {a.shape} vs {b.shape}")
    return float(np.mean((a - b) ** 2))


def compare_frame_stacks(a: np.ndarray, b: np.ndarray,
                         data_range: float = 255.0) -> dict:
    """Per-frame PSNR/SSIM between two [F, H, W, C] uint8/float stacks.

    Returns {"psnr_mean", "psnr_min", "ssim_mean", "ssim_min",
    "psnr_per_frame", "ssim_per_frame"}.
    """
    if a.shape != b.shape:
        raise ValueError(f"frame stack shape mismatch: {a.shape} vs {b.shape}")
    ps = [psnr(x, y, data_range) for x, y in zip(a, b)]
    ss = [ssim(x, y, data_range) for x, y in zip(a, b)]
    return {
        "psnr_mean": float(np.mean(ps)),
        "psnr_min": float(np.min(ps)),
        "ssim_mean": float(np.mean(ss)),
        "ssim_min": float(np.min(ss)),
        "psnr_per_frame": [float(p) for p in ps],
        "ssim_per_frame": [float(s) for s in ss],
    }
