"""Parity of the port's method loops with the JAX package: DDIM inversion
(EasyInv blend + feature capture), DDIM sampling, the stylization loop (mask
blend, AdaIN re-anchor window, 3-branch / injected / solo layouts) and mask
propagation.

The loops are driven by a cheap closed-form denoiser written once per
framework, so the test pins the loop logic, not the UNet (which
test_torch_models.py covers). Mask propagation draws its anchor scores with
``jax.random``, which torch cannot reproduce: both sides get the same draw.

Tolerances: 1e-5 relative for the fp32 loops (elementwise updates over ten
steps); propagated soft masks 1e-5; label maps exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univst_tpu.core.config import StyleTransferConfig as JSTCfg
from univst_tpu.core.scheduler import DDIMSchedule as JDDIM
from univst_tpu.core.scheduler import EasyInvConfig as JEasy
from univst_tpu.methods import inversion as jinv
from univst_tpu.methods import mask_propagation as jmp
from univst_tpu.methods.style_transfer import style_transfer_ddim_steps as j_steps
from univst_torch.core.config import StyleTransferConfig
from univst_torch.core.scheduler import DDIMSchedule, EasyInvConfig
from univst_torch.methods import inversion as tinv
from univst_torch.methods import mask_propagation as tmp
from univst_torch.methods.style_transfer import style_transfer_ddim_steps

N = 10


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1.0)


def _eps_j(x, t):
    return jnp.tanh(0.7 * x + t / 1000.0) * 0.5


def _eps_t(x, t):
    return torch.tanh(0.7 * x + t / 1000.0) * 0.5


def _latents(f=3, seed=0):
    return np.random.default_rng(seed).standard_normal((f, 8, 8, 4)).astype(np.float32)


@pytest.mark.parametrize("easyinv", [False, True])
def test_ddim_invert_segment_with_capture_matches_jax(easyinv):
    x0 = _latents()
    js, ts = JDDIM(), DDIMSchedule()
    steps_t = js.timesteps(N)[::-1].copy()
    cap = int(steps_t[3])

    def jden(lat, t, i):
        return _eps_j(lat, t), lat[:, :4, :4] * 2.0

    def tden(lat, t, i):
        return _eps_t(lat, t), lat[:, :4, :4] * 2.0

    x0j = jnp.asarray(x0)
    feat0 = jnp.zeros((3, 4, 4, 4))
    (jl, jlast, jcap), jtraj = jinv.ddim_invert_segment(
        jden, (x0j, x0j, feat0), jnp.arange(N), jnp.asarray(steps_t), js, N,
        JEasy() if easyinv else None, capture_timestep=cap)
    x0t = torch.tensor(x0)
    (tl, tlast, tcap), ttraj = tinv.ddim_invert_segment(
        tden, (x0t, x0t, None), range(N), steps_t, ts, N,
        EasyInvConfig() if easyinv else None, capture_timestep=cap)
    _close(ttraj, jtraj)
    _close(tl, jl)
    _close(tlast, jlast)
    _close(tcap, jcap)
    assert np.abs(np.asarray(jcap)).max() > 0


def test_ddim_sample_segment_matches_jax():
    x = _latents(seed=1)
    js, ts = JDDIM(), DDIMSchedule()
    want = jinv.ddim_sample_segment(lambda lat, t, i: (_eps_j(lat, t), None), jnp.asarray(x),
                                    jnp.arange(N), jnp.asarray(js.timesteps(N)), js, N)
    got = tinv.ddim_sample_segment(lambda lat, t, i: (_eps_t(lat, t), None), torch.tensor(x),
                                   range(N), ts.timesteps(N), ts, N)
    _close(got, want)


@pytest.mark.parametrize("layout", ["three_branch", "injected", "solo", "capture"])
def test_style_transfer_steps_match_jax(layout):
    """Mask blend (i <= 0.9N) and AdaIN re-anchor ((0.8N, 0.9N]) over all N
    steps, for each denoiser layout (``capture``: the denoiser gets the
    step's per-frame style latents)."""
    f = 3
    rng = np.random.default_rng(5)
    sty_frames = 1 if layout in ("injected", "solo") else f
    cnt = rng.standard_normal((N, f, 8, 8, 4)).astype(np.float32)
    sty = rng.standard_normal((N, sty_frames, 8, 8, 4)).astype(np.float32) * 1.5 + 0.3
    lat0 = _latents(seed=6)
    mask = np.zeros((f, 16, 16), np.float32)
    mask[:, 3:11, 5:13] = 1.0
    kv = rng.standard_normal((N, 5, 8)).astype(np.float32)
    ts_np = JDDIM().timesteps(N)

    def jden(x, t, i, kv_t=None):
        e = _eps_j(x, t)
        if layout == "capture":
            return e + jnp.mean(kv_t, axis=0) * 0.1
        return e if kv_t is None else e + jnp.mean(kv_t[0][0])

    def tden(x, t, i, kv_t=None):
        e = _eps_t(x, t)
        if layout == "capture":
            return e + kv_t.mean(dim=0) * 0.1
        return e if kv_t is None else e + kv_t[0][0].mean()

    kw_j, kw_t = {}, {}
    if layout == "injected":
        kw_j["style_kv"] = ((jnp.asarray(kv), jnp.asarray(kv)),)
        kw_t["style_kv"] = ((torch.tensor(kv), torch.tensor(kv)),)
    if layout in ("solo", "capture"):
        kw_j[layout] = kw_t[layout] = True
    want = j_steps(jden, jnp.asarray(cnt), jnp.asarray(sty), jnp.asarray(lat0), jnp.arange(N),
                   jnp.asarray(ts_np), JDDIM(), JSTCfg(num_steps=N), mask=jnp.asarray(mask),
                   **kw_j)
    got = style_transfer_ddim_steps(tden, torch.tensor(cnt), torch.tensor(sty),
                                    torch.tensor(lat0), range(N), ts_np, DDIMSchedule(),
                                    StyleTransferConfig(num_steps=N), mask=torch.tensor(mask),
                                    **kw_t)
    _close(got, want)


def test_resize_mask_matches_jax():
    from univst_tpu.methods.style_transfer import _resize_mask as j_resize
    from univst_torch.methods.style_transfer import _resize_mask

    m = (np.random.default_rng(2).random((2, 64, 48)) > 0.6).astype(np.float32)
    for h, w in ((8, 6), (16, 12), (64, 48)):
        _close(_resize_mask(torch.tensor(m), h, w), j_resize(jnp.asarray(m), h, w), 1e-6)


def test_propagate_masks_matches_jax_with_the_same_scores():
    f, hw, c = 5, 8, 16
    t = hw * hw
    rng = np.random.default_rng(9)
    feats = rng.standard_normal((f, t, c)).astype(np.float32)
    seg = np.zeros((hw, hw), np.int64)
    seg[2:6, 1:5] = 1
    cfg_j, cfg_t = jmp.MaskPropConfig(n_last_frames=2), tmp.MaskPropConfig(n_last_frames=2)
    key = jax.random.PRNGKey(0)
    scores = np.stack([np.asarray(jax.random.uniform(k, (t,)))
                       for k in jax.random.split(key, f - 1)])
    want = jmp.propagate_masks(jnp.asarray(feats), jmp.to_one_hot(jnp.asarray(seg), 2), cfg_j,
                               key=key)
    got = tmp.propagate_masks(torch.tensor(feats), tmp.to_one_hot(torch.tensor(seg), 2), cfg_t,
                              scores=torch.tensor(scores))
    _close(got, want)
    np.testing.assert_array_equal(
        tmp.upsample_labels(got, (hw, hw), (32, 32)).numpy(),
        np.asarray(jmp.upsample_labels(want, (hw, hw), (32, 32))))
    np.testing.assert_array_equal(
        tmp.upsample_and_binarize(got, (hw, hw), (32, 32)).numpy(),
        np.asarray(jmp.upsample_and_binarize(want, (hw, hw), (32, 32))))
