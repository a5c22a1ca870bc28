"""Parity of the port's rectified-flow loops with the JAX package, driven by
a small analytic velocity field in place of the MMDiT (so the loops
themselves are what is compared): RF-Inversion (with and without the gamma
pull toward a given noise), RF-Solver with its one-capture-per-step rule,
the controlled-velocity sampler, and the whole SD3 stylization loop with
its mask blend and closed AdaIN window.

Tolerance: 1e-5 relative to the max (fp32, the same arithmetic up to the
order of a few reductions).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import rel_err
from univst_tpu.core import scheduler as jsch
from univst_tpu.core.config import StyleTransferConfig as JSTCfg
from univst_tpu.methods import inversion as jinv
from univst_tpu.methods import style_transfer as jst
from univst_torch.core import scheduler
from univst_torch.core.config import StyleTransferConfig
from univst_torch.methods import inversion as inv
from univst_torch.methods import style_transfer as st

N, SHAPE = 6, (2, 4, 4, 16)
W = np.random.default_rng(0).standard_normal((16, 16)).astype(np.float32) * 0.3


def _velocity(x, t, i, lib):
    """v = tanh(x W) * (1 + t/1000) - 0.1 x, and a 'feature' x * (i + 1)."""
    if lib is torch:
        v = torch.tanh(x.float() @ torch.tensor(W)) * (1.0 + t / 1000.0) - 0.1 * x.float()
        return v, x.float() * (i + 1)
    v = jnp.tanh(x @ jnp.asarray(W)) * (1.0 + t / 1000.0) - 0.1 * x
    return v, x * (i + 1)


def _latents(seed):
    return np.random.default_rng(seed).standard_normal(SHAPE).astype(np.float32)


@pytest.mark.parametrize("gamma", [0.0, 0.5])
def test_rf_invert_matches_jax(gamma):
    import jax

    x0 = _latents(1)
    key = jax.random.PRNGKey(2)
    want, wfeat = jinv.rf_invert(lambda x, t, i: _velocity(x, t, i, jnp), jnp.asarray(x0),
                                 jsch.FlowMatchSchedule(), N, gamma=gamma,
                                 noise_key=key if gamma else None, capture_step=2)
    noise = np.asarray(jax.random.normal(key, SHAPE, jnp.float32)) if gamma else None
    got, feat = inv.rf_invert(lambda x, t, i: _velocity(x, t, i, torch), torch.tensor(x0),
                              scheduler.FlowMatchSchedule(), N, gamma=gamma,
                              target_noise=None if noise is None else torch.tensor(noise),
                              capture_step=2)
    assert got.shape == (N + 1,) + SHAPE
    assert rel_err(got, want) < 1e-5 and rel_err(feat, wfeat) < 1e-5


def test_rf_invert_with_gamma_needs_the_noise():
    with pytest.raises(ValueError, match="target_noise"):
        inv.rf_invert(lambda x, t, i: _velocity(x, t, i, torch), torch.tensor(_latents(0)),
                      scheduler.FlowMatchSchedule(), N, gamma=0.5)


@pytest.mark.parametrize("capture_step", [0, 3, 99])  # 99: never reached -> zeros
def test_rf_solver_invert_matches_jax(capture_step):
    x0 = _latents(3)
    calls = []

    def tvel(x, t, i):
        calls.append(i)
        return _velocity(x, t, i, torch)

    want, wfeat = jinv.rf_solver_invert(lambda x, t, i: _velocity(x, t, i, jnp),
                                        jnp.asarray(x0), jsch.FlowMatchSchedule(), N,
                                        capture_step=capture_step)
    got, feat = inv.rf_solver_invert(tvel, torch.tensor(x0), scheduler.FlowMatchSchedule(), N,
                                     capture_step=capture_step)
    assert len(calls) == 2 * N  # two velocity calls per step
    assert rel_err(got, want) < 1e-5
    np.testing.assert_allclose(feat.numpy(), np.asarray(wfeat), atol=1e-5, rtol=1e-5)


def test_rf_sample_controlled_matches_jax():
    xt, img = _latents(4), _latents(5)
    sched = jsch.FlowMatchSchedule()
    s, e = jsch.scale_eta_window(25, 39, N)
    etas = jsch.generate_eta_values(sched.timesteps(N), s, e, 0.85)
    want = jinv.rf_sample_controlled(lambda x, t, i: _velocity(x, t, i, jnp), jnp.asarray(xt),
                                     jnp.asarray(img), sched, N, etas)
    got = inv.rf_sample_controlled(lambda x, t, i: _velocity(x, t, i, torch), torch.tensor(xt),
                                   torch.tensor(img), scheduler.FlowMatchSchedule(), N, etas)
    assert rel_err(got, want) < 1e-5


@pytest.mark.parametrize("masked", [False, True])
def test_style_transfer_rf_matches_jax(masked):
    """The whole 3-branch loop: at N = 10 the blend runs for i <= 9 and the
    closed AdaIN window fires at i = 8 and 9 (the reference's SD3 window is
    closed at both ends, custom_pipeline.py:295)."""
    n = 10
    rng = np.random.default_rng(6)
    f = SHAPE[0]
    content = rng.standard_normal((n + 1,) + SHAPE).astype(np.float32)
    style = rng.standard_normal((n + 1,) + SHAPE).astype(np.float32)
    init, img = _latents(7), _latents(8)
    mask = (rng.random((f, 32, 32)) > 0.5).astype(np.float32) if masked else None
    sched = jsch.FlowMatchSchedule()
    s, e = jsch.scale_eta_window(25, 39, n)
    etas = jsch.generate_eta_values(sched.timesteps(n), s, e, 0.85)

    def jden(x3, t, i):
        return _velocity(x3, t, i, jnp)[0]

    def tden(x3, t, i):
        assert x3.shape[0] == 3 * f
        return _velocity(x3, t, i, torch)[0]

    want = jst.style_transfer_rf(jden, jnp.asarray(content), jnp.asarray(style),
                                 jnp.asarray(init), jnp.asarray(img), sched,
                                 JSTCfg(num_steps=n), etas,
                                 mask=None if mask is None else jnp.asarray(mask))
    got = st.style_transfer_rf(tden, torch.tensor(content), torch.tensor(style),
                               torch.tensor(init), torch.tensor(img),
                               scheduler.FlowMatchSchedule(), StyleTransferConfig(num_steps=n),
                               etas, mask=None if mask is None else torch.tensor(mask))
    assert got.shape == SHAPE and rel_err(got, want) < 1e-5
