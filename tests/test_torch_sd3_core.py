"""Parity of the port's SD3 core math with the JAX package: the flow-match
schedule and steps, the eta schedule, the SD3 AdaINs and attention shifts in
both layouts, and the rank-4 trajectory files.

Tolerances: 1e-6 for the schedules and the Euler / midpoint steps (host
float32 arithmetic in the same order); 1e-5 for the AdaINs and the shifts
(fp32 reductions in another order); the trajectory files byte for byte.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univst_tpu.attention import ops as jops
from univst_tpu.core import adain as jadain
from univst_tpu.core import scheduler as jsch
from univst_tpu.core.config import SD3_STYLE_SHIFT as J_SHIFT
from univst_torch.attention import ops
from univst_torch.core import adain, scheduler
from univst_torch.core.config import SD3_FRAME_INDICES, SD3_STYLE_SHIFT


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("steps", [4, 32, 50])
@pytest.mark.parametrize("dynamic", [False, True])
def test_flow_match_sigmas_and_timesteps_match_jax(steps, dynamic):
    assert scheduler.calculate_shift(1024) == jsch.calculate_shift(1024)
    mu = scheduler.calculate_shift(4096) if dynamic else None
    got = scheduler.FlowMatchSchedule(scheduler.FlowMatchConfig(use_dynamic_shifting=dynamic))
    want = jsch.FlowMatchSchedule(jsch.FlowMatchConfig(use_dynamic_shifting=dynamic))
    np.testing.assert_allclose(got.sigmas(steps, mu), want.sigmas(steps, mu), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.timesteps(steps, mu), want.timesteps(steps, mu), rtol=1e-6)
    assert got.sigmas(steps, mu)[-1] == 0.0 and got.sigmas(steps, mu).dtype == np.float32


@pytest.mark.parametrize("trend", ["constant", "linear_increase", "linear_decrease"])
@pytest.mark.parametrize("steps", [8, 32, 50])
def test_eta_schedule_matches_jax(trend, steps):
    window = scheduler.scale_eta_window(25, 39, steps)
    assert window == jsch.scale_eta_window(25, 39, steps)
    ts = jsch.FlowMatchSchedule().timesteps(steps)
    np.testing.assert_allclose(scheduler.generate_eta_values(ts, *window, 0.85, trend),
                               jsch.generate_eta_values(ts, *window, 0.85, trend),
                               atol=1e-6, rtol=0)


def test_eta_schedule_rejects_an_empty_window():
    with pytest.raises(ValueError, match="invalid eta window"):
        scheduler.generate_eta_values(np.arange(4.0)[::-1], 3, 3, 0.85)


def test_euler_and_midpoint_steps_match_jax():
    rng = np.random.default_rng(0)
    x, v, vm = (_rand(rng, 2, 4, 4, 16) for _ in range(3))
    s, sn = np.float32(0.75), np.float32(0.5)
    fm, jfm = scheduler.FlowMatchSchedule, jsch.FlowMatchSchedule
    np.testing.assert_allclose(
        fm.euler_step(torch.tensor(v), s, sn, torch.tensor(x)).numpy(),
        np.asarray(jfm.euler_step(jnp.asarray(v), s, sn, jnp.asarray(x))), atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        fm.rf_solver_step(torch.tensor(v), torch.tensor(vm), s, sn, torch.tensor(x)).numpy(),
        np.asarray(jfm.rf_solver_step(jnp.asarray(v), jnp.asarray(vm), s, sn, jnp.asarray(x))),
        atol=1e-6, rtol=0)


@pytest.mark.parametrize("name,shape", [
    ("attention_adain_sd3", (4, 3, 10, 8)),     # [B, heads, N, C]
    ("attention_adain_sd3_tm", (4, 10, 3, 8)),  # [B, N, heads, C]
    ("latent_adain_sd3", (4, 6, 6, 16)),        # [F, H, W, C]
])
def test_sd3_adains_match_jax(name, shape):
    rng = np.random.default_rng(1)
    cnt, sty = _rand(rng, *shape), _rand(rng, *shape) * 2.0 + 0.5
    got = getattr(adain, name)(torch.tensor(cnt), torch.tensor(sty)).numpy()
    want = np.asarray(getattr(jadain, name)(jnp.asarray(cnt), jnp.asarray(sty)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_token_major_adain_is_the_head_major_one_transposed():
    rng = np.random.default_rng(2)
    cnt, sty = torch.tensor(_rand(rng, 3, 5, 10, 8)), torch.tensor(_rand(rng, 3, 5, 10, 8))
    hm = adain.attention_adain_sd3(cnt, sty)
    tm = adain.attention_adain_sd3_tm(cnt.transpose(1, 2), sty.transpose(1, 2))
    torch.testing.assert_close(tm.transpose(1, 2), hm, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("token_major", [False, True])
@pytest.mark.parametrize("step", [0, 20, 30, 31, 45])  # in / at the edges of / past the window
def test_apply_style_shift_sd3_matches_jax(token_major, step):
    rng = np.random.default_rng(step)
    f = 3
    shape = (3 * f, 12, 2, 8) if token_major else (3 * f, 2, 12, 8)
    q, k, v = (_rand(rng, *shape) for _ in range(3))
    want = jops.apply_style_shift_sd3(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), step,
                                      J_SHIFT, f, token_major=token_major)
    got = ops.apply_style_shift_sd3(torch.tensor(q), torch.tensor(k), torch.tensor(v), step,
                                    SD3_STYLE_SHIFT, f, token_major=token_major)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("token_major", [False, True])
@pytest.mark.parametrize("step", [5, 30, 40])
def test_apply_style_shift_sd3_injected_matches_jax(token_major, step):
    rng = np.random.default_rng(10 + step)
    f = 3
    shape = (2 * f, 12, 2, 8) if token_major else (2 * f, 2, 12, 8)
    q, k, v = (_rand(rng, *shape) for _ in range(3))
    sk, sv = (_rand(rng, 1, *shape[1:]) for _ in range(2))
    want = jops.apply_style_shift_sd3_injected(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(sk), jnp.asarray(sv),
        step, J_SHIFT, f, token_major=token_major)
    got = ops.apply_style_shift_sd3_injected(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), torch.tensor(sk), torch.tensor(sv),
        step, SD3_STYLE_SHIFT, f, token_major=token_major)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


def test_sd3_constants_match_jax():
    from univst_tpu.core import config as jconfig
    from univst_torch.core import config

    assert dataclasses.asdict(SD3_STYLE_SHIFT) == dataclasses.asdict(J_SHIFT)
    assert SD3_FRAME_INDICES == jconfig.SD3_FRAME_INDICES == ("first", -1, 0)
    # the 50-step window covers steps 0-30
    assert SD3_STYLE_SHIFT.window_end() == J_SHIFT.window_end() == 31
    want = jconfig.StyleTransferConfig()
    got = config.StyleTransferConfig()
    for name in ("eta_base", "eta_trend", "eta_start_step", "eta_end_step", "blend_hi",
                 "adain_lo", "adain_hi"):
        assert getattr(got, name) == getattr(want, name), name


def test_rank4_trajectory_files_equal_the_jax_package_byte_for_byte(tmp_path):
    """SD3 writes ``[F, C, H, W]`` fp16 files (frames as batch); both
    packages' files are identical and load back to ``[F, H, W, C]``."""
    from univst_tpu.core import trajectory as jtraj
    from univst_torch.core import trajectory

    traj = _rand(np.random.default_rng(3), 3, 4, 6, 5, 16)
    trajectory.save_trajectory(torch.tensor(traj), str(tmp_path / "torch"), reference_rank=4)
    jtraj.save_trajectory(traj, str(tmp_path / "jax"), reference_rank=4)
    for i in range(3):
        name = f"ddim_latents_{i}.pt"
        mine = (tmp_path / "torch" / name).read_bytes()
        assert mine == (tmp_path / "jax" / name).read_bytes(), name
        z = torch.load(tmp_path / "torch" / name, weights_only=True)
        assert tuple(z.shape) == (4, 16, 6, 5) and z.dtype == torch.float16
    back = trajectory.load_trajectory(str(tmp_path / "torch"), 2)
    want = np.asarray(jtraj.load_trajectory(str(tmp_path / "jax"), 2))
    np.testing.assert_array_equal(back.numpy(), want)
    np.testing.assert_allclose(back.numpy(), traj, atol=1e-2, rtol=1e-3)  # fp16 storage
    with pytest.raises(ValueError, match="reference_rank"):
        trajectory.save_trajectory(torch.tensor(traj), str(tmp_path / "x"), reference_rank=3)
