"""Parity of the port's core math with the JAX package: DDIM schedule and
steps, EasyInv gate, AdaIN, the style-shift window, and the trajectory
files (byte for byte).

Tolerance: 1e-6 (relative for values of order one) — the same fp32
formulas, evaluated elementwise; AdaIN statistics reduce in a different
order, which stays within a few fp32 ulps.
"""

import filecmp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univst_tpu.core import adain as jadain
from univst_tpu.core import config as jconfig
from univst_tpu.core import scheduler as jsched
from univst_tpu.core import trajectory as jtraj
from univst_torch.core import adain, config, scheduler, trajectory


def _close(got, want, tol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("n", [6, 10, 50])
def test_ddim_schedule_and_steps_match_jax(n):
    js, ts = jsched.DDIMSchedule(), scheduler.DDIMSchedule()
    np.testing.assert_array_equal(ts.timesteps(n), js.timesteps(n))
    np.testing.assert_array_equal(ts.alphas_cumprod, np.asarray(js.alphas_cumprod))
    rng = np.random.default_rng(n)
    x = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    e = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    for t in ts.timesteps(n):
        _close(ts.step(torch.tensor(e), t, torch.tensor(x), n),
               js.step(jnp.asarray(e), t, jnp.asarray(x), n))
        _close(ts.next_step(torch.tensor(e), t, torch.tensor(x), n),
               js.next_step(jnp.asarray(e), t, jnp.asarray(x), n))
        _close(ts.pred_original(torch.tensor(e), t, torch.tensor(x)),
               js.pred_original(jnp.asarray(e), t, jnp.asarray(x)))
        _close(ts.return_to_timestep(t, torch.tensor(x), torch.tensor(e)),
               js.return_to_timestep(t, jnp.asarray(x), jnp.asarray(e)))


@pytest.mark.parametrize("n", [6, 10, 50])
def test_easyinv_gate_matches_jax(n):
    je, te = jsched.EasyInvConfig(), scheduler.EasyInvConfig()
    assert [te.blend_gate(i, n) for i in range(n)] == [bool(je.blend_gate(i, n))
                                                        for i in range(n)]


@pytest.mark.parametrize("kw", [{}, {"num_steps": 6}, {"eta1": 0.1, "eta2": 0.7},
                                {"window_mode": "ad"}, {"window_mode": "sd3"}])
def test_style_shift_window_matches_jax(kw):
    jc = jconfig.StyleShiftConfig(alpha=0.65, gamma=3.0, **kw)
    tc = config.StyleShiftConfig(alpha=0.65, gamma=3.0, **kw)
    assert tc.window_end() == jc.window_end()
    for i in range(tc.num_steps + 2):
        assert tc.window_gate(i) == bool(jc.window_gate(i))
        assert tc.beta(i) == pytest.approx(float(jc.beta(i)), rel=1e-7)
    assert config.SD_STYLE_SHIFT == config.StyleShiftConfig(
        **{f: getattr(jconfig.SD_STYLE_SHIFT, f) for f in ("alpha", "gamma", "eta1", "eta2",
           "beta_max", "beta_min", "num_steps", "window_mode")})
    assert config.SD_BASE_FRAME_INDICES == jconfig.SD_BASE_FRAME_INDICES
    assert config.SD_PNP_FRAME_INDICES == jconfig.SD_PNP_FRAME_INDICES


def test_attention_adain_matches_jax():
    rng = np.random.default_rng(0)
    c = rng.standard_normal((4, 64, 32)).astype(np.float32) * 3 + 1
    s = rng.standard_normal((1, 64, 32)).astype(np.float32) * 0.5 - 2
    _close(adain.attention_adain(torch.tensor(c), torch.tensor(s)),
           jadain.attention_adain(jnp.asarray(c), jnp.asarray(s)), 1e-5)


@pytest.mark.parametrize("style_frames", [1, 4])
def test_latent_adain_matches_jax(style_frames):
    rng = np.random.default_rng(style_frames)
    c = rng.standard_normal((4, 8, 8, 4)).astype(np.float32)
    s = rng.standard_normal((style_frames, 8, 8, 4)).astype(np.float32) * 2 + 0.5
    _close(adain.latent_adain(torch.tensor(c), torch.tensor(s)),
           jadain.latent_adain(jnp.asarray(c), jnp.asarray(s)), 1e-5)


def test_trajectory_files_are_byte_compatible(tmp_path):
    rng = np.random.default_rng(1)
    traj = rng.standard_normal((4, 3, 8, 8, 4)).astype(np.float32)
    traj[:, 1:] = traj[:, :1]  # frame-identical, like a style trajectory
    ja, tb = tmp_path / "jax", tmp_path / "torch"
    jtraj.save_trajectory(traj, str(ja))
    trajectory.save_trajectory(torch.tensor(traj), str(tb))
    for i in range(4):
        assert filecmp.cmp(ja / f"ddim_latents_{i}.pt", tb / f"ddim_latents_{i}.pt",
                           shallow=False)
    for rev in (False, True):
        np.testing.assert_array_equal(trajectory.load_trajectory(str(ja), 3, reverse=rev).numpy(),
                                      np.asarray(jtraj.load_trajectory(str(tb), 3, reverse=rev)))
    assert trajectory.style_frames_identical(str(tb), 3)
    traj[3, 2] += 1.0  # a sampled step (0, N//2, N)
    trajectory.save_trajectory(torch.tensor(traj), str(tb))
    assert not trajectory.style_frames_identical(str(tb), 3)
    assert not jtraj.style_frames_identical(str(tb), 3)


def test_style_transfer_config_matches_jax():
    """The pipeline constants, the smoother's included, default as in the
    JAX package."""
    import dataclasses

    want = dataclasses.asdict(jconfig.StyleTransferConfig())
    assert dataclasses.asdict(config.StyleTransferConfig()) == want
    assert want["smoother"] is None and want["smoother_steps"] == (20, 25)


def test_save_video_writes_png_frames_without_imageio(tmp_path, monkeypatch):
    """Where imageio is not installed, the video becomes its ``*_frames/``
    PNG directory (as where imageio has no ffmpeg backend)."""
    import sys

    from univst_torch.utils.io import save_video

    monkeypatch.setitem(sys.modules, "imageio", None)  # import raises ImportError
    frames = np.random.default_rng(0).uniform(0, 1, (3, 8, 8, 3)).astype(np.float32)
    save_video(frames, str(tmp_path / "out" / "video.mp4"))
    assert sorted(p.name for p in (tmp_path / "out" / "video_frames").iterdir()) == [
        "00000.png", "00001.png", "00002.png"]
