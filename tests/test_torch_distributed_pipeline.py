"""The port's tiny pipelines and its workflow CLI frame-parallel (and SD3 on a
``data x tensor`` mesh) on gloo ranks on the CPU, against the JAX package
on the same numpy inputs and against the port on one process.

Its own file so that pytest-xdist's ``--dist loadfile`` runs it on another
worker than the module-level cases of ``test_torch_distributed.py``. Each
multi-process case spawns its ranks through ``_torch_dist.run_ranks`` (a
``file://`` store under ``tmp_path``, a process-group timeout and a bounded
join: a dead or hung rank fails the case, never the suite).

Tolerances: the pipelines against the port on one process at ``rtol=2e-4,
atol=2e-5`` (the bar of the JAX package's own sharded-against-single-device
test, tests/test_distributed.py:89-125), and against the JAX pipeline at
1e-3 of the max (the bar of the one-process pipeline parity files: two fp32
frameworks over the DDIM steps); the CLI trees to fp16 rounding.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
from _torch_parity import rel_err, seeded_init, to_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- the pipelines --------------------------------------------------------------------

F, PX, N = 8, 64, 6
H8 = PX // 8
SD_SHIFT = dict(alpha=0.65, gamma=3.0, eta2=0.5, num_steps=N, window_mode="sd")
AD_SHIFT = dict(alpha=0.8, gamma=2.0, eta2=0.5, num_steps=N, window_mode="ad")


def _states(jp, unet_emit):
    from univst_torch.models import convert as tcv

    return [tcv.to_torch_state_dict(emit(to_np(params), cfg)) for emit, params, cfg in (
        (unet_emit, jp.unet_params, jp.unet.cfg),
        (tcv.flax_vae_to_state_dict, jp.vae_params, jp.vae.cfg),
        (tcv.flax_clip_to_state_dict, jp.text_params, jp.text_encoder.cfg))]


def _jax_run(jp, inputs, shift):
    from univst_tpu.core.config import StyleShiftConfig as JShift
    from univst_tpu.core.config import StyleTransferConfig as JSTCfg

    jctx = jp.encode_text("")
    out = jp.stylize_latents(jnp.asarray(inputs["content"]), jnp.asarray(inputs["style"]),
                             jnp.asarray(inputs["init"]), jnp.concatenate([jctx] * 3),
                             mask=jnp.asarray(inputs["mask"]), cfg=JSTCfg(num_steps=N),
                             style_cfg=JShift(**shift))
    traj, feat = jp.invert(jnp.asarray(inputs["init"]), jctx, num_steps=N,
                           is_opt=inputs["is_opt"], capture_timestep=inputs["capture_timestep"])
    return np.asarray(out), np.asarray(traj), np.asarray(feat)


def _inputs(seed, style_frames, cap_t, is_opt=True):
    rng = np.random.default_rng(seed)
    style = rng.standard_normal((N + 1, 1, H8, H8, 4))
    if style_frames > 1:
        style = style + 0.3 * rng.standard_normal((N + 1, style_frames, H8, H8, 4))
    mask = np.zeros((F, PX, PX), np.float32)
    mask[:, 16:48, 8:40] = 1.0
    return dict(content=rng.standard_normal((N + 1, F, H8, H8, 4)).astype(np.float32),
                style=style.astype(np.float32), mask=mask,
                init=rng.standard_normal((F, H8, H8, 4)).astype(np.float32),
                capture_timestep=cap_t, is_opt=is_opt)


@pytest.fixture(scope="module")
def sd_case():
    from univst_tpu.pipelines.sd import SDVideoPipeline as JPipe
    from univst_torch.models import convert as tcv

    with seeded_init(0):
        jp = JPipe.build(variant="tiny", num_frames=F, height=PX, width=PX, dtype=jnp.float32,
                         capture_up_block=2, seed=0)
    inputs = _inputs(0, 1, int(jp.schedule.timesteps(N)[::-1][2]))
    states = _states(jp, tcv.flax_unet_to_state_dict)
    one = td.sd_pipeline(None, "sd", states, F, N, inputs, SD_SHIFT)
    return states, inputs, _jax_run(jp, inputs, SD_SHIFT), one


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_sd_pipeline_matches_jax(n, sd_case, tmp_path):
    """The tiny SD pipeline's stylization (style-singleton pre-pass, both
    phases, mask blend, AdaIN re-anchor) and its inversion (EasyInv, the
    up-block feature captured) over n ranks."""
    states, inputs, want, one = sd_case
    got = td.run_ranks(td.sd_pipeline, n, tmp_path, "sd", states, F, N, inputs, SD_SHIFT)[0]
    for g, o, w in zip(got, one, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), o.numpy(), rtol=2e-4, atol=2e-5)
        assert rel_err(g, w) < 1e-3


def test_sharded_ad_pipeline_matches_jax(tmp_path):
    """The tiny AnimateDiff stylization (capture-and-inject, non-identical
    style frames, both phases, the raw content noise as the init) over 2
    ranks, against JAX and the port on one process: the motion modules'
    frame attention runs between two all-to-alls. The inversion (no EasyInv,
    the feature captured) against the port on one process at 1e-4 of the
    max: the tiny AD config amplifies rounding about tenfold a DDIM step
    (2.4e-7 after one step, 1e-4 after six; its 4-value groups at the 1x1
    level normalize near-equal values). Against JAX the tiny AD inversion
    on these weights misses by ~1e-2 on one process already (the JAX
    package's one-pass group variance, ROADMAP queue 3), so it is not
    compared there."""
    from univst_tpu.core.config import StyleShiftConfig as JShift
    from univst_tpu.core.config import StyleTransferConfig as JSTCfg
    from univst_tpu.pipelines.animatediff import build_animatediff as j_build
    from univst_torch.models import convert as tcv
    from test_torch_unet_ad import _fill_proj_out

    with seeded_init(0):
        jp = j_build(variant="tiny", num_frames=F, height=PX, width=PX, dtype=jnp.float32,
                     capture_up_block=2, seed=0)
    jp = dataclasses.replace(jp, unet_params=_fill_proj_out(to_np(jp.unet_params)))
    inputs = _inputs(1, F, int(jp.schedule.timesteps(N)[::-1][2]), is_opt=False)
    inputs["init"] = inputs["content"][0]
    states = _states(jp, tcv.flax_ad_unet_to_state_dict)
    jctx = jp.encode_text("")
    want = np.asarray(jp.stylize_latents(
        jnp.asarray(inputs["content"]), jnp.asarray(inputs["style"]),
        jnp.asarray(inputs["init"]), jnp.concatenate([jctx] * 3),
        mask=jnp.asarray(inputs["mask"]), cfg=JSTCfg(num_steps=N), style_cfg=JShift(**AD_SHIFT)))
    one = td.sd_pipeline(None, "ad", states, F, N, inputs, AD_SHIFT, singleton=False)
    got = td.run_ranks(td.sd_pipeline, 2, tmp_path, "ad", states, F, N, inputs, AD_SHIFT,
                       False)[0]
    np.testing.assert_allclose(got[0].numpy(), one[0].numpy(), rtol=2e-4, atol=2e-5)
    assert rel_err(got[0], want) < 1e-3
    for g, o in zip(got[1:], one[1:]):
        assert g.shape == o.shape and rel_err(g, o) < 1e-4


# -- the CLI --------------------------------------------------------------------------


def _workflow_argv(root, *extra):
    ex = os.path.join(REPO, "examples")
    return ["--backbone", "sd", "--variant", "tiny", "--platform", "cpu", "--num_frames", "2",
            "--height", "32", "--width", "32", "--time_steps", "2", "--ft_timesteps", "501",
            "--weight_dtype", "fp32", "--content_path", os.path.join(ex, "contents",
                                                                    "demo-fly-tiny"),
            "--style_path", os.path.join(ex, "styles", "tiny-00033.png"),
            "--mask_path", os.path.join(ex, "masks", "demo-fly-tiny.png"),
            "--output_root", str(root), *extra]


def test_workflow_cli_on_a_mesh_writes_the_one_process_tree(tmp_path):
    """``run_workflow --mesh data=2`` on two gloo ranks: rank 0 writes the
    tree of the one-process run; the mask PNGs are equal, the fp16
    trajectories and features agree to fp16 rounding, the frames within
    one level."""
    from PIL import Image

    from univst_torch.cli import run_workflow

    one, two = tmp_path / "one", tmp_path / "two"
    run_workflow.main(run_workflow.build_parser().parse_args(_workflow_argv(one)))
    td.run_ranks(td.workflow, 2, tmp_path / "ranks", _workflow_argv(two, "--mesh", "data=2"))
    files = sorted(p.relative_to(one) for p in one.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(two) for p in two.rglob("*") if p.is_file())
    kinds = set()
    for rel in files:
        if rel.suffix == ".pt":
            a, b = (torch.load(d / rel, weights_only=True).float() for d in (one, two))
            assert rel_err(b, a) < 2e-3, rel
            kinds.add("pt")
        elif rel.suffix == ".png":
            a, b = (np.asarray(Image.open(d / rel)).astype(int) for d in (one, two))
            if "masks" in rel.parts:
                np.testing.assert_array_equal(a, b)
                kinds.add("mask")
            else:
                assert np.abs(a - b).max() <= 1, rel
                kinds.add("frame")
    assert kinds == {"pt", "mask", "frame"}


@pytest.mark.parametrize("extra, match", [
    (["--backbone", "sd3", "--mesh", "data=2,tensor=4"], "does not divide the MMDiT's 2 heads"),
    (["--mesh", "data=2,tensor=2"], "needs 4 ranks"),
])
def test_workflow_cli_mesh_refusals(extra, match, tmp_path):
    """What ``--mesh`` still refuses: an SD3 tensor axis that does not
    divide the MMDiT's heads (the tiny variant's 2), and a mesh larger than
    the ranks torchrun started (one process here; SD and AnimateDiff take
    a tensor axis, replicated over it)."""
    from univst_torch.cli import run_workflow

    with pytest.raises(SystemExit, match=match):
        run_workflow.main(run_workflow.build_parser().parse_args(
            _workflow_argv(tmp_path) + extra))


def _sd3_argv(root, *extra):
    """The tiny SD3 workflow: 4 frames, the feature of block 1 at step 1 (a
    step index on SD3)."""
    argv = _workflow_argv(root, "--ft_indices", "1", *extra)
    for flag, value in (("--backbone", "sd3"), ("--ft_timesteps", "1"), ("--num_frames", "4")):
        argv[argv.index(flag) + 1] = value
    return argv


@pytest.mark.parametrize("backbone, spec", [("sd3", "data=2,tensor=2"), ("sd", "data=2,tensor=2")])
def test_workflow_cli_on_a_data_tensor_mesh_writes_the_one_process_tree(backbone, spec,
                                                                         tmp_path):
    """``run_workflow --mesh data=2,tensor=2`` on four gloo ranks: SD3 with
    its MMDiT split over the tensor axis, SD replicated over it; rank 0
    writes the one-process tree (masks equal, fp16 trajectories and
    features to fp16 rounding, frames within one level)."""
    from PIL import Image

    from univst_torch.cli import run_workflow

    argv = _sd3_argv if backbone == "sd3" else _workflow_argv
    one, two = tmp_path / "one", tmp_path / "mesh"
    run_workflow.main(run_workflow.build_parser().parse_args(argv(one)))
    td.run_ranks(td.workflow, 4, tmp_path / "ranks", argv(two, "--mesh", spec), mesh_tensor=2)
    files = sorted(p.relative_to(one) for p in one.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(two) for p in two.rglob("*") if p.is_file())
    kinds = set()
    for rel in files:
        if rel.suffix == ".pt":
            a, b = (torch.load(d / rel, weights_only=True).float() for d in (one, two))
            assert rel_err(b, a) < 2e-3, rel
            kinds.add("pt")
        elif rel.suffix == ".png":
            a, b = (np.asarray(Image.open(d / rel)).astype(int) for d in (one, two))
            if "masks" in rel.parts:
                np.testing.assert_array_equal(a, b)
                kinds.add("mask")
            else:
                assert np.abs(a - b).max() <= 1, rel
                kinds.add("frame")
    assert kinds == {"pt", "mask", "frame"}
