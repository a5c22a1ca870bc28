"""Frame-parallel inference of the port (``univst_torch.distributed`` and the
shard forms of the modules) on N gloo ranks on the CPU, against the JAX
package on the same numpy inputs and against the port on one process.

Each multi-process case spawns its ranks through ``_torch_dist.run_ranks``
(a ``file://`` store under ``tmp_path``, a process-group timeout and a
bounded join: a dead or hung rank fails the case, never the suite).

Tolerances: the sharded statistics at 1e-6 relative of one-process
``var_mean``; the shard forms of attention, AdaIN and the VAE decode at
1e-5 of the max against JAX (the one-process parity bar of these modules);
the pipelines against the port on one process at ``rtol=2e-4, atol=2e-5``
(the bar of the JAX package's own sharded-against-single-device test,
tests/test_distributed.py:89-125), and against the JAX pipeline at 1e-3 of
the max (the bar of the one-process pipeline parity files: two fp32
frameworks over the DDIM steps).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
from _torch_parity import jax_vae, rel_err, seeded_init, to_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- the mesh ---------------------------------------------------------------------


@pytest.mark.parametrize("spec", [None, "", "4", "data=4", "data=2,tensor=1", "data=8",
                                  "data=2,tensor=2", "data=4,tensor=2"])
def test_parse_mesh_axes_follows_the_jax_grammar(spec):
    from univst_tpu.distributed.mesh import parse_mesh_spec as j_parse
    from univst_torch.distributed.mesh import parse_mesh_axes

    want, got = j_parse(spec), parse_mesh_axes(spec)
    if want is None:
        assert got is None
    else:
        assert (got.n_data, got.n_tensor) == (want.shape["data"], want.shape["tensor"])


@pytest.mark.parametrize("spec", ["pipe=2", "data=2,bogus=1"])
def test_unknown_mesh_axis_raises_in_both_packages(spec):
    from univst_tpu.distributed.mesh import parse_mesh_spec as j_parse
    from univst_torch.distributed.mesh import parse_mesh_axes

    with pytest.raises(ValueError, match="unknown mesh axis"):
        j_parse(spec)
    with pytest.raises(ValueError, match="unknown mesh axis"):
        parse_mesh_axes(spec)


def test_mesh_spec_refusals(monkeypatch):
    """``data`` x ``tensor`` and ``hosts`` must match the ranks torchrun
    started; the tensor axis must stay within a host; a host with more
    ranks than cards is refused."""
    from univst_torch.distributed import mesh

    assert mesh.parse_mesh_axes("data=2,tensor=2") == (2, 2, None)
    for k, v in dict(WORLD_SIZE="4", LOCAL_WORLD_SIZE="2", RANK="0", LOCAL_RANK="0",
                     MASTER_ADDR="localhost", MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        mesh.parse_mesh_spec("data=2")
    with pytest.raises(ValueError, match="needs 8 ranks"):
        mesh.parse_mesh_spec("data=4,tensor=2")
    with pytest.raises(ValueError, match="hosts=3"):
        mesh.parse_mesh_spec("data=4,hosts=3")
    with pytest.raises(ValueError, match="tensor=4 must divide the 2 ranks of one host"):
        mesh.parse_mesh_spec("data=1,tensor=4")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="one rank per card"):
        mesh.init_from_env()


def test_shard_gather_replicate(tmp_path):
    x = td.noise(0, 3, 8, 5)
    res = td.run_ranks(td.mesh_basics, 2, tmp_path, x)
    for r, (local, whole, single, w, y) in enumerate(res):
        np.testing.assert_array_equal(local.numpy(), x[:, 4 * r:4 * r + 4])
        np.testing.assert_array_equal(whole.numpy(), x)
        np.testing.assert_array_equal(single.numpy(), x[:, :1])
        assert (w == 0).all() and (y == 0).all()  # rank 0's


def test_pipeline_gathers_on_request(tmp_path):
    """``with_mesh(gather=False)``: a stage returns the rank's shard, the next
    stage takes it; gathered, the shards are the one-process results."""
    frames = np.random.default_rng(3).uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    pipe = td._tiny_pipe(None, "sd", None, 4)
    z_one = pipe.encode_frames(frames, torch.Generator().manual_seed(0))
    px_one = pipe.decode_latents(z_one)
    for r, (z, px, z_all, px_all) in enumerate(td.run_ranks(td.gather_on_request, 2, tmp_path,
                                                            frames)):
        assert z.shape[0] == px.shape[0] == 2
        assert rel_err(z_all, z_one) < 1e-6 and rel_err(px_all, px_one) < 1e-5


def test_inflated_sd_unet_shard_form_matches_one_process(tmp_path):
    """The inflated SD UNet (``temporal_identity=False``): its temporal convs
    read the neighbour ranks' frames (``halo_1d``), its temporal attention
    runs between two all-to-alls, its GroupNorms and sparse-causal
    attention as on the SD path."""
    x = td.noise(8, 8, 8, 8, 4)
    unet, ctx = td.inflated_unet_model()
    from univst_torch.models.layers import VideoCtx

    with torch.inference_mode():
        want, _ = unet(torch.tensor(x), 501, ctx, VideoCtx(num_frames=8))
    got, recs = td.run_ranks(td.inflated_unet, 2, tmp_path, x, 501)[0]
    assert rel_err(got, want) < 1e-5
    sites = {site for _, _, site, _ in recs}
    assert {"halo_1d", "ulysses", "kv_halo", "group_norm"} <= sites


# -- the collectives and the modules' shard forms ------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_group_norm_matches_one_process(n, tmp_path):
    """The frame-spanning GroupNorm over sharded frames: its statistics
    (Chan's combination) and its output against one process. The input's
    mean is 1000 and its spread 1: the one-pass E[x^2] - E[x]^2 in fp32
    cancels there (shown), a two-pass ``var_mean`` does not."""
    from univst_torch.distributed import comm
    from univst_torch.models.layers import GroupNorm

    b, f, c, hw, g = 2, 8, 8, 4, 4
    x = (1000.0 + td.noise(1, b * f, c, hw, hw)).astype(np.float32)
    xt = torch.tensor(x)
    xg = xt.reshape(b, f, g, c // g, -1)
    var, mean = torch.var_mean(xg, dim=(1, 3, 4), unbiased=False, keepdim=True)
    one_pass = (xg.square().mean(dim=(1, 3, 4), keepdim=True) - mean.square())
    assert (one_pass - var).abs().max() / var.abs().max() > 1e-3

    # the statistics, rank by rank, without a process group: the combination
    class _Mesh:
        n_data, data_rank = n, 0

    parts = []

    def gather(stats, mesh, dim, site):  # every rank's stats, computed here
        return torch.cat(parts)

    orig = comm.all_gather_cat
    try:
        comm.all_gather_cat = lambda stats, mesh, dim, site: parts.append(stats) or stats
        for p in xg.chunk(n, dim=1):
            comm.sharded_var_mean(p, (1, 3, 4), comm.FrameShard(_Mesh(), f, 0))
        comm.all_gather_cat = gather
        svar, smean = comm.sharded_var_mean(xg.chunk(n, dim=1)[0], (1, 3, 4),
                                            comm.FrameShard(_Mesh(), f, 0))
    finally:
        comm.all_gather_cat = orig
    assert rel_err(smean, mean) < 1e-6 and rel_err(svar, var) < 1e-6

    got = td.run_ranks(td.group_norm, n, tmp_path, x, g, f)[0]
    want = GroupNorm(c, g, across_frames=True)(xt, f)
    assert torch.allclose(got, want, rtol=0, atol=1e-4)  # |x - mean| ~ 1e3 ulps of 6e-5


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_video_mha_matches_jax(n, tmp_path):
    """``video_mha``'s shard form at F = 8 (two branches), both SD index
    sets, on the kernel's plain version (L = 1024) and on the expanded-KV
    path (L = 64), against ``univst_tpu.attention.ops.video_mha``; each
    case one all-to-all that brings exactly the halo frames' K/V."""
    from univst_tpu.attention import ops as jops
    from univst_torch.attention.ops import shard_halo_needs

    f, b, heads, dh = 8, 2, 2, 8
    cases = [tuple(td.noise(s + l, b * f, l, heads * dh) for s in (2, 3, 4)) + (indices,)
             for l in (1024, 64) for indices in ((-1, 0, "first"), (-1, "first"))]
    res = td.run_ranks(td.video_mha, n, tmp_path, cases, heads, f)
    for c, (q, k, v, indices) in enumerate(cases):
        want = np.asarray(jops.video_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         heads, f, indices))
        assert rel_err(res[0][c][0], want) < 1e-5
        needs = shard_halo_needs(indices, f, n)
        for r in range(n):
            recs = res[r][c][1]
            assert [op for op, *_ in recs] == ["all_to_all"]
            assert recs[0][1] == len(needs[r]) * 2 * b * q.shape[1] * heads * dh * 4


def test_shard_kv_tables_keep_the_global_elision():
    """Rank tables: the halo is frame 0 and the frame before the shard;
    frame 0's slots (-1, 0, 'first' all name it) keep one slot of weight 3."""
    from univst_torch.attention.ops import shard_kv_tables
    from univst_torch.attention.video_flash import slot_tables

    idx = (-1, 0, "first")
    halo, srcs, mult = shard_kv_tables(idx, 16, 8, 8)
    assert halo == (0, 7)
    assert srcs[0].tolist() == [9, 0, 8] and mult[0].tolist() == [1, 1, 1]
    halo, srcs, mult = shard_kv_tables(idx, 16, 0, 8)
    gs, gm = slot_tables(idx, 16)
    assert halo == () and (srcs == gs[:8]).all() and (mult == gm[:8]).all()
    assert mult[0].tolist() == [3, 0, 0]


def test_sharded_latent_adain_matches_jax(tmp_path):
    from univst_tpu.core.adain import latent_adain as j_adain

    cnt, sty = td.noise(5, 8, 4, 4, 4) + 2.0, td.noise(6, 8, 4, 4, 4)
    want = np.asarray(j_adain(jnp.asarray(cnt), jnp.asarray(sty)))
    got = td.run_ranks(td.latent_adain, 2, tmp_path, cnt, sty)[0]
    assert rel_err(got, want) < 1e-5


def test_sharded_temporal_vae_decode_matches_jax(tmp_path):
    """The SVD-style decoder's (3,1,1) convs read the neighbour ranks'
    frames (``comm.halo_1d``), zero at the clip's ends."""
    from univst_torch.models import convert as tcv

    f = 8
    vae, params, cfg = jax_vae(f)
    z = td.noise(7, f, 8, 8, 4)
    want = np.asarray(vae.apply({"params": params}, jnp.asarray(z), f,
                                method=type(vae).decode))
    state = tcv.to_torch_state_dict(tcv.flax_vae_to_state_dict(params, cfg))
    got = td.run_ranks(td.vae_decode, 2, tmp_path, state, z, f)[0]
    assert got.shape == want.shape and rel_err(got, want) < 1e-5


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
