"""Frame-parallel inference of the port (``univst_torch.distributed`` and the
shard forms of the modules) on N gloo ranks on the CPU, against the JAX
package on the same numpy inputs and against the port on one process.

Each multi-process case spawns its ranks through ``_torch_dist.run_ranks``
(a ``file://`` store under ``tmp_path``, a process-group timeout and a
bounded join: a dead or hung rank fails the case, never the suite).

Tolerances: the sharded statistics at 1e-6 relative of one-process
``var_mean``; the shard forms of attention, AdaIN and the VAE decode at
1e-5 of the max against JAX (the one-process parity bar of these modules).
The pipelines and the workflow CLI on a mesh are in
``test_torch_distributed_pipeline.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
from _torch_parity import jax_vae, rel_err


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
