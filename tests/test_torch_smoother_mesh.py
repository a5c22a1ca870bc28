"""The pixel smoother frame-parallel (``--mesh data=N``) on N gloo ranks on the
CPU, against the port on one process and against the JAX package on the
same numpy inputs.

* ``sliding_window_smooth``'s shard form: 8 frames of 64 px over 2 and 4
  ranks, radius 1, 2 and 3 (radius 3 on 4 ranks of 2 frames reads two
  ranks away), with and without a mask, with LK and with a per-pair flow
  that both frameworks compute alike. One ``smooth_halo`` all-to-all a
  call, bringing exactly the +/-radius frames the rank's keys read; the
  flow function sees the rank's own keys' pairs, both directions.
* The tiny SD pipeline's ``stylize_latents(smoother='pixel')`` over 2 and
  4 ranks on the style-singleton, capture-and-inject and batched pre-pass
  paths, and the
  tiny AnimateDiff pipeline over 2 ranks: one ``smooth_halo`` all-to-all a
  smoothing step.
* ``run_workflow --mesh data=2 --smoother pixel``: rank 0 writes the
  one-process tree.

Tolerances: ``sliding_window_smooth`` against one process at atol 1e-6
(the same frames reach the same per-pair flows), against JAX at
``test_torch_flow.py``'s bars (1e-5 with the per-pair flow, 1e-4 with LK);
the pipelines against one process at ``rtol=2e-4, atol=2e-5`` (the JAX
package's sharded-against-single-device bar, tests/test_distributed.py:
89-125) and against JAX at 1e-3 of the max (``test_torch_smoother.py``'s).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
from _torch_parity import rel_err, seeded_init, to_np
from test_torch_flow import _mask, _pair_flow, _video
from univst_tpu.methods import flow as jf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX = os.path.join(REPO, "examples")

# -- sliding_window_smooth ----------------------------------------------------------

F, PX = 8, 64
CASES = [(r, fl, m) for r in (1, 2, 3) for fl in ("pair", "lk") for m in (False, True)]
JAX_ATOL = {"pair": 1e-5, "lk": 1e-4}


def _reads(rank: int, n: int, radius: int, nf: int = F):
    """The global frames outside rank ``rank``'s shard of ``nf`` frames
    that its keys read."""
    f = nf // n
    o = rank * f
    return [g for g in (*range(o - radius, o), *range(o + f, o + f + radius)) if 0 <= g < nf]


def _own_pairs(rank: int, n: int, radius: int, nf: int = F) -> int:
    f = nf // n
    return sum(1 for k in range(rank * f, (rank + 1) * f) for b in range(-radius, radius + 1)
               if b and 0 <= k + b < nf)


@pytest.fixture(scope="module")
def smooth_inputs():
    return _video(F, PX, PX, seed=3), _mask(F, PX, PX)


@pytest.fixture(scope="module")
def sharded_smooth(smooth_inputs, tmp_path_factory):
    """Every case on n ranks, one spawn per n: ``get(n)`` -> per case, each
    rank's (gathered result, census, flow batch sizes)."""
    frames, mask = smooth_inputs
    runs = {}

    def get(n):
        if n not in runs:
            res = td.run_ranks(td.window_smooth, n, tmp_path_factory.mktemp(f"smooth{n}"),
                               frames, mask, CASES)
            runs[n] = {case: [r[i] for r in res] for i, case in enumerate(CASES)}
        return runs[n]

    return get


@pytest.fixture(scope="module")
def jax_smooth(smooth_inputs):
    frames, mask = smooth_inputs
    lk = jax.jit(jf.lucas_kanade_flow)
    refs = {}

    def get(radius, flow_name, masked):
        key = (radius, flow_name, masked)
        if key not in refs:
            refs[key] = np.asarray(jf.sliding_window_smooth(
                jnp.asarray(frames), flow_fn=_pair_flow(jnp) if flow_name == "pair" else lk,
                radius=radius, mask=jnp.asarray(mask) if masked else None))
        return refs[key]

    return get


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("radius, flow_name, masked", CASES,
                         ids=[f"r{r}-{fl}-{'mask' if m else 'nomask'}" for r, fl, m in CASES])
def test_sharded_sliding_window_smooth_matches_one_process_and_jax(
        n, radius, flow_name, masked, smooth_inputs, sharded_smooth, jax_smooth):
    from univst_torch.methods import flow as tf

    frames, mask = smooth_inputs
    fn = td.pair_flow if flow_name == "pair" else tf.lucas_kanade_flow
    one = tf.sliding_window_smooth(torch.tensor(frames), fn, radius,
                                   torch.tensor(mask) if masked else None)
    per_rank = sharded_smooth(n)[(radius, flow_name, masked)]
    for got, _, _ in per_rank:
        assert got.shape == (F, PX, PX, 3)
        np.testing.assert_allclose(got.numpy(), one.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(per_rank[0][0].numpy(), jax_smooth(radius, flow_name, masked),
                               atol=JAX_ATOL[flow_name], rtol=0)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_smooth_census_is_one_halo_all_to_all_and_the_ranks_own_flows(
        n, sharded_smooth):
    """Per call and rank: one ``smooth_halo`` all-to-all that brings the
    frames in ``[o - R, o)`` and ``[o + f, o + f + R)`` (clipped to the
    clip) and nothing else, and one flow batch of 2 x the rank's own keys'
    pairs: no rank gathers the clip or runs another rank's flows."""
    frame_bytes = PX * PX * 3 * 4
    for (radius, _, _), per_rank in sharded_smooth(n).items():
        total_pairs = 0
        for rank, (_, recs, batches) in enumerate(per_rank):
            assert [(op, site) for op, _, site, _ in recs] == [("all_to_all", "smooth_halo")]
            assert recs[0][1] == len(_reads(rank, n, radius)) * frame_bytes
            assert batches == [2 * _own_pairs(rank, n, radius)]
            total_pairs += _own_pairs(rank, n, radius)
        assert total_pairs == sum(1 for k in range(F) for b in range(-radius, radius + 1)
                                  if b and 0 <= k + b < F)


# -- the pipelines ------------------------------------------------------------------

N = 4
SMOOTH = dict(num_steps=N, smoother="pixel", smoother_steps=(1, 3), smoother_radius=2)
SD_SHIFT = dict(alpha=0.65, gamma=3.0, eta2=0.5, num_steps=N, window_mode="sd")
AD_SHIFT = dict(alpha=0.8, gamma=2.0, eta2=0.5, num_steps=N, window_mode="ad")
SD_PATHS = [dict(style_singleton=True), dict(style_singleton=False),
            dict(style_singleton=False, style_prepass_chunk=2)]


def _states(jp, unet_emit):
    from univst_torch.models import convert as tcv

    return [tcv.to_torch_state_dict(emit(to_np(params), cfg)) for emit, params, cfg in (
        (unet_emit, jp.unet_params, jp.unet.cfg),
        (tcv.flax_vae_to_state_dict, jp.vae_params, jp.vae.cfg),
        (tcv.flax_clip_to_state_dict, jp.text_params, jp.text_encoder.cfg))]


def _pipe_inputs(seed: int, style_frames: int, nf: int = F, px: int = PX):
    """Trajectories, initial latents (``px / 2`` a side: the tiny VAE
    downsamples 2x) and a ``[nf, px, px]`` mask."""
    rng = np.random.default_rng(seed)
    h = px // 2
    style = rng.standard_normal((N + 1, 1, h, h, 4))
    if style_frames > 1:
        style = style + 0.3 * rng.standard_normal((N + 1, style_frames, h, h, 4))
    mask = np.zeros((nf, px, px), np.float32)
    mask[:, px // 4:3 * px // 4, px // 8:5 * px // 8] = 1.0
    return dict(content=rng.standard_normal((N + 1, nf, h, h, 4)).astype(np.float32),
                style=style.astype(np.float32), mask=mask,
                init=rng.standard_normal((nf, h, h, 4)).astype(np.float32))


def _jax_stylize(jp, inputs, shift):
    from univst_tpu.core.config import StyleShiftConfig as JShift
    from univst_tpu.core.config import StyleTransferConfig as JSTCfg

    jctx = jp.encode_text("")
    return np.asarray(jp.stylize_latents(
        jnp.asarray(inputs["content"]), jnp.asarray(inputs["style"]),
        jnp.asarray(inputs["init"]), jnp.concatenate([jctx] * 3),
        mask=jnp.asarray(inputs["mask"]), cfg=JSTCfg(**SMOOTH), style_cfg=JShift(**shift)))


def _check_census(recs, batches, rank: int, n: int, nf: int = F, px: int = PX):
    """One ``smooth_halo`` all-to-all per smoothing step with the fp32 RGB
    frames the rank's keys read (beside the decoder's ``vae_halo`` ones),
    and one flow batch of 2 x its own keys' pairs."""
    steps = len(range(*SMOOTH["smoother_steps"]))
    radius = SMOOTH["smoother_radius"]
    assert len(recs) == steps
    for step in recs:
        halo = [(op, b) for op, b, site, _ in step if site == "smooth_halo"]
        assert halo == [("all_to_all", len(_reads(rank, n, radius, nf)) * px * px * 3 * 4)]
        assert all(site in ("smooth_halo", "vae_halo") for _, _, site, _ in step)
    assert batches == [2 * _own_pairs(rank, n, radius, nf)] * steps


@pytest.fixture(scope="module")
def sd_smooth_case():
    from univst_tpu.pipelines.sd import SDVideoPipeline as JPipe
    from univst_torch.models import convert as tcv

    with seeded_init(0):
        jp = JPipe.build(variant="tiny", num_frames=F, height=PX, width=PX, dtype=jnp.float32,
                         capture_up_block=2, seed=0)
    inputs = _pipe_inputs(0, 1)
    states = _states(jp, tcv.flax_unet_to_state_dict)
    one = [td.smoothed_stylization(None, "sd", states, F, inputs, SD_SHIFT, SMOOTH, [path])[0]
           for path in SD_PATHS]
    return states, inputs, _jax_stylize(jp, inputs, SD_SHIFT), one


@pytest.fixture(scope="module")
def sd_smooth_runs(sd_smooth_case, tmp_path_factory):
    """Both SD paths on n ranks, one spawn per n."""
    states, inputs, _, _ = sd_smooth_case
    runs = {}

    def get(n):
        if n not in runs:
            runs[n] = td.run_ranks(td.smoothed_stylization, n,
                                   tmp_path_factory.mktemp(f"sd{n}"), "sd", states, F, inputs,
                                   SD_SHIFT, SMOOTH, SD_PATHS)
        return runs[n]

    return get


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("path", range(len(SD_PATHS)), ids=["singleton", "capture", "prepass"])
def test_sharded_sd_stylization_with_the_smoother_matches_one_process_and_jax(
        n, path, sd_smooth_case, sd_smooth_runs):
    _, _, want, one = sd_smooth_case
    per_rank = sd_smooth_runs(n)
    got = per_rank[0][path][0]
    assert got.shape == want.shape == (F, PX // 2, PX // 2, 4)
    np.testing.assert_allclose(got.numpy(), one[path][0].numpy(), rtol=2e-4, atol=2e-5)
    assert rel_err(got, want) < 1e-3
    for rank, runs in enumerate(per_rank):
        _check_census(runs[path][1], runs[path][2], rank, n)


AD_F, AD_PX = 4, 64


def test_sharded_ad_stylization_with_the_smoother_matches_jax(tmp_path):
    """The tiny AnimateDiff pipeline (capture-and-inject, the motion
    modules' ``proj_out`` filled, non-identical style frames, the raw
    content noise as the init) with the smoother over 2 ranks, at
    ``test_sharded_ad_pipeline_matches_jax``'s bars. 4 frames of 64 px: the
    JAX package's smoother unrolls a flow per pair and direction into its
    step's graph, and 4 frames compile ~40 s faster than 8; every key's
    window still reaches into the other rank."""
    from univst_tpu.pipelines.animatediff import build_animatediff as j_build
    from univst_torch.models import convert as tcv
    from test_torch_unet_ad import _fill_proj_out

    with seeded_init(0):
        jp = j_build(variant="tiny", num_frames=AD_F, height=AD_PX, width=AD_PX,
                     dtype=jnp.float32, capture_up_block=2, seed=0)
    jp = dataclasses.replace(jp, unet_params=_fill_proj_out(to_np(jp.unet_params)))
    inputs = _pipe_inputs(1, AD_F, AD_F, AD_PX)
    inputs["init"] = inputs["content"][0]
    states = _states(jp, tcv.flax_ad_unet_to_state_dict)
    want = _jax_stylize(jp, inputs, AD_SHIFT)
    path = [dict(style_singleton=False)]
    one = td.smoothed_stylization(None, "ad", states, AD_F, inputs, AD_SHIFT, SMOOTH, path)[0]
    per_rank = td.run_ranks(td.smoothed_stylization, 2, tmp_path, "ad", states, AD_F, inputs,
                            AD_SHIFT, SMOOTH, path)
    got = per_rank[0][0][0]
    np.testing.assert_allclose(got.numpy(), one[0].numpy(), rtol=2e-4, atol=2e-5)
    assert rel_err(got, want) < 1e-3
    for rank, runs in enumerate(per_rank):
        _check_census(runs[0][1], runs[0][2], rank, 2, AD_F, AD_PX)


# -- the CLI --------------------------------------------------------------------------


def test_workflow_cli_with_the_smoother_on_a_mesh_writes_the_one_process_tree(tmp_path):
    """``run_workflow --mesh data=2 --smoother pixel`` on two gloo ranks (2
    frames of 32 px, 21 steps: smoothing step 20 runs, each rank's key
    reading the other rank's frame): rank 0 writes the tree of the
    one-process run; masks equal, fp16 trajectories and features to fp16
    rounding, frames within one level."""
    from PIL import Image

    from univst_torch.cli import run_workflow

    (tmp_path / "m").mkdir()
    mask = tmp_path / "m" / "demo-fly-tiny.png"
    Image.open(os.path.join(EX, "masks", "demo-fly-tiny.png")).resize(
        (32, 32), Image.NEAREST).save(mask)

    def argv(root, *extra):
        return ["--backbone", "sd", "--variant", "tiny", "--platform", "cpu", "--num_frames",
                "2", "--height", "32", "--width", "32", "--time_steps", "21",
                "--ft_timesteps", "1", "--weight_dtype", "fp32",
                "--content_path", os.path.join(EX, "contents", "demo-fly-tiny"),
                "--style_path", os.path.join(EX, "styles", "tiny-00033.png"),
                "--mask_path", str(mask), "--smoother", "pixel", "--output_root", str(root),
                *extra]

    one, two = tmp_path / "one", tmp_path / "two"
    run_workflow.main(run_workflow.build_parser().parse_args(argv(one)))
    td.run_ranks(td.workflow, 2, tmp_path / "ranks", argv(two, "--mesh", "data=2"))
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
