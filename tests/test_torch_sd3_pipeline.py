"""The SD3 slice as a whole: the port's ``SD3VideoPipeline`` against the JAX
package's on the tiny SD3 config (4 frames, 64 px latents of 8x8x16) with
the same weights (the JAX pipeline's seed-0 params carried across with
strict loads) in fp32 on CPU.

Covered: prompt encoding (CLIP-L + CLIP-G penultimate states padded to the
T5 width, then T5), RF-Inversion and RF-Solver inversion with feature
capture, the controlled-velocity reconstruction, and stylization with a
shift window inside the test's steps, so that the style-singleton 2-branch
phase, the stylized-only phase and (with the singleton off) the 3-branch
fallback all run; mask blend and AdaIN re-anchor on. The VAE decode and the
workflow CLI's reference tree close the file.

Tolerances: relative 1e-3 of the max for latents and features (two fp32
frameworks, errors compounding over the flow steps), 1e-5 for the prompt
encoding (no loop), decoded frames within 1 level of 255.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import rel_err

F, PX, N = 4, 64, 4
H8 = PX // 8


@pytest.fixture(scope="module")
def pipes():
    from univst_tpu.pipelines.sd3 import SD3VideoPipeline as JPipe
    from univst_torch.models import convert as tcv
    from univst_torch.pipelines.sd3 import SD3VideoPipeline

    jp = JPipe.build(variant="tiny", num_frames=F, height=PX, width=PX, dtype=jnp.float32,
                     capture_block=1, seed=0)
    tp = SD3VideoPipeline.build(variant="tiny", num_frames=F, dtype=torch.float32,
                                capture_block=1, device="cpu")
    for module, emit, params, cfg in (
        (tp.mmdit, tcv.flax_mmdit_to_state_dict, jp.mmdit_params, jp.mmdit.cfg),
        (tp.vae, tcv.flax_vae_to_state_dict, jp.vae_params, jp.vae.cfg),
        (tp.clip_l, tcv.flax_clip_to_state_dict, jp.clip_l_params, jp.clip_l.cfg),
        (tp.clip_g, tcv.flax_clip_to_state_dict, jp.clip_g_params, jp.clip_g.cfg),
        (tp.t5, tcv.flax_t5_to_state_dict, jp.t5_params, jp.t5.cfg),
    ):
        module.load_state_dict(tcv.to_torch_state_dict(emit(params, cfg)), strict=True)
    jctx, jpooled = jp.encode_prompt("")
    return jp, tp, np.asarray(jctx), np.asarray(jpooled)


def test_encode_prompt_matches_jax(pipes):
    _, tp, jctx, jpooled = pipes
    ctx, pooled = tp.encode_prompt("")
    # 7 CLIP tokens (L | G on features, padded to the joint width 64) + 16 T5
    assert ctx.shape == jctx.shape == (1, 7 + 16, 64)
    assert rel_err(ctx, jctx) < 1e-5 and rel_err(pooled, jpooled) < 1e-5


@pytest.mark.parametrize("solver", [False, True], ids=["rf_inversion", "rf_solver"])
def test_invert_and_reconstruct_match_jax(pipes, solver):
    jp, tp, jctx, jpooled = pipes
    lat0 = np.random.default_rng(int(solver)).standard_normal((F, H8, H8, 16)).astype(np.float32)
    jtraj, jfeat = jp.invert(jnp.asarray(lat0), jnp.asarray(jctx), jnp.asarray(jpooled),
                             num_steps=N, is_rf_solver=solver, capture_step=1)
    ttraj, tfeat = tp.invert(torch.tensor(lat0), torch.tensor(jctx), torch.tensor(jpooled),
                             num_steps=N, is_rf_solver=solver, capture_step=1)
    assert ttraj.shape == jtraj.shape == (N + 1, F, H8, H8, 16)
    assert rel_err(ttraj, jtraj) < 1e-3
    # [F, h/2, w/2, hidden 32] after block 1
    assert tfeat.shape == jfeat.shape == (F, H8 // 2, H8 // 2, 32)
    assert np.abs(np.asarray(jfeat)).max() > 0 and rel_err(tfeat, jfeat) < 1e-3
    jrec = jp.reconstruct_latents(jtraj[-1], jnp.asarray(lat0), jnp.asarray(jctx),
                                  jnp.asarray(jpooled), num_steps=N)
    trec = tp.reconstruct_latents(torch.tensor(np.asarray(jtraj[-1])), torch.tensor(lat0),
                                  torch.tensor(jctx), torch.tensor(jpooled), num_steps=N)
    assert rel_err(trec, jrec) < 1e-3


def test_rf_inversion_with_gamma_takes_the_given_noise(pipes):
    jp, tp, jctx, jpooled = pipes
    lat0 = np.random.default_rng(5).standard_normal((F, H8, H8, 16)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jtraj, _ = jp.invert(jnp.asarray(lat0), jnp.asarray(jctx), jnp.asarray(jpooled),
                         num_steps=N, gamma=0.5, noise_key=key)
    noise = np.asarray(jax.random.normal(key, lat0.shape, jnp.float32))
    ttraj, _ = tp.invert(torch.tensor(lat0), torch.tensor(jctx), torch.tensor(jpooled),
                         num_steps=N, gamma=0.5, target_noise=torch.tensor(noise))
    assert rel_err(ttraj, jtraj) < 1e-3


@pytest.mark.parametrize("singleton", [True, False], ids=["singleton", "three_branch"])
def test_stylize_latents_matches_jax(pipes, singleton):
    """A window over the test's steps (gate for i <= 0.6 N -> window end 3 of
    4): steps 0-2 run the multi-branch phase, step 3 the stylized-only one.
    The mask blend and the closed AdaIN window [0.8 N, 0.9 N] both fire."""
    from univst_tpu.core.config import SD3_STYLE_SHIFT as J_SHIFT
    from univst_tpu.core.config import StyleTransferConfig as JSTCfg
    from univst_torch.core.config import SD3_STYLE_SHIFT, StyleTransferConfig

    jp, tp, jctx, jpooled = pipes
    rng = np.random.default_rng(7)
    content = rng.standard_normal((N + 1, F, H8, H8, 16)).astype(np.float32)
    style1 = rng.standard_normal((N + 1, 1, H8, H8, 16)).astype(np.float32)
    style = np.tile(style1, (1, F, 1, 1, 1))
    init = rng.standard_normal((F, H8, H8, 16)).astype(np.float32)
    img = rng.standard_normal((F, H8, H8, 16)).astype(np.float32)
    mask = (rng.random((F, PX, PX)) > 0.5).astype(np.float32)
    scfg = dataclasses.replace(SD3_STYLE_SHIFT, num_steps=N)
    assert scfg.window_end() == 3
    ctx3, pooled3 = np.concatenate([jctx] * 3), np.concatenate([jpooled] * 3)

    jpipe = jp if singleton else dataclasses.replace(jp, style_singleton=False)
    jsty = style1 if singleton else style
    want = jpipe.stylize_latents(
        jnp.asarray(content), jnp.asarray(jsty), jnp.asarray(init), jnp.asarray(img),
        jnp.asarray(ctx3), jnp.asarray(pooled3), mask=jnp.asarray(mask),
        cfg=JSTCfg(num_steps=N), style_cfg=dataclasses.replace(J_SHIFT, num_steps=N))
    tpipe = tp if singleton else dataclasses.replace(tp, style_singleton=False)
    got = tpipe.stylize_latents(
        torch.tensor(content), torch.tensor(jsty), torch.tensor(init), torch.tensor(img),
        torch.tensor(ctx3), torch.tensor(pooled3), mask=torch.tensor(mask),
        cfg=StyleTransferConfig(num_steps=N), style_cfg=scfg)
    assert got.shape == (F, H8, H8, 16)
    assert rel_err(got, want) < 1e-3


def test_encode_and_decode_match_jax(pipes):
    """The 16-channel SD3 VAE round trip with its shift and scale; torch
    cannot draw JAX's normals, so the port is handed JAX's draw. Decoding in
    frame chunks gives the same frames (the SD3 decoder mixes no frames)."""
    jp, tp, _, _ = pipes
    frames = np.random.default_rng(2).uniform(-1, 1, (F, PX, PX, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = jp.encode_frames(jnp.asarray(frames), key)
    noise = np.asarray(jax.random.normal(key, want.shape, jnp.float32))
    got = tp.encode_frames(frames, noise=torch.tensor(noise))
    # the tiny VAE downsamples 2x
    assert got.shape == want.shape == (F, PX // 2, PX // 2, 16)
    assert rel_err(got, want) < 1e-4
    jpx = np.asarray(jp.decode_latents(want))
    tpx = tp.decode_latents(torch.tensor(np.asarray(want)), chunk=2).numpy()
    assert tpx.shape == jpx.shape == (F, PX, PX, 3)
    assert np.abs(np.round(tpx * 255) - np.round(jpx * 255)).max() <= 1


def test_free_text_encoders_then_encode_prompt_raises():
    from univst_torch.pipelines.sd3 import SD3VideoPipeline

    pipe = SD3VideoPipeline.build(variant="tiny", num_frames=2, dtype=torch.float32,
                                  device="cpu")
    assert pipe.with_frames(1).mmdit is pipe.mmdit
    pipe.free_text_encoders()
    with pytest.raises(RuntimeError, match="freed"):
        pipe.encode_prompt("")


def test_sd3_workflow_cli_writes_the_reference_tree(tmp_path):
    """``run_workflow --backbone sd3 --variant tiny --platform cpu`` writes
    the JAX CLIs' tree: rank-4 fp16 ``[F, C, h, w]`` trajectories (content
    and tiled style), the ``[F, h/2, w/2, D]`` block feature, the input mask
    then {0, 255} masks, and the stylized PNGs."""
    import os

    from PIL import Image

    from univst_torch.cli import run_workflow

    ex = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
    out = tmp_path / "results"
    run_workflow.main(run_workflow.build_parser().parse_args([
        "--backbone", "sd3", "--platform", "cpu", "--variant", "tiny", "--num_frames", "4",
        "--height", "64", "--width", "64", "--time_steps", "2", "--ft_indices", "1",
        "--ft_timesteps", "1",
        "--content_path", os.path.join(ex, "contents", "demo-fly-tiny"),
        "--style_path", os.path.join(ex, "styles", "tiny-00033.png"),
        "--mask_path", os.path.join(ex, "masks", "demo-fly-tiny.png"),
        "--output_root", str(out)]))
    inv = out / "contents-inv" / "sd3" / "demo-fly-tiny"
    for i in range(3):
        z = torch.load(inv / "inversion" / f"ddim_latents_{i}.pt", weights_only=True)
        assert z.dtype == torch.float16 and tuple(z.shape) == (4, 16, 32, 32)
    feat = torch.load(inv / "features" / "inversion_feature_map_1_block_1_step.pt",
                      weights_only=True)
    assert tuple(feat.shape) == (4, 16, 16, 32) and feat.float().abs().max() > 0
    sty_z = torch.load(out / "styles-inv" / "sd3" / "tiny-00033" / "inversion"
                       / "ddim_latents_2.pt", weights_only=True)
    assert tuple(sty_z.shape) == (4, 16, 32, 32) and torch.equal(sty_z[0], sty_z[3])
    mask_in = np.asarray(Image.open(os.path.join(ex, "masks", "demo-fly-tiny.png")))
    for i in range(4):
        m = np.asarray(Image.open(out / "masks" / "sd3" / "demo-fly-tiny" / ("%05d.png" % i)))
        if i == 0:
            np.testing.assert_array_equal(m, mask_in)
        else:
            assert set(np.unique(m)) <= {0, 255}
        px = np.asarray(Image.open(out / "stylizations" / "sd3" / "demo-fly-tiny_tiny-00033"
                                   / ("%05d.png" % i)))
        assert px.dtype == np.uint8 and px.shape == (64, 64, 3)
