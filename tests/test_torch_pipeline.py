"""The slice as a whole: the port's SD pipeline against the JAX package's,
on the tiny SD config (4 frames, 64 px) with the same weights (the JAX
pipeline's params, drawn by ``seeded_init(0)``, carried across with strict
loads) in fp32 on CPU.

Covered: text encoding, content inversion with EasyInv and feature capture,
stylization on the style-singleton path with both phases present (a 6-step
window config puts steps 0-3 in the injected 2-branch phase and 4-5 in the
stylized-only phase; mask blend and AdaIN re-anchor on), and the chunked
temporal-VAE decode to uint8.

Tolerances: latents and features at relative 1e-3 of their max (two fp32
frameworks, ~60 layers per UNet call, errors compounding over the DDIM
steps); decoded frames within 1 level of 255 (rounding of a value that sits
on a .5 boundary can flip).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import rel_err, seeded_init

F, PX, N = 4, 64, 6


@pytest.fixture(scope="module")
def pipes():
    from univst_tpu.pipelines.sd import SDVideoPipeline as JPipe
    from univst_torch.models import convert as tcv
    from univst_torch.pipelines.sd import SDVideoPipeline

    with seeded_init(0):
        jp = JPipe.build(variant="tiny", num_frames=F, height=PX, width=PX, dtype=jnp.float32,
                         capture_up_block=2, seed=0)
    tp = SDVideoPipeline.build(variant="tiny", num_frames=F, dtype=torch.float32,
                               capture_up_block=2, device="cpu")
    for module, emit, params, cfg in (
        (tp.unet, tcv.flax_unet_to_state_dict, jp.unet_params, jp.unet.cfg),
        (tp.vae, tcv.flax_vae_to_state_dict, jp.vae_params, jp.vae.cfg),
        (tp.text_encoder, tcv.flax_clip_to_state_dict, jp.text_params, jp.text_encoder.cfg),
    ):
        module.load_state_dict(tcv.to_torch_state_dict(emit(params, cfg)), strict=True)
    return jp, tp


def test_sd_pipeline_slice_matches_jax(pipes):
    from univst_tpu.core.adain import latent_adain as j_latent_adain
    from univst_tpu.core.config import StyleShiftConfig as JShift
    from univst_tpu.core.config import StyleTransferConfig as JSTCfg
    from univst_torch.core.adain import latent_adain
    from univst_torch.core.config import StyleShiftConfig, StyleTransferConfig

    jp, tp = pipes
    rng = np.random.default_rng(0)
    lat0 = rng.standard_normal((F, PX // 8, PX // 8, 4)).astype(np.float32)
    style_rev = rng.standard_normal((N + 1, 1, PX // 8, PX // 8, 4)).astype(np.float32)
    mask = np.zeros((F, PX, PX), np.float32)
    mask[:, 16:48, 8:40] = 1.0
    cap_t = int(jp.schedule.timesteps(N)[::-1][2])

    # text
    jctx = jp.encode_text("")
    tctx = tp.encode_text("")
    assert rel_err(tctx, jctx) < 1e-5

    # content inversion with EasyInv and feature capture
    jtraj, jfeat = jp.invert(jnp.asarray(lat0), jctx, num_steps=N, is_opt=True,
                             capture_timestep=cap_t)
    ttraj, tfeat = tp.invert(torch.tensor(lat0), tctx, num_steps=N, is_opt=True,
                             capture_timestep=cap_t)
    assert ttraj.shape == jtraj.shape == (N + 1, F, PX // 8, PX // 8, 4)
    assert rel_err(ttraj, jtraj) < 1e-3
    assert tfeat.shape == jfeat.shape and rel_err(tfeat, jfeat) < 1e-3

    # stylization, singleton path, both phases (window end 4 of 6 steps)
    shift = dict(alpha=0.65, gamma=3.0, eta2=0.5, num_steps=N, window_mode="sd")
    assert 0 < StyleShiftConfig(**shift).window_end() < N
    jrev = jnp.asarray(np.asarray(jtraj)[::-1].copy())
    jinit = j_latent_adain(jrev[0], jnp.asarray(style_rev[0]))
    jout = jp.stylize_latents(jrev, jnp.asarray(style_rev), jinit,
                              jnp.concatenate([jctx] * 3), mask=jnp.asarray(mask),
                              cfg=JSTCfg(num_steps=N), style_cfg=JShift(**shift))
    trev = torch.flip(torch.tensor(np.asarray(jtraj)), dims=[0])
    tinit = latent_adain(trev[0], torch.tensor(style_rev[0]))
    tout = tp.stylize_latents(trev, torch.tensor(style_rev), tinit, torch.cat([tctx] * 3),
                              mask=torch.tensor(mask), cfg=StyleTransferConfig(num_steps=N),
                              style_cfg=StyleShiftConfig(**shift))
    assert rel_err(tout, jout) < 1e-3

    # chunked temporal-VAE decode to uint8
    jfr = np.concatenate([np.asarray(c) for c in jp.decode_latents_uint8_chunks(jout, 2)])
    tfr = torch.cat(tp.decode_latents_uint8_chunks(torch.tensor(np.asarray(jout)), 2)).numpy()
    # the tiny VAE upsamples 2x: [F, 16, 16, 3]
    assert tfr.shape == jfr.shape == (F, PX // 4, PX // 4, 3) and tfr.dtype == np.uint8
    assert np.abs(tfr.astype(int) - jfr.astype(int)).max() <= 1


def test_encode_frames_matches_jax_with_the_same_posterior_draw(pipes):
    """The VAE encode + posterior sample; torch cannot draw JAX's normals, so
    the port is handed JAX's draw."""
    import jax

    jp, tp = pipes
    frames = np.random.default_rng(2).uniform(-1, 1, (F, PX, PX, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = jp.encode_frames(jnp.asarray(frames), key)
    noise = np.asarray(jax.random.normal(key, want.shape, jnp.float32))
    got = tp.encode_frames(frames, noise=torch.tensor(noise))
    assert got.shape == want.shape and rel_err(got, want) < 1e-4


def test_reconstruct_latents_matches_jax(pipes):
    jp, tp = pipes
    x = np.random.default_rng(1).standard_normal((F, PX // 8, PX // 8, 4)).astype(np.float32)
    ctx = np.asarray(jp.encode_text(""))
    want = jp.reconstruct_latents(jnp.asarray(x), jnp.asarray(ctx), num_steps=N)
    got = tp.reconstruct_latents(torch.tensor(x), torch.tensor(ctx), num_steps=N)
    assert rel_err(got, want) < 1e-3


def test_build_needs_a_gpu_unless_the_cpu_is_asked_for(monkeypatch):
    from univst_torch.pipelines import sd

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        sd.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        sd.resolve_device("cuda")
    assert sd.resolve_device("cpu") == torch.device("cpu")


def test_with_frames_shares_the_modules(pipes):
    _, tp = pipes
    one = tp.with_frames(1)
    assert one.num_frames == 1 and one.unet is tp.unet
    assert dataclasses.replace(tp).num_frames == F


def test_workflow_cli_writes_the_reference_tree(tmp_path):
    """The torch run_workflow on CPU writes the JAX CLIs' output tree:
    fp16 [1, C, F, h, w] trajectory files (the tiny VAE downsamples 2x), the
    [F, H, W, C] feature,
    the input mask then {0, 255} masks, and the stylized PNGs."""
    import os

    from PIL import Image

    from univst_torch.cli import run_workflow

    ex = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
    out = tmp_path / "results"
    run_workflow.main(run_workflow.build_parser().parse_args([
        "--backbone", "sd", "--platform", "cpu", "--variant", "tiny", "--num_frames", "4",
        "--height", "64", "--width", "64", "--time_steps", "2", "--ft_timesteps", "501",
        "--content_path", os.path.join(ex, "contents", "demo-fly-tiny"),
        "--style_path", os.path.join(ex, "styles", "tiny-00033.png"),
        "--mask_path", os.path.join(ex, "masks", "demo-fly-tiny.png"),
        "--output_root", str(out)]))
    inv = out / "contents-inv" / "sd" / "demo-fly-tiny"
    z = torch.load(inv / "inversion" / "ddim_latents_2.pt", weights_only=True)
    assert z.dtype == torch.float16 and tuple(z.shape) == (1, 4, 4, 32, 32)
    feat = torch.load(inv / "features" / "inversion_feature_map_2_block_501_step.pt",
                      weights_only=True)
    assert feat.shape[0] == 4 and feat.float().abs().max() > 0
    sty_z = torch.load(out / "styles-inv" / "sd" / "tiny-00033" / "inversion"
                       / "ddim_latents_0.pt", weights_only=True)
    assert tuple(sty_z.shape) == (1, 4, 4, 32, 32)
    mask_in = np.asarray(Image.open(os.path.join(ex, "masks", "demo-fly-tiny.png")))
    for i in range(4):
        m = np.asarray(Image.open(out / "masks" / "sd" / "demo-fly-tiny" / ("%05d.png" % i)))
        if i == 0:  # the input mask, written verbatim
            np.testing.assert_array_equal(m, mask_in)
        else:
            assert set(np.unique(m)) <= {0, 255}
        px = np.asarray(Image.open(out / "stylizations" / "sd" / "demo-fly-tiny_tiny-00033"
                                   / ("%05d.png" % i)))
        assert px.dtype == np.uint8 and px.shape[-1] == 3
