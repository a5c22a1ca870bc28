"""The pixel smoother in the port's SD pipeline against the JAX package's, on
the tiny SD config (4 frames, 64 px frames = 32x32 latents, 4 steps,
smoothing steps [1, 3), radius 1) in fp32 on the CPU, with the same
weights; and classifier-free-guidance reconstruction.

* One smoothing step: the port's capture-and-inject step with the
  smoother's eps hook against the JAX package's ``_stylize_smooth_step``
  (blend, AdaIN anchor, 3-branch eps, x0, decode, LK warp-average with the
  mask, re-encode, ``return_to_timestep``, DDIM step).
* ``stylize_latents(smoother='pixel')`` end to end (a one-frame style
  trajectory) against the JAX package's in-batch 3-branch path: on the
  style-singleton path, and on the capture-and-inject and batched pre-pass
  paths with the style broadcast to the frames.
* ``reconstruct_latents`` at guidance 3 (the [uncond | cond] batch).

Tolerances: latents at relative 1e-3 of their max, as the pipeline's other
parity tests (two fp32 frameworks, ~60 layers per UNet call, and here the
VAE and the LK flow inside the step).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import rel_err, seeded_init

F, PX, N = 4, 64, 4
H = PX // 2  # the tiny VAE downsamples 2x
CFG = dict(num_steps=N, smoother="pixel", smoother_steps=(1, 3), smoother_radius=1)


@pytest.fixture(scope="module")
def pipes():
    from univst_tpu.pipelines.sd import SDVideoPipeline as JPipe
    from univst_torch.models import convert as tcv
    from univst_torch.pipelines.sd import SDVideoPipeline

    with seeded_init(0):
        jp = JPipe.build(variant="tiny", num_frames=F, height=PX, width=PX, dtype=jnp.float32,
                         seed=0)
    tp = SDVideoPipeline.build(variant="tiny", num_frames=F, dtype=torch.float32, device="cpu")
    for module, emit, params, cfg in (
        (tp.unet, tcv.flax_unet_to_state_dict, jp.unet_params, jp.unet.cfg),
        (tp.vae, tcv.flax_vae_to_state_dict, jp.vae_params, jp.vae.cfg),
        (tp.text_encoder, tcv.flax_clip_to_state_dict, jp.text_params, jp.text_encoder.cfg),
    ):
        module.load_state_dict(tcv.to_torch_state_dict(emit(params, cfg)), strict=True)
    return jp, tp


@pytest.fixture(scope="module")
def inputs(pipes):
    jp, _ = pipes
    rng = np.random.default_rng(0)
    content = rng.standard_normal((N + 1, F, H, H, 4)).astype(np.float32)
    style = rng.standard_normal((N + 1, 1, H, H, 4)).astype(np.float32)
    mask = np.zeros((F, PX, PX), np.float32)
    mask[:, 16:48, 8:40] = 1.0
    ctx = np.asarray(jp.encode_text(""))
    return content, style, mask, np.concatenate([ctx] * 3)


def test_smooth_step_matches_jax(pipes, inputs):
    from univst_tpu.core.config import StyleTransferConfig as JSTCfg
    from univst_tpu.pipelines.sd import _stylize_smooth_step
    from univst_torch.core.config import StyleTransferConfig

    jp, tp = pipes
    content, style, mask, ctx3 = inputs
    style_f = np.broadcast_to(style, content.shape).copy()
    lat = np.random.default_rng(1).standard_normal((F, H, H, 4)).astype(np.float32)
    i = 1
    t = int(jp.schedule.timesteps(N)[i])
    want = _stylize_smooth_step(
        jp, jp.unet_params, jp.vae_params, jnp.asarray(content[i]), jnp.asarray(style_f[i]),
        jnp.asarray(lat), jnp.asarray(i), jnp.asarray(t), jnp.asarray(ctx3), jnp.asarray(mask),
        JSTCfg(**CFG), jp.style_shift_cfg)
    cfg, tmask = StyleTransferConfig(**CFG), torch.tensor(mask)
    with torch.inference_mode():
        got = tp._stylize_chunk_capture(torch.tensor(content), torch.tensor(style_f),
                                        torch.tensor(lat), tp.schedule.timesteps(N), i,
                                        torch.tensor(ctx3), tmask, cfg, tp.style_shift_cfg, 1,
                                        tp._smooth_hook(cfg, tmask))
    assert got.shape == want.shape == (F, H, H, 4)
    assert rel_err(got, want) < 1e-3


@pytest.fixture(scope="module")
def smoothed_jax(pipes, inputs):
    """The JAX package's ``stylize_latents(smoother='pixel')``."""
    from univst_tpu.core.adain import latent_adain as j_latent_adain
    from univst_tpu.core.config import StyleTransferConfig as JSTCfg

    jp, _ = pipes
    content, style, mask, ctx3 = inputs
    jinit = j_latent_adain(jnp.asarray(content[0]), jnp.asarray(style[0]))
    return jp.stylize_latents(jnp.asarray(content), jnp.asarray(style), jinit, jnp.asarray(ctx3),
                              mask=jnp.asarray(mask), cfg=JSTCfg(**CFG))


def test_stylize_latents_with_the_smoother_matches_jax(pipes, inputs, smoothed_jax):
    from univst_torch.core.adain import latent_adain
    from univst_torch.core.config import StyleTransferConfig

    _, tp = pipes
    content, style, mask, ctx3 = inputs
    want = smoothed_jax
    tinit = latent_adain(torch.tensor(content[0]), torch.tensor(style[0]))
    args = (torch.tensor(content), torch.tensor(style), tinit, torch.tensor(ctx3))
    got = tp.stylize_latents(*args, mask=torch.tensor(mask), cfg=StyleTransferConfig(**CFG))
    assert torch.isfinite(got).all() and rel_err(got, want) < 1e-3
    # the smoother changes the result
    plain = tp.stylize_latents(*args, mask=torch.tensor(mask),
                               cfg=StyleTransferConfig(num_steps=N))
    assert (got - plain).abs().max() > 1e-4


@pytest.mark.parametrize("path", [dict(style_singleton=False),
                                  dict(style_singleton=False, style_prepass_chunk=2)],
                         ids=["capture", "prepass"])
def test_smoother_off_the_singleton_path_matches_jax(pipes, inputs, smoothed_jax, path):
    import dataclasses

    from univst_torch.core.adain import latent_adain
    from univst_torch.core.config import StyleTransferConfig

    _, tp = pipes
    content, style, mask, ctx3 = inputs
    tp = dataclasses.replace(tp, **path)
    got = tp.stylize_latents(torch.tensor(content), torch.tensor(style),
                             latent_adain(torch.tensor(content[0]), torch.tensor(style[0])),
                             torch.tensor(ctx3), mask=torch.tensor(mask),
                             cfg=StyleTransferConfig(**CFG))
    assert torch.isfinite(got).all() and rel_err(got, smoothed_jax) < 1e-3


def test_reconstruct_latents_with_guidance_matches_jax(pipes):
    jp, tp = pipes
    rng = np.random.default_rng(2)
    x = rng.standard_normal((F, H // 2, H // 2, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 77, 32)).astype(np.float32)
    want = jp.reconstruct_latents(jnp.asarray(x), jnp.asarray(ctx), num_steps=2,
                                  guidance_scale=3.0)
    got = tp.reconstruct_latents(torch.tensor(x), torch.tensor(ctx), num_steps=2,
                                 guidance_scale=3.0)
    plain = tp.reconstruct_latents(torch.tensor(x), torch.tensor(ctx), num_steps=2)
    assert rel_err(got, want) < 1e-3 and (got - plain).abs().max() > 1e-3


def test_unknown_smoother_raises(pipes, inputs):
    from univst_torch.core.config import StyleTransferConfig

    _, tp = pipes
    content, style, mask, ctx3 = inputs
    with pytest.raises(ValueError, match="latent"):
        tp.stylize_latents(torch.tensor(content), torch.tensor(style),
                           torch.tensor(content[0]), torch.tensor(ctx3),
                           cfg=StyleTransferConfig(num_steps=N, smoother="latent"))
