"""SD-2.1's topology at tiny widths: the port's SD pipeline against the JAX
package's, in fp32 on the CPU, with the same weights (the JAX pipeline's
params, drawn by ``seeded_init(0)``, carried across with strict loads).

The topology is SD-2.1's (``UNetSDConfig.sd21``, ``CLIPTextConfig.sd21``)
at the tiny widths: linear ``proj_in`` / ``proj_out``, heads of one width at
every level (16 here, 64 at full width), a cross-attention context wider
than SD-1.5-tiny's (48 against 32, as 1024 against 768) from a GELU CLIP;
4 frames at 64 px. Both packages' ``SDVideoPipeline.build`` take the
configs as ``unet_cfg`` / ``clip_cfg``.

Covered: text encoding, content inversion with EasyInv and the up-block-2
feature, single-frame style inversion, mask propagation on each package's
own feature (the same anchor scores), stylization on the style-singleton
path with both phases and the decode, reconstruction, and the strict load
of the diffusers-layout SD-2.1 state dicts that the JAX package's
``synth_ckpt`` emits.

Tolerances are ``tests/test_torch_pipeline.py``'s: latents and features
at relative 1e-3 of their max, frames within one level; text 1e-5. Mask
propagation: the soft masks at 1e-3 of their max (they follow features
that agree to ~1e-4), the binarized masks equal on >= 99% of the pixels.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import SD21_TINY_CTX, rel_err, sd21_tiny_configs, seeded_init

F, PX, N = 4, 64, 6
CTX = SD21_TINY_CTX


@pytest.fixture(scope="module")
def pipes():
    from univst_torch.models import clip_text as tclip
    from univst_torch.models import convert as tcv
    from univst_torch.models import unet_sd as tunet
    from univst_torch.pipelines.sd import SDVideoPipeline
    from univst_tpu.models import clip_text as jclip
    from univst_tpu.models import unet_sd as junet
    from univst_tpu.pipelines.sd import SDVideoPipeline as JPipe

    junet_cfg, jclip_cfg = sd21_tiny_configs(junet, jclip)
    tunet_cfg, tclip_cfg = sd21_tiny_configs(tunet, tclip)
    with seeded_init(0):
        jp = JPipe.build(variant="tiny", num_frames=F, height=PX, width=PX, dtype=jnp.float32,
                         capture_up_block=2, seed=0, unet_cfg=junet_cfg, clip_cfg=jclip_cfg)
    tp = SDVideoPipeline.build(variant="tiny", num_frames=F, dtype=torch.float32,
                               capture_up_block=2, device="cpu", unet_cfg=tunet_cfg,
                               clip_cfg=tclip_cfg)
    for module, emit, params, cfg in (
        (tp.unet, tcv.flax_unet_to_state_dict, jp.unet_params, jp.unet.cfg),
        (tp.vae, tcv.flax_vae_to_state_dict, jp.vae_params, jp.vae.cfg),
        (tp.text_encoder, tcv.flax_clip_to_state_dict, jp.text_params, jp.text_encoder.cfg),
    ):
        module.load_state_dict(tcv.to_torch_state_dict(emit(params, cfg)), strict=True)
    return jp, tp


@pytest.fixture(scope="module")
def inverted(pipes):
    """Both packages' text context and content inversion (EasyInv, the
    feature captured at the third timestep) of one seeded clip."""
    jp, tp = pipes
    lat0 = np.random.default_rng(0).standard_normal((F, PX // 8, PX // 8, 4)).astype(np.float32)
    cap_t = int(jp.schedule.timesteps(N)[::-1][2])
    jctx, tctx = jp.encode_text(""), tp.encode_text("")
    jtraj, jfeat = jp.invert(jnp.asarray(lat0), jctx, num_steps=N, is_opt=True,
                             capture_timestep=cap_t)
    ttraj, tfeat = tp.invert(torch.tensor(lat0), tctx, num_steps=N, is_opt=True,
                             capture_timestep=cap_t)
    return dict(jctx=jctx, tctx=tctx, jtraj=jtraj, jfeat=jfeat, ttraj=ttraj, tfeat=tfeat)


@pytest.mark.parametrize("level", range(4))
def test_sd21_topology_heads_of_one_width_and_linear_projections(level, pipes):
    """SD-2.1's shape at each level: heads of one width (64 at full width:
    320 / 5, 640 / 10, 1280 / 20), linear ``proj_in`` / ``proj_out``, the
    cross-attention's K/V read the wide context; the full configs of both
    packages agree."""
    from univst_torch.models.clip_text import CLIPTextConfig
    from univst_torch.models.unet_sd import UNetSDConfig
    from univst_tpu.models.clip_text import CLIPTextConfig as JClip
    from univst_tpu.models.unet_sd import UNetSDConfig as JUNet

    full = UNetSDConfig.sd21()
    assert full.block_out_channels[level] // full.num_heads[level] == 64
    assert (full.use_linear_projection, full.cross_attention_dim) == (True, 1024)
    assert dataclasses.asdict(full) == dataclasses.asdict(JUNet.sd21(temporal_identity=True))
    assert dataclasses.asdict(CLIPTextConfig.sd21()) == dataclasses.asdict(JClip.sd21())
    _, tp = pipes
    cfg = tp.unet.cfg
    assert cfg.block_out_channels[level] // cfg.num_heads[level] == 16
    # the mid block holds the level-3 attention (down block 3 has none)
    attn = (tp.unet.down_blocks[level] if level < 3 else tp.unet.mid_block).attentions[0]
    c = attn.proj_in.weight.shape[0]
    assert isinstance(attn.proj_in, torch.nn.Linear) and attn.proj_in.weight.shape == (c, c)
    assert attn.proj_out.weight.shape == (c, c)
    block = attn.transformer_blocks[0]
    assert block.attn2.to_k.weight.shape == block.attn2.to_v.weight.shape == (c, CTX)


def test_sd21_text_encoding_matches_jax(inverted):
    assert inverted["tctx"].shape == (1, 77, CTX)
    assert rel_err(inverted["tctx"], inverted["jctx"]) < 1e-5


def test_sd21_content_inversion_and_feature_match_jax(inverted):
    jtraj, ttraj = inverted["jtraj"], inverted["ttraj"]
    assert ttraj.shape == jtraj.shape == (N + 1, F, PX // 8, PX // 8, 4)
    assert rel_err(ttraj, jtraj) < 1e-3
    assert inverted["tfeat"].shape == inverted["jfeat"].shape
    assert float(np.abs(np.asarray(inverted["jfeat"])).max()) > 0
    assert rel_err(inverted["tfeat"], inverted["jfeat"]) < 1e-3


def test_sd21_style_inversion_matches_jax(pipes, inverted):
    """Single-frame style inversion (no EasyInv), as the style CLI runs it."""
    jp, tp = pipes
    sty = np.random.default_rng(3).standard_normal((1, PX // 8, PX // 8, 4)).astype(np.float32)
    want = dataclasses.replace(jp, num_frames=1).invert(jnp.asarray(sty), inverted["jctx"],
                                                        num_steps=N, is_opt=False)[0]
    got = tp.with_frames(1).invert(torch.tensor(sty), inverted["tctx"], num_steps=N,
                                   is_opt=False)[0]
    assert got.shape == want.shape == (N + 1, 1, PX // 8, PX // 8, 4)
    assert rel_err(got, want) < 1e-3


def test_sd21_mask_propagation_matches_jax(inverted):
    """Each package propagates a first-frame mask on its own captured
    feature, with the same anchor scores."""
    from univst_torch.methods import mask_propagation as tmp
    from univst_tpu.methods import mask_propagation as jmp

    jfeat, tfeat = np.asarray(inverted["jfeat"]), inverted["tfeat"]
    f, fh, fw, c = jfeat.shape
    seg = np.zeros((fh, fw), np.int64)
    seg[fh // 4:3 * fh // 4, fw // 8:5 * fw // 8] = 1
    key = jax.random.PRNGKey(0)
    scores = np.stack([np.asarray(jax.random.uniform(k, (fh * fw,)))
                       for k in jax.random.split(key, f - 1)])
    want = jmp.propagate_masks(jnp.asarray(jfeat.reshape(f, fh * fw, c)),
                               jmp.to_one_hot(jnp.asarray(seg), 2), key=key)
    got = tmp.propagate_masks(tfeat.reshape(f, fh * fw, c), tmp.to_one_hot(torch.tensor(seg), 2),
                              scores=torch.tensor(scores))
    assert got.shape == want.shape == (f - 1, 2, fh * fw)
    assert rel_err(got, want) < 1e-3
    gm = tmp.upsample_and_binarize(got, (fh, fw), (PX, PX)).numpy()
    wm = np.asarray(jmp.upsample_and_binarize(want, (fh, fw), (PX, PX)))
    assert set(np.unique(gm)) <= {0, 255}
    assert (gm == wm).mean() >= 0.99


@pytest.mark.slow  # ~30 s on the CPU, most of it JAX's compile of the stylization
def test_sd21_stylization_and_decode_match_jax(pipes, inverted):
    """The singleton path with both phases (a 6-step window puts steps 0-3
    in the injected 2-branch phase), mask blend, AdaIN re-anchor; then the
    chunked temporal-VAE decode to uint8."""
    from univst_torch.core.adain import latent_adain
    from univst_torch.core.config import StyleShiftConfig, StyleTransferConfig
    from univst_tpu.core.adain import latent_adain as j_latent_adain
    from univst_tpu.core.config import StyleShiftConfig as JShift
    from univst_tpu.core.config import StyleTransferConfig as JSTCfg

    jp, tp = pipes
    rng = np.random.default_rng(1)
    style_rev = rng.standard_normal((N + 1, 1, PX // 8, PX // 8, 4)).astype(np.float32)
    mask = np.zeros((F, PX, PX), np.float32)
    mask[:, 16:48, 8:40] = 1.0
    shift = dict(alpha=0.65, gamma=3.0, eta2=0.5, num_steps=N, window_mode="sd")
    assert 0 < StyleShiftConfig(**shift).window_end() < N
    jtraj = np.asarray(inverted["jtraj"])
    jrev = jnp.asarray(jtraj[::-1].copy())
    jctx = inverted["jctx"]
    jout = jp.stylize_latents(jrev, jnp.asarray(style_rev),
                              j_latent_adain(jrev[0], jnp.asarray(style_rev[0])),
                              jnp.concatenate([jctx] * 3), mask=jnp.asarray(mask),
                              cfg=JSTCfg(num_steps=N), style_cfg=JShift(**shift))
    trev = torch.flip(torch.tensor(jtraj), dims=[0])
    tout = tp.stylize_latents(trev, torch.tensor(style_rev),
                              latent_adain(trev[0], torch.tensor(style_rev[0])),
                              torch.cat([inverted["tctx"]] * 3), mask=torch.tensor(mask),
                              cfg=StyleTransferConfig(num_steps=N),
                              style_cfg=StyleShiftConfig(**shift))
    assert rel_err(tout, jout) < 1e-3
    jfr = np.concatenate([np.asarray(c) for c in jp.decode_latents_uint8_chunks(jout, 2)])
    tfr = torch.cat(tp.decode_latents_uint8_chunks(torch.tensor(np.asarray(jout)), 2)).numpy()
    assert tfr.shape == jfr.shape and tfr.dtype == np.uint8
    assert np.abs(tfr.astype(int) - jfr.astype(int)).max() <= 1


def test_sd21_reconstruction_matches_jax(pipes, inverted):
    jp, tp = pipes
    x = np.asarray(inverted["jtraj"])[-1]
    want = jp.reconstruct_latents(jnp.asarray(x), inverted["jctx"], num_steps=N)
    got = tp.reconstruct_latents(torch.tensor(x), torch.tensor(np.asarray(inverted["jctx"])),
                                 num_steps=N)
    assert rel_err(got, want) < 1e-3


@pytest.mark.parametrize("module", ["unet", "text_encoder"])
def test_sd21_diffusers_state_dict_loads_strictly(module, pipes):
    """The diffusers / transformers-layout state dicts that
    ``univst_tpu.models.synth_ckpt`` writes for this topology (linear
    ``proj_in`` / ``proj_out`` as ``[C, C]``, not ``[C, C, 1, 1]``; the
    cross-attention's ``to_k`` / ``to_v`` ``[C, 48]``) load into the
    port's modules with ``strict=True``, every value where it was put."""
    from univst_torch.models import convert as tcv
    from univst_tpu.models import synth_ckpt as sk

    jp, tp = pipes
    if module == "unet":
        sd = sk.synth_sd_unet(jp.unet_params, jp.unet.cfg)
        assert sd["down_blocks.0.attentions.0.proj_in.weight"].shape == (32, 32)
        assert sd["down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_k.weight"].shape \
            == (32, CTX)
        target = type(tp.unet)(tp.unet.cfg)
    else:
        sd = sk.synth_clip_text(jp.text_params, jp.text_encoder.cfg)
        target = type(tp.text_encoder)(tp.text_encoder.cfg)
    target.load_state_dict(tcv.to_torch_state_dict(sd), strict=True)
    got = target.state_dict()
    for key, value in sd.items():
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)
