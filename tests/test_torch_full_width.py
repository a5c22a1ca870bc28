"""The port against the JAX package at full width, on the CPU (all ``slow``).

  * The full-size config dataclasses of both packages are equal field for
    field. One default differs on purpose: ``UNetSDConfig.temporal_identity``
    is False in the JAX package and True in the port, which is what the JAX
    pipeline builds (``univst_tpu/pipelines/sd.py:122``).
  * One fp32 forward of each full-width model with ``seeded_init`` weights
    (the JAX init's shapes, numpy draws) carried over by one strict load,
    at small spatial sizes: the SD-1.5 and SD-2.1 UNets (2 frames, 16x16
    latents), the AnimateDiff-v2 UNet with every motion module's
    ``proj_out`` filled (4 frames, 16x16), the SD3.5-medium MMDiT with its
    dual attention (2 frames, 16x16 latents), and the SVD VAE (encode and
    temporal decode, 2 frames at 64 px). Tolerance: 1e-5 of the output's
    max; a by-hand run of these forwards measured 2.7e-6 to 4.3e-6.

Each forward holds two copies of the model's fp32 weights in host memory
(SD3.5-medium: 2.5B parameters, ~10 GB a copy); run them one at a time:
``python -m pytest tests/test_torch_full_width.py -m slow -k <name>``.
"""

import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import rel_err, seeded_init, t, to_np
from univst_torch.models import convert as tcv

pytestmark = pytest.mark.slow


def _configs():
    from univst_tpu.models import clip_text as jclip
    from univst_tpu.models import mmdit as jmmdit
    from univst_tpu.models import raft as jraft
    from univst_tpu.models import t5 as jt5
    from univst_tpu.models import unet_ad as jad
    from univst_tpu.models import unet_sd as jsd
    from univst_tpu.models import vae as jvae
    from univst_torch.models import clip_text, mmdit, raft, t5, unet_ad, unet_sd, vae

    return {
        "unet_sd15": (jsd.UNetSDConfig.sd15(temporal_identity=True), unet_sd.UNetSDConfig.sd15()),
        "unet_sd21": (jsd.UNetSDConfig.sd21(temporal_identity=True), unet_sd.UNetSDConfig.sd21()),
        "unet_ad_v2": (jad.UNetADConfig.ad_v2(), unet_ad.UNetADConfig.ad_v2()),
        "vae_svd": (jvae.VAEConfig.svd(), vae.VAEConfig.svd()),
        "vae_sd3": (jvae.VAEConfig.sd3(), vae.VAEConfig.sd3()),
        "clip_sd15": (jclip.CLIPTextConfig.sd15(), clip_text.CLIPTextConfig.sd15()),
        "clip_sd21": (jclip.CLIPTextConfig.sd21(), clip_text.CLIPTextConfig.sd21()),
        "clip_sd3_l": (jclip.CLIPTextConfig.sd3_clip_l(), clip_text.CLIPTextConfig.sd3_clip_l()),
        "clip_sd3_g": (jclip.CLIPTextConfig.sd3_clip_g(), clip_text.CLIPTextConfig.sd3_clip_g()),
        "mmdit_sd3_medium": (jmmdit.MMDiTConfig.sd3_medium(), mmdit.MMDiTConfig.sd3_medium()),
        "mmdit_sd35_medium": (jmmdit.MMDiTConfig.sd35_medium(),
                              mmdit.MMDiTConfig.sd35_medium()),
        "mmdit_sd35_large": (jmmdit.MMDiTConfig.sd35_large(), mmdit.MMDiTConfig.sd35_large()),
        "t5_xxl": (jt5.T5Config.xxl(), t5.T5Config.xxl()),
        "raft": (jraft.RAFTConfig(), raft.RAFTConfig()),
    }


@pytest.mark.parametrize("name", ["unet_sd15", "unet_sd21", "unet_ad_v2", "vae_svd", "vae_sd3",
                                  "clip_sd15", "clip_sd21", "clip_sd3_l", "clip_sd3_g",
                                  "mmdit_sd3_medium", "mmdit_sd35_medium", "mmdit_sd35_large",
                                  "t5_xxl", "raft"])
def test_full_size_configs_are_equal(name):
    jcfg, tcfg = _configs()[name]
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    if name.startswith("unet_sd"):  # the one default that differs
        assert not type(jcfg)().temporal_identity and type(tcfg)().temporal_identity


def _init(module, seed, *args):
    with seeded_init(seed):
        return to_np(module.init(jax.random.PRNGKey(seed), *args)["params"])


def _load(make, emit, params, jcfg):
    """The port's module from ``make()``, holding ``params`` (emitted by
    ``emit``) after one strict load. ``params`` is emptied first: at most
    two fp32 copies of the weights are alive at once."""
    sd = emit(params, jcfg)
    params.clear()
    gc.collect()
    module = make()
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return module.eval()


def _check(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert rel_err(got, want) < 1e-5, rel_err(got, want)


@pytest.mark.parametrize("variant", ["sd15", "sd21"])
def test_sd_unet_forward_matches_jax(variant):
    from univst_tpu.core.config import SD_BASE_FRAME_INDICES
    from univst_tpu.models.layers import VideoCtx as JVideoCtx
    from univst_tpu.models.unet_sd import UNetPseudo3D as JUNet
    from univst_tpu.models.unet_sd import UNetSDConfig as JCfg
    from univst_torch.models.layers import VideoCtx
    from univst_torch.models.unet_sd import UNetPseudo3D, UNetSDConfig

    f, hw = 2, 16
    jcfg = getattr(JCfg, variant)(temporal_identity=True)
    junet = JUNet(jcfg, dtype=jnp.float32)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((f, hw, hw, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 77, jcfg.cross_attention_dim)).astype(np.float32)
    jvctx = JVideoCtx(f, SD_BASE_FRAME_INDICES)
    params = _init(junet, 0, jnp.zeros_like(x), jnp.asarray(0), jnp.zeros_like(ctx), jvctx)
    want, _ = junet.apply({"params": params}, jnp.asarray(x), jnp.asarray(301), jnp.asarray(ctx),
                          jvctx)
    want = np.asarray(want)
    m = _load(lambda: UNetPseudo3D(getattr(UNetSDConfig, variant)()),
              tcv.flax_unet_to_state_dict, params, jcfg)
    with torch.no_grad():
        got, _ = m(t(x), 301, t(ctx), VideoCtx(f, SD_BASE_FRAME_INDICES))
    _check(got, want)


def test_ad_unet_forward_matches_jax():
    from univst_tpu.models.layers import VideoCtx as JVideoCtx
    from univst_tpu.models.unet_ad import UNetAnimateDiff as JUNet
    from univst_tpu.models.unet_ad import UNetADConfig as JCfg
    from univst_torch.models.layers import VideoCtx
    from univst_torch.models.unet_ad import UNetAnimateDiff, UNetADConfig

    f, hw = 4, 16
    jcfg = JCfg.ad_v2()
    junet = JUNet(jcfg, dtype=jnp.float32)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((f, hw, hw, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 77, 768)).astype(np.float32)
    jvctx = JVideoCtx(num_frames=f, frame_indices=())
    params = _init(junet, 0, jnp.zeros_like(x), jnp.asarray(0), jnp.zeros_like(ctx), jvctx)
    for name, sub in params.items():  # proj_out is zero at init: draw it
        if "motion" in name:
            k = sub["proj_out"]["kernel"]
            sub["proj_out"]["kernel"] = (rng.standard_normal(k.shape)
                                         / np.sqrt(k.shape[0])).astype(np.float32)
    want, _ = junet.apply({"params": params}, jnp.asarray(x), jnp.asarray(301), jnp.asarray(ctx),
                          jvctx)
    want = np.asarray(want)
    m = _load(lambda: UNetAnimateDiff(UNetADConfig.ad_v2()), tcv.flax_ad_unet_to_state_dict,
              params, jcfg)
    with torch.no_grad():
        got, _ = m(t(x), 301, t(ctx), VideoCtx(num_frames=f, frame_indices=()))
    _check(got, want)


def test_sd35_medium_mmdit_forward_matches_jax():
    from univst_tpu.core.config import SD3_FRAME_INDICES
    from univst_tpu.models.layers import VideoCtx as JVideoCtx
    from univst_tpu.models.mmdit import MMDiT as JMMDiT
    from univst_tpu.models.mmdit import MMDiTConfig as JCfg
    from univst_torch.models.layers import VideoCtx
    from univst_torch.models.mmdit import MMDiT, MMDiTConfig

    f, hw = 2, 16
    jcfg = JCfg.sd35_medium()
    jm = JMMDiT(jcfg)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((f, hw, hw, 16)).astype(np.float32)
    ctx = rng.standard_normal((1, 333, jcfg.joint_attention_dim)).astype(np.float32)
    pooled = rng.standard_normal((1, jcfg.pooled_projection_dim)).astype(np.float32)
    jvctx = JVideoCtx(num_frames=f, frame_indices=SD3_FRAME_INDICES)
    params = _init(jm, 0, jnp.zeros_like(x), jnp.asarray(500.0), jnp.zeros_like(ctx),
                   jnp.zeros_like(pooled), jvctx)
    want, _ = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(700.0), jnp.asarray(ctx),
                       jnp.asarray(pooled), jvctx)
    want = np.asarray(want)
    m = _load(lambda: MMDiT(MMDiTConfig.sd35_medium()), tcv.flax_mmdit_to_state_dict, params,
              jcfg)
    with torch.no_grad():
        got, _ = m(t(x), 700.0, t(ctx), t(pooled),
                   VideoCtx(num_frames=f, frame_indices=SD3_FRAME_INDICES))
    _check(got, want)


def test_svd_vae_matches_jax():
    from univst_tpu.models.vae import AutoencoderKL as JAE
    from univst_tpu.models.vae import VAEConfig as JCfg
    from univst_torch.models.vae import AutoencoderKL, VAEConfig

    f, px = 2, 64
    jcfg = JCfg.svd()
    jvae = JAE(jcfg, dtype=jnp.float32)
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (f, px, px, 3)).astype(np.float32)
    z = rng.standard_normal((f, px // 8, px // 8, 4)).astype(np.float32)
    params = _init(jvae, 0, jnp.zeros_like(x), f)
    wm, wl = jvae.apply({"params": params}, jnp.asarray(x), method=JAE.encode)
    wd = jvae.apply({"params": params}, jnp.asarray(z), f, method=JAE.decode)
    m = _load(lambda: AutoencoderKL(VAEConfig.svd()), tcv.flax_vae_to_state_dict, params, jcfg)
    with torch.no_grad():
        gm, gl = m.encode(t(x))
        gd = m.decode(t(z), f)
    _check(gm, wm)
    _check(gl, wl)
    _check(gd, wd)
