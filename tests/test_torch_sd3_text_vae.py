"""Parity of the port's SD3 text encoders and VAE with the JAX package on
tiny configs, the same weights carried across through
``univst_torch.models.convert`` with strict loads: the T5 encoder (and its
relative-position buckets and tokenizer shim), CLIP with
``hidden_state_index=-2`` and a projection, and the 16-channel SD3 VAE.

Tolerance: relative 1e-4 of the max (fp32, a few layers; the sums run in
another order); token ids and buckets exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import rel_err, to_np
from univst_torch.models import convert as tcv


def test_t5_encoder_matches_jax():
    from univst_tpu.models.t5 import T5Config as JT5Cfg
    from univst_tpu.models.t5 import T5Encoder as JT5
    from univst_tpu.models.t5 import T5TokenizerShim as JShim
    from univst_torch.models.t5 import T5Config, T5Encoder, T5TokenizerShim

    jcfg = JT5Cfg.tiny(d_model=64)
    jm = JT5(jcfg)
    params = to_np(jax.jit(jm.init)(jax.random.PRNGKey(5), jnp.zeros((1, 40), jnp.int32))["params"])
    tm = T5Encoder(T5Config.tiny(d_model=64)).eval()
    tm.load_state_dict(tcv.to_torch_state_dict(tcv.flax_t5_to_state_dict(params, jcfg)),
                       strict=True)
    # a byte-fallback prompt and the null prompt; 40 tokens reach the log buckets
    for prompt in ("a duck on a pond", ""):
        ids = T5TokenizerShim(max_len=40)(prompt)
        np.testing.assert_array_equal(ids, JShim(max_len=40)(prompt))
        want = jm.apply({"params": params}, jnp.asarray(ids))
        with torch.no_grad():
            got = tm(torch.tensor(ids, dtype=torch.long))
        assert got.shape == (1, 40, 64) and rel_err(got, want) < 1e-4


def test_t5_relative_buckets_match_jax():
    from univst_tpu.models.t5 import _rel_bucket as j_bucket
    from univst_torch.models.t5 import _rel_bucket

    rel = np.arange(-300, 301)
    np.testing.assert_array_equal(_rel_bucket(torch.tensor(rel), 32, 128).numpy(),
                                  np.asarray(j_bucket(jnp.asarray(rel), 32, 128)))


@pytest.mark.parametrize("hidden_state_index", [None, -2])
def test_clip_with_projection_and_penultimate_state_matches_jax(hidden_state_index):
    from univst_tpu.models.clip_text import CLIPTextConfig as JCfg
    from univst_tpu.models.clip_text import CLIPTextModel as JCLIP
    from univst_torch.models.clip_text import CLIPTextConfig, CLIPTextModel, Tokenizer

    jcfg = JCfg.tiny(projection_dim=16, hidden_act="gelu")
    jm = JCLIP(jcfg)
    params = to_np(jax.jit(jm.init)(jax.random.PRNGKey(6), jnp.zeros((1, 7), jnp.int32))["params"])
    tm = CLIPTextModel(CLIPTextConfig.tiny(projection_dim=16, hidden_act="gelu")).eval()
    tm.load_state_dict(tcv.to_torch_state_dict(tcv.flax_clip_to_state_dict(params, jcfg)),
                       strict=True)
    ids = Tokenizer(max_len=7)("")
    wh, wp = jm.apply({"params": params}, jnp.asarray(ids), hidden_state_index)
    with torch.no_grad():
        th, tp = tm(torch.tensor(ids, dtype=torch.long), hidden_state_index)
    assert th.shape == (1, 7, 32) and tp.shape == (1, 16)
    assert rel_err(th, wh) < 1e-4 and rel_err(tp, wp) < 1e-4


def test_sd3_clip_presets_match_jax():
    import dataclasses

    from univst_tpu.models.clip_text import CLIPTextConfig as JCfg
    from univst_torch.models.clip_text import CLIPTextConfig

    for name in ("sd3_clip_l", "sd3_clip_g"):
        assert (dataclasses.asdict(getattr(CLIPTextConfig, name)())
                == dataclasses.asdict(getattr(JCfg, name)()))


def test_sd3_vae_encode_decode_match_jax():
    from univst_tpu.models.vae import AutoencoderKL as JVAE
    from univst_tpu.models.vae import VAEConfig as JCfg
    from univst_torch.models.vae import AutoencoderKL, VAEConfig

    assert VAEConfig.sd3() == VAEConfig(latent_channels=16, scaling_factor=1.5305,
                                        shift_factor=0.0609)
    assert VAEConfig.sd3().__dict__ == JCfg.sd3().__dict__
    kw = dict(latent_channels=16, scaling_factor=1.5305, shift_factor=0.0609)
    jcfg = JCfg.tiny(**kw)
    jm = JVAE(jcfg)
    params = to_np(jax.jit(jm.init, static_argnums=2)(
        jax.random.PRNGKey(8), jnp.zeros((2, 32, 32, 3)), 2)["params"])
    tm = AutoencoderKL(VAEConfig.tiny(**kw)).eval()
    tm.load_state_dict(tcv.to_torch_state_dict(tcv.flax_vae_to_state_dict(params, jcfg)),
                       strict=True)
    x = np.random.default_rng(3).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    wmean, wlogvar = jm.apply({"params": params}, jnp.asarray(x), method=JVAE.encode)
    with torch.no_grad():
        mean, logvar = tm.encode(torch.tensor(x))
    assert mean.shape == (2, 16, 16, 16)
    assert rel_err(mean, wmean) < 1e-4 and rel_err(logvar, wlogvar) < 1e-4
    z = np.asarray(wmean)
    want = jm.apply({"params": params}, jnp.asarray(z), 2, method=JVAE.decode)
    with torch.no_grad():
        got = tm.decode(torch.tensor(z))
    assert got.shape == (2, 32, 32, 3) and rel_err(got, want) < 1e-4
