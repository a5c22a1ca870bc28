"""Parity of the port's models with the JAX package: the tiny SD UNet in its
plain, capture and inject modes, the tiny temporal-decoder VAE, CLIP text,
and the tokenizer. Same weights on both sides (carried across by
``univst_torch.models.convert`` with a strict load), inputs from numpy
seeds, fp32 on the CPU.

Tolerances: relative 1e-4 of the output's max for the UNet and VAE — two
fp32 frameworks sum convolutions and attention in different orders, and
the UNet stacks ~60 layers; 5% for the VAE encode in bf16 (rounding
placement differs between the frameworks); 1e-5 for the shallow CLIP;
token ids exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    jax_clip, jax_unet, jax_vae, rel_err, t, torch_clip, torch_unet, torch_vae,
)

F = 4


def _unet_inputs(b=1, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b * F, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 77, 32)).astype(np.float32)
    return x, ctx


def test_unet_plain_matches_jax():
    from univst_tpu.core.config import SD_BASE_FRAME_INDICES
    from univst_tpu.models.layers import VideoCtx as JVideoCtx
    from univst_torch.models.layers import VideoCtx

    unet, params, cfg = jax_unet()
    x, ctx = _unet_inputs()
    want_eps, want_feat = jax.jit(unet.apply)({"params": params}, jnp.asarray(x), jnp.asarray(301),
                                     jnp.asarray(ctx), JVideoCtx(F, SD_BASE_FRAME_INDICES))
    m = torch_unet(params, cfg)
    with torch.no_grad():
        got_eps, got_feat = m(t(x), 301, t(ctx), VideoCtx(F, SD_BASE_FRAME_INDICES))
    assert got_eps.shape == want_eps.shape and got_feat.shape == want_feat.shape
    assert rel_err(got_eps, want_eps) < 1e-4
    assert rel_err(got_feat, want_feat) < 1e-4


def _capture(unet, params, m, x, ctx, num_frames):
    """Capture-mode forward on both sides -> (jax slots, torch slots)."""
    from univst_tpu.core.config import SD_STYLE_SHIFT as J_SHIFT
    from univst_tpu.models.layers import StyleCtx as JStyleCtx
    from univst_tpu.models.layers import VideoCtx as JVideoCtx
    from univst_tpu.models.unet_sd import extract_pnp_kv as j_extract
    from univst_torch.core.config import SD_STYLE_SHIFT
    from univst_torch.models.layers import StyleCtx, VideoCtx
    from univst_torch.models.unet_sd import extract_pnp_kv

    idx = (-1, 0, "first") if num_frames > 1 else ()
    _, state = jax.jit(unet.apply, static_argnames="mutable")(
        {"params": params}, jnp.asarray(x), jnp.asarray(501), jnp.asarray(ctx),
        JVideoCtx(num_frames, idx), JStyleCtx(step_idx=jnp.asarray(0), cfg=J_SHIFT, capture=True),
        mutable=("pnp_kv",))
    sctx = StyleCtx(step_idx=0, cfg=SD_STYLE_SHIFT, capture=True)
    with torch.no_grad():
        m(t(x), 501, t(ctx), VideoCtx(num_frames, idx), sctx)
    return j_extract(state["pnp_kv"]), extract_pnp_kv(sctx.captured)


@pytest.mark.parametrize("num_frames", [1, F])
def test_unet_capture_matches_jax(num_frames):
    unet, params, cfg = jax_unet()
    m = torch_unet(params, cfg)
    x, ctx = _unet_inputs()
    want, got = _capture(unet, params, m, x[:num_frames], ctx, num_frames)
    assert len(got) == len(want) == 8
    for (gk, gv), (wk, wv) in zip(got, want):
        assert gk.shape == wk.shape
        assert rel_err(gk, wk) < 1e-4 and rel_err(gv, wv) < 1e-4


@pytest.mark.parametrize("step_idx", [3, 40])  # inside / outside the SD shift window
def test_unet_inject_matches_jax(step_idx):
    """2-branch [content | stylized] batch with single-frame style K/V."""
    from univst_tpu.core.config import SD_BASE_FRAME_INDICES, SD_PNP_FRAME_INDICES
    from univst_tpu.core.config import SD_STYLE_SHIFT as J_SHIFT
    from univst_tpu.models.layers import StyleCtx as JStyleCtx
    from univst_tpu.models.layers import VideoCtx as JVideoCtx
    from univst_torch.core.config import SD_STYLE_SHIFT
    from univst_torch.models.layers import StyleCtx, VideoCtx

    unet, params, cfg = jax_unet()
    m = torch_unet(params, cfg)
    x, ctx = _unet_inputs(b=2, seed=1)
    want_kv, _ = _capture(unet, params, m, x[:1], ctx, 1)
    ctx = np.concatenate([ctx, ctx])  # one text context per branch
    kv_np = [(np.asarray(k), np.asarray(v)) for k, v in want_kv]
    want, _ = jax.jit(unet.apply)(
        {"params": params}, jnp.asarray(x), jnp.asarray(201), jnp.asarray(ctx),
        JVideoCtx(F, SD_BASE_FRAME_INDICES, SD_PNP_FRAME_INDICES),
        JStyleCtx(step_idx=jnp.asarray(step_idx), cfg=J_SHIFT,
                  style_kv=tuple((jnp.asarray(k), jnp.asarray(v)) for k, v in kv_np)))
    with torch.no_grad():
        got, _ = m(t(x), 201, t(ctx), VideoCtx(F, SD_BASE_FRAME_INDICES, SD_PNP_FRAME_INDICES),
                   StyleCtx(step_idx=step_idx, cfg=SD_STYLE_SHIFT,
                            style_kv=tuple((t(k), t(v)) for k, v in kv_np)))
    assert rel_err(got, want) < 1e-4


def test_vae_encode_decode_matches_jax():
    from univst_tpu.models.vae import AutoencoderKL as JAE

    vae, params, cfg = jax_vae()
    m = torch_vae(params, cfg)
    rng = np.random.default_rng(3)
    px = rng.uniform(-1, 1, (F, 32, 32, 3)).astype(np.float32)
    z = rng.standard_normal((F, 16, 16, 4)).astype(np.float32)
    wm, wl = jax.jit(lambda p, x: vae.apply(p, x, method=JAE.encode))(
        {"params": params}, jnp.asarray(px))
    wd = jax.jit(lambda p, x: vae.apply(p, x, F, method=JAE.decode))({"params": params},
                                                                      jnp.asarray(z))
    with torch.no_grad():
        gm, gl = m.encode(t(px))
        gd = m.decode(t(z), F)
    assert gm.shape == wm.shape and gd.shape == wd.shape == (F, 32, 32, 3)
    assert rel_err(gm, wm) < 1e-4 and rel_err(gl, wl) < 1e-4
    assert rel_err(gd, wd) < 1e-4


def test_vae_encode_bf16_stays_within_rounding_of_jax():
    """The working dtype on the card: both sides encode in bf16. The gap is
    rounding, not math — torch rounds to bf16 after every op, XLA keeps fp32
    inside a fusion — so it is held at 5% of the output's max (1.1% measured
    on this input), against 1e-4 in fp32 above."""
    from univst_tpu.models.vae import AutoencoderKL as JAE

    vae, params, cfg = jax_vae()
    jvae = JAE(cfg, dtype=jnp.bfloat16)
    m = torch_vae(params, cfg).to(torch.bfloat16)
    px = np.random.default_rng(3).uniform(-1, 1, (F, 32, 32, 3)).astype(np.float32)
    wm, _ = jax.jit(lambda p, x: jvae.apply(p, x, method=JAE.encode))(
        {"params": params}, jnp.asarray(px, jnp.bfloat16))
    with torch.no_grad():
        gm, _ = m.encode(t(px).to(torch.bfloat16))
    err = rel_err(gm.float(), np.asarray(wm, np.float32))
    print(f"bf16 encode: max |torch - jax| / max |jax| = {err}")
    assert err < 0.05


def test_clip_text_matches_jax():
    from univst_tpu.models.clip_text import Tokenizer as JTok

    model, params, cfg = jax_clip()
    m = torch_clip(params, cfg)
    ids = np.concatenate([JTok()(""), JTok()("a fox jumps")])
    want_h, want_p = jax.jit(model.apply)({"params": params}, jnp.asarray(ids))
    with torch.no_grad():
        got_h, got_p = m(torch.as_tensor(ids, dtype=torch.long))
    assert rel_err(got_h, want_h) < 1e-5 and rel_err(got_p, want_p) < 1e-5


@pytest.mark.parametrize("prompt", ["", "a photo of a cat", "Hello, World!  it's 2024",
                                    "naïve café — résumé", "don't STOP"])
def test_tokenizer_ids_match_jax(prompt):
    """Synthetic-vocab ids exactly equal the JAX package's."""
    from univst_tpu.models.clip_text import Tokenizer as JTok
    from univst_torch.models.clip_text import Tokenizer

    np.testing.assert_array_equal(Tokenizer()(prompt), JTok()(prompt))


def test_bpe_matches_jax_on_fixture_vocab(tmp_path):
    """The port's ClipBPE copy on the tests/test_bpe.py fixture vocab and
    prompts (the vocab written as that file's fixture writes it)."""
    import json

    import test_bpe
    from univst_tpu.models.bpe import BOS, EOS, bytes_to_unicode
    from univst_tpu.models.bpe import ClipBPE as JBPE
    from univst_torch.models.bpe import ClipBPE

    syms = list(bytes_to_unicode().values())
    vocab = {s: i for i, s in enumerate(syms)}
    vocab.update({s + "</w>": 256 + i for i, s in enumerate(syms)})
    lines = ["#version: 0.2"]
    for a, b in test_bpe.MERGES:
        if b is not None:
            lines.append(f"{a} {b}")
            vocab[a + b] = len(vocab)
    vocab[BOS], vocab[EOS] = len(vocab), len(vocab) + 1
    (tmp_path / "vocab.json").write_text(json.dumps(vocab), encoding="utf-8")
    (tmp_path / "merges.txt").write_text("\n".join(lines) + "\n", encoding="utf-8")
    mine, ref = ClipBPE.from_dir(str(tmp_path)), JBPE.from_dir(str(tmp_path))
    for text in test_bpe.PROMPTS:
        assert mine.tokenize(text) == ref.tokenize(text)
        np.testing.assert_array_equal(mine([text]), ref([text]))
