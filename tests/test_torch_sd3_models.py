"""Parity of the port's MMDiT with the JAX package on tiny configs, the
same weights carried across through ``univst_torch.models.convert`` with
strict loads: plain, 3-branch shift, capture and injected modes, in the SD3
form and the SD3.5 form with qk RMS norms and dual attention. The text
encoders and the VAE are in tests/test_torch_sd3_text_vae.py.

Tolerance: relative 1e-4 of the max (fp32, a few layers; the sums run in
another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import rel_err, to_np
from univst_tpu.core.config import SD3_FRAME_INDICES, SD3_STYLE_SHIFT as J_SHIFT
from univst_tpu.models import layers as jlayers
from univst_torch.core.config import SD3_STYLE_SHIFT
from univst_torch.models import convert as tcv
from univst_torch.models.layers import StyleCtx, VideoCtx

F = 3
FORMS = {
    "sd3": dict(capture_block=1),
    "sd35_dual": dict(capture_block=0, qk_norm="rms", dual_attention_layers=(0,)),
}


@functools.lru_cache(maxsize=None)
def _mmdits(form: str):
    from univst_tpu.models.mmdit import MMDiT as JMMDiT
    from univst_tpu.models.mmdit import MMDiTConfig as JCfg
    from univst_torch.models.mmdit import MMDiT, MMDiTConfig

    jcfg = JCfg.tiny(**FORMS[form])
    jm = JMMDiT(jcfg)
    vctx = jlayers.VideoCtx(num_frames=F, frame_indices=SD3_FRAME_INDICES)
    params = jax.jit(jm.init, static_argnums=(5,))(
        jax.random.PRNGKey(4), jnp.zeros((F, 8, 8, 16)), jnp.asarray(500.0),
        jnp.zeros((1, 10, 64)), jnp.zeros((1, 32)), vctx)["params"]
    params = to_np(params)
    tm = MMDiT(MMDiTConfig.tiny(**FORMS[form])).eval()
    tm.load_state_dict(tcv.to_torch_state_dict(tcv.flax_mmdit_to_state_dict(params, jcfg)),
                       strict=True)
    return jm, params, tm


def _inputs(branches: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((branches * F, 8, 8, 16)).astype(np.float32)
    ctx = rng.standard_normal((branches, 10, 64)).astype(np.float32)
    pooled = rng.standard_normal((branches, 32)).astype(np.float32)
    return x, ctx, pooled


def _jvctx(f):
    return jlayers.VideoCtx(num_frames=f, frame_indices=SD3_FRAME_INDICES if f > 1 else ())


def _tvctx(f):
    return VideoCtx(num_frames=f, frame_indices=SD3_FRAME_INDICES if f > 1 else ())


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("step", [None, 5, 40])  # plain; 3-branch shift in / past the window
def test_mmdit_plain_and_shift_match_jax(form, step):
    jm, params, tm = _mmdits(form)
    branches = 1 if step is None else 3
    x, ctx, pooled = _inputs(branches, 0)
    jsctx = None if step is None else jlayers.StyleCtx(step_idx=step, cfg=J_SHIFT)
    tsctx = None if step is None else StyleCtx(step_idx=step, cfg=SD3_STYLE_SHIFT)
    want, wfeat = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(700.0),
                           jnp.asarray(ctx), jnp.asarray(pooled), _jvctx(F), jsctx)
    with torch.no_grad():
        got, feat = tm(torch.tensor(x), 700.0, torch.tensor(ctx), torch.tensor(pooled),
                       _tvctx(F), tsctx)
    assert got.shape == x.shape and rel_err(got, want) < 1e-4
    # the feature after the capture block: [B*F, h/2, w/2, hidden]
    assert feat.shape == wfeat.shape == (branches * F, 4, 4, 32)
    assert rel_err(feat, wfeat) < 1e-4


@pytest.mark.parametrize("form", sorted(FORMS))
def test_mmdit_capture_and_injected_match_jax(form):
    """The single-frame capture forward records every block's (k, v) (joint,
    and dual for SD3.5-medium blocks); the injected 2-branch forward takes
    them in place of a style branch."""
    from univst_tpu.models.mmdit import extract_mmdit_style_kv as j_extract
    from univst_torch.models.mmdit import extract_mmdit_style_kv

    jm, params, tm = _mmdits(form)
    sx, sctx_in, spooled = _inputs(1, 1)
    sx = sx[:1]
    _, state = jm.apply({"params": params}, jnp.asarray(sx), jnp.asarray(300.0),
                        jnp.asarray(sctx_in), jnp.asarray(spooled), _jvctx(1),
                        jlayers.StyleCtx(step_idx=3, cfg=J_SHIFT, capture=True),
                        mutable=["pnp_kv"])
    jkv = j_extract(state["pnp_kv"])
    cap = StyleCtx(step_idx=3, cfg=SD3_STYLE_SHIFT, capture=True)
    with torch.no_grad():
        tm(torch.tensor(sx), 300.0, torch.tensor(sctx_in), torch.tensor(spooled), _tvctx(1), cap)
    tkv = extract_mmdit_style_kv(cap.captured)
    assert len(tkv["joint"]) == 2 and len(tkv["dual"]) == len(jkv["dual"])
    for kind in ("joint", "dual"):
        for (tk, tv), (wk, wv) in zip(tkv[kind], jkv[kind]):
            assert tk.shape == wk.shape == (1, 16, 2, 16)  # token-major [1, L, H, dh]
            assert rel_err(tk, wk) < 1e-4 and rel_err(tv, wv) < 1e-4

    x, ctx, pooled = _inputs(2, 2)
    want, _ = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(300.0), jnp.asarray(ctx),
                       jnp.asarray(pooled), _jvctx(F),
                       jlayers.StyleCtx(step_idx=3, cfg=J_SHIFT, style_kv=jkv))
    with torch.no_grad():
        got, _ = tm(torch.tensor(x), 300.0, torch.tensor(ctx), torch.tensor(pooled), _tvctx(F),
                    StyleCtx(step_idx=3, cfg=SD3_STYLE_SHIFT, style_kv=tkv))
    assert rel_err(got, want) < 1e-4


def test_pos_embed_is_the_formula_whatever_the_checkpoint_holds():
    """The persisted ``pos_embed.pos_embed`` (zeros in the synthetic
    checkpoints) is replaced by the fixed table on load, as the JAX
    converter discards it; a wrong shape raises."""
    from univst_tpu.models.mmdit import sincos_pos_embed_2d as j_sincos
    from univst_torch.models.mmdit import MMDiT, MMDiTConfig, sincos_pos_embed_2d

    np.testing.assert_array_equal(sincos_pos_embed_2d(32, 6, 5), j_sincos(32, 6, 5))
    m = MMDiT(MMDiTConfig.tiny())
    table = m.pos_embed.pos_embed.clone()
    sd = m.state_dict()
    sd["pos_embed.pos_embed"] = torch.zeros_like(table)
    m.load_state_dict(sd, strict=True)
    torch.testing.assert_close(m.pos_embed.pos_embed, table, atol=0, rtol=0)
    sd["pos_embed.pos_embed"] = torch.zeros(1, 4, 32)
    with pytest.raises(ValueError, match="pos_embed"):
        m.load_state_dict(sd, strict=True)
