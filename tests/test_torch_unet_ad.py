"""Parity of the port's AnimateDiff UNet with the JAX package's, on the tiny
config (4 frames, 8x8 latents = 64 px, fp32, CPU): a frame-axis attention
with positions, a motion module, and the whole UNet in its four attention
modes (plain, plain shift on the 3-branch batch, capture, inject with
per-frame style K/V) plus the captured feature and the SparseControlNet
residuals. The JAX params come from one init; every motion module's
``proj_out`` (zero at init) is filled from a numpy seed so the temporal path
reaches the output, and the weights cross over with a strict load.

Tolerances, relative to the output's max: 1e-4 for one module, 1e-3 for
the whole UNet (two fp32 frameworks, ~80 layers summed in different orders).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import rel_err, t, to_np
from univst_torch.models import convert as tcv

F, HW = 4, 8
STEP = 10  # inside AnimateDiff's shift window (steps 0-24)


def _fill_proj_out(params, seed=3):
    """The params with every motion module's proj_out kernel drawn from a
    seeded normal (lecun scale) instead of zero."""
    rng = np.random.default_rng(seed)
    out = dict(params)
    for name, sub in params.items():
        if "motion" in name:
            k = sub["proj_out"]["kernel"]
            out[name] = {**sub, "proj_out": {**sub["proj_out"], "kernel": (
                rng.standard_normal(k.shape) / np.sqrt(k.shape[0])).astype(np.float32)}}
    return out


@functools.lru_cache(maxsize=None)
def jax_ad_unet():
    from univst_tpu.models.layers import VideoCtx
    from univst_tpu.models.unet_ad import UNetAnimateDiff, UNetADConfig

    cfg = UNetADConfig.tiny(capture_up_block=2)
    unet = UNetAnimateDiff(cfg, dtype=jnp.float32)
    params = jax.jit(unet.init, static_argnums=4)(
        jax.random.PRNGKey(0), jnp.zeros((F, HW, HW, 4)), jnp.asarray(0),
        jnp.zeros((1, 77, 32)), VideoCtx(num_frames=F, frame_indices=()))["params"]
    return unet, _fill_proj_out(to_np(params)), cfg


def torch_ad_unet(params, cfg):
    from univst_torch.models.unet_ad import UNetAnimateDiff, UNetADConfig

    m = UNetAnimateDiff(UNetADConfig.tiny(capture_up_block=cfg.capture_up_block)).eval()
    m.load_state_dict(tcv.to_torch_state_dict(tcv.flax_ad_unet_to_state_dict(params, cfg)),
                      strict=True)
    return m


@pytest.fixture(scope="module")
def unets():
    unet, params, cfg = jax_ad_unet()
    return unet, params, cfg, torch_ad_unet(params, cfg)


def _emit(fn, params, *args):
    """Emit one module's state dict with ``fn`` (a prefix "m" / param root
    "p"), keys relative to the module."""
    e = tcv._Emitter({"p": params})
    fn(e, "m", "p", *args)
    return tcv.to_torch_state_dict({k[2:]: v for k, v in e.out.items()})


def test_temporal_self_attention_pe_matches_jax():
    from univst_tpu.models.unet_ad import TemporalSelfAttentionPE as JAttn
    from univst_torch.models.unet_ad import TemporalSelfAttentionPE

    b, l, d = 2, 16, 32
    x = np.random.default_rng(1).standard_normal((b * F, l, d)).astype(np.float32)
    attn = JAttn(num_heads=2, pe_max_len=24)
    params = to_np(jax.jit(attn.init, static_argnums=2)(jax.random.PRNGKey(1),
                                                        jnp.asarray(x), F)["params"])
    want = jax.jit(attn.apply, static_argnums=2)({"params": params}, jnp.asarray(x), F)
    m = TemporalSelfAttentionPE(d, 2, 24).eval()
    m.load_state_dict(_emit(tcv._attention, params), strict=True)
    with torch.no_grad():
        got = m(t(x), F)
    assert rel_err(got, want) < 1e-4


def test_motion_module_matches_jax():
    from univst_tpu.models.layers import VideoCtx as JVideoCtx
    from univst_tpu.models.unet_ad import MotionModule as JMotion
    from univst_tpu.models.unet_ad import UNetADConfig as JCfg
    from univst_torch.models.layers import VideoCtx
    from univst_torch.models.unet_ad import MotionModule, UNetADConfig

    x = np.random.default_rng(2).standard_normal((2 * F, HW, HW, 64)).astype(np.float32)
    jm = JMotion(JCfg.tiny())
    params = to_np(jax.jit(jm.init, static_argnums=2)(jax.random.PRNGKey(2), jnp.asarray(x),
                                                      JVideoCtx(num_frames=F))["params"])
    params = _fill_proj_out({"motion": params})["motion"]
    want = jax.jit(jm.apply, static_argnums=2)({"params": params}, jnp.asarray(x),
                                               JVideoCtx(num_frames=F))
    m = MotionModule(64, UNetADConfig.tiny()).eval()
    m.load_state_dict(_emit(tcv._motion_module, params, UNetADConfig.tiny()), strict=True)
    with torch.no_grad():
        got = m(t(x).permute(0, 3, 1, 2), VideoCtx(num_frames=F)).permute(0, 2, 3, 1)
    assert rel_err(got, want) < 1e-4
    assert rel_err(got, x) > 1e-2  # the temporal path moved the output


def _skip_shapes(cfg, b):
    """The [B*F, h, w, C] shapes of the 12 skips and the mid state."""
    hw, boc = HW, cfg.block_out_channels
    shapes = [(b * F, hw, hw, boc[0])]
    for i, ch in enumerate(boc):
        shapes += [(b * F, hw, hw, ch)] * cfg.layers_per_block
        if i < len(boc) - 1:
            hw //= 2
            shapes.append((b * F, hw, hw, ch))
    return shapes, (b * F, hw, hw, boc[-1])


def _capture(unet, params, m, x, ctx):
    from univst_tpu.core.config import AD_STYLE_SHIFT as J_SHIFT
    from univst_tpu.models.layers import StyleCtx as JStyleCtx
    from univst_tpu.models.layers import VideoCtx as JVideoCtx
    from univst_tpu.models.unet_sd import extract_pnp_kv as j_extract
    from univst_torch.core.config import AD_STYLE_SHIFT
    from univst_torch.models.layers import StyleCtx, VideoCtx
    from univst_torch.models.unet_sd import extract_pnp_kv

    _, state = jax.jit(unet.apply, static_argnames="mutable")(
        {"params": params}, jnp.asarray(x), jnp.asarray(401), jnp.asarray(ctx),
        JVideoCtx(F, (), ()), JStyleCtx(step_idx=jnp.asarray(STEP), cfg=J_SHIFT, capture=True),
        mutable=("pnp_kv",))
    sctx = StyleCtx(step_idx=STEP, cfg=AD_STYLE_SHIFT, capture=True)
    with torch.no_grad():
        m(t(x), 401, t(ctx), VideoCtx(F, (), ()), sctx)
    return j_extract(state["pnp_kv"]), extract_pnp_kv(sctx.captured)


@pytest.mark.parametrize("mode", ["plain", "plain_shift", "capture", "inject", "controlnet"])
def test_unet_ad_matches_jax(unets, mode):
    """The whole UNet per attention mode; ``plain`` also holds the captured
    up-block feature, ``controlnet`` adds seeded residuals to every skip and
    the mid state."""
    from univst_tpu.core.config import AD_STYLE_SHIFT as J_SHIFT
    from univst_tpu.models.layers import StyleCtx as JStyleCtx
    from univst_tpu.models.layers import VideoCtx as JVideoCtx
    from univst_torch.core.config import AD_STYLE_SHIFT
    from univst_torch.models.layers import StyleCtx, VideoCtx

    unet, params, cfg, m = unets
    rng = np.random.default_rng(4)
    b = {"plain_shift": 3, "inject": 2}.get(mode, 1)
    x = rng.standard_normal((b * F, HW, HW, 4)).astype(np.float32)
    ctx = np.repeat(rng.standard_normal((1, 77, 32)).astype(np.float32), b, axis=0)
    if mode == "capture":
        want, got = _capture(unet, params, m, x, ctx)
        assert len(got) == len(want) == 8
        for (gk, gv), (wk, wv) in zip(got, want):
            assert gk.shape == wk.shape and gk.shape[0] == F
            assert rel_err(gk, wk) < 1e-3 and rel_err(gv, wv) < 1e-3
        return

    jsctx = tsctx = None
    jres = tres = None
    if mode == "plain_shift":
        jsctx = JStyleCtx(step_idx=jnp.asarray(STEP), cfg=J_SHIFT)
        tsctx = StyleCtx(step_idx=STEP, cfg=AD_STYLE_SHIFT)
    elif mode == "inject":  # per-frame [F, L, D] style K/V from a style-branch capture
        sty = rng.standard_normal((F, HW, HW, 4)).astype(np.float32)
        kv = [(np.asarray(k), np.asarray(v)) for k, v in _capture(unet, params, m, sty,
                                                                  ctx[:1])[0]]
        jsctx = JStyleCtx(step_idx=jnp.asarray(STEP), cfg=J_SHIFT,
                          style_kv=tuple((jnp.asarray(k), jnp.asarray(v)) for k, v in kv))
        tsctx = StyleCtx(step_idx=STEP, cfg=AD_STYLE_SHIFT,
                         style_kv=tuple((t(k), t(v)) for k, v in kv))
    elif mode == "controlnet":
        shapes, mid = _skip_shapes(cfg, b)
        down = [0.3 * rng.standard_normal(s).astype(np.float32) for s in shapes]
        mid_r = 0.3 * rng.standard_normal(mid).astype(np.float32)
        jres = (tuple(jnp.asarray(d) for d in down), jnp.asarray(mid_r))
        tres = ([t(d) for d in down], t(mid_r))
    want, want_feat = jax.jit(unet.apply)({"params": params}, jnp.asarray(x), jnp.asarray(301),
                                          jnp.asarray(ctx), JVideoCtx(F, (), ()), jsctx, jres)
    with torch.no_grad():
        got, got_feat = m(t(x), 301, t(ctx), VideoCtx(F, (), ()), tsctx, tres)
    assert got.shape == want.shape and rel_err(got, want) < 1e-3
    assert got_feat.shape == want_feat.shape == (F, HW, HW, 64)
    assert rel_err(got_feat, want_feat) < 1e-3
    if mode == "plain_shift":  # the shift touches the stylized branch only
        with torch.no_grad():
            plain, _ = m(t(x), 301, t(ctx), VideoCtx(F, (), ()))
        torch.testing.assert_close(got[:2 * F], plain[:2 * F], rtol=0, atol=0)
        assert rel_err(got[2 * F:], plain[2 * F:]) > 1e-4


def test_zero_proj_out_gives_the_per_frame_model():
    """With every motion module's proj_out at zero (the build's random init,
    as the reference initializes it) the video UNet acts per frame: a static
    video gives identical frames, each the single-frame output."""
    from univst_torch.models.layers import VideoCtx
    from univst_torch.pipelines.animatediff import build_animatediff

    m = build_animatediff(variant="tiny", num_frames=F, dtype=torch.float32, device="cpu").unet
    assert all(mm.temporal_transformer.proj_out.weight.abs().max() == 0
               for mm in m.motion_modules())
    rng = np.random.default_rng(5)
    frame = t(rng.standard_normal((1, HW, HW, 4)).astype(np.float32))
    ctx = t(rng.standard_normal((1, 77, 32)).astype(np.float32))
    with torch.no_grad():
        out, _ = m(frame.expand(F, -1, -1, -1), 301, ctx, VideoCtx(F, ()))
        one, _ = m(frame, 301, ctx, VideoCtx(1, ()))
    torch.testing.assert_close(out, out[:1].expand_as(out), rtol=0, atol=1e-5)
    torch.testing.assert_close(out[:1], one, rtol=0, atol=1e-5)


def test_more_frames_than_the_position_table_raise():
    from univst_torch.models.unet_ad import TemporalSelfAttentionPE

    m = TemporalSelfAttentionPE(8, 2, 24)
    m(torch.zeros(24, 3, 8), 24)
    with pytest.raises(ValueError, match="24"):
        m(torch.zeros(25, 3, 8), 25)
