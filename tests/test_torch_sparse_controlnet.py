"""The port's SparseControlNet (``univst_torch.models.sparse_controlnet``)
against the JAX package's, and its residuals in the port's AnimateDiff UNet.

The JAX params come from the JAX init (as the AD parity files keep it: on
the tiny config's 2-value GroupNorm groups the JAX variance cancels, and
its tolerance holds on that draw, ROADMAP queue 3), with every zero-init
conv (the conditioning embedding's ``conv_out``, every ``ctrl_*``
projection) and every motion module's ``proj_out`` filled from a numpy seed,
so the check compares no zeros and the temporal path counts. The weights
cross with one strict load (``convert.flax_sparse_controlnet_to_state_dict``).

Tolerance: 1e-3 of each residual's max (the AD UNet files' bar; fp32, the
encoder's ~40 layers summed in other orders). The UNet cases are the
counterparts of ``tests/test_unet_ad.py::test_sparse_controlnet_residuals``:
exact at zero init, a move of > 1e-4 with nonzero residuals.
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


def _fill(params, rng):
    """The params with each zero-init kernel drawn at lecun scale."""
    out = {}
    for name, sub in params.items():
        if name.startswith("ctrl_") or name in ("conv_out", "proj_out"):
            k = sub["kernel"]
            sub = {**sub, "kernel": (rng.standard_normal(k.shape)
                                     / np.sqrt(np.prod(k.shape[:-1]))).astype(np.float32)}
        elif isinstance(sub, dict):
            sub = _fill(sub, rng)
        out[name] = sub
    return out


def _inputs(seed):
    """Latents, timestep, text context, conditioning frames (frames 0 and 2
    conditioned, the rest 0) and their mask."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((F, HW, HW, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 77, 32)).astype(np.float32)
    on = np.array([1, 0, 1, 0], np.float32)[:, None, None, None]
    cond = rng.standard_normal((F, 2 * HW, 2 * HW, 3)).astype(np.float32) * on
    mask = np.broadcast_to(on, (F, HW, HW, 1)).astype(np.float32)
    return x, 301, ctx, cond, mask


@functools.lru_cache(maxsize=None)
def _jax_cnet():
    from univst_tpu.models.layers import VideoCtx
    from univst_tpu.models.sparse_controlnet import SparseControlNet, SparseControlNetConfig

    cfg = SparseControlNetConfig.tiny()
    cnet = SparseControlNet(cfg, dtype=jnp.float32)
    x, ts, ctx, cond, mask = _inputs(0)
    params = cnet.init(jax.random.PRNGKey(6), jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx),
                       jnp.asarray(cond), jnp.asarray(mask), VideoCtx(num_frames=F))["params"]
    return cnet, _fill(to_np(params), np.random.default_rng(7)), cfg


def test_sparse_controlnet_matches_jax():
    from univst_tpu.models.layers import VideoCtx as JVideoCtx
    from univst_torch.models.layers import VideoCtx
    from univst_torch.models.sparse_controlnet import SparseControlNet, SparseControlNetConfig

    cnet, params, jcfg = _jax_cnet()
    m = SparseControlNet(SparseControlNetConfig.tiny()).eval()
    m.load_state_dict(tcv.to_torch_state_dict(
        tcv.flax_sparse_controlnet_to_state_dict(params, jcfg)), strict=True)
    x, ts, ctx, cond, mask = _inputs(1)
    want_down, want_mid = jax.jit(cnet.apply, static_argnums=6)(
        {"params": params}, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx), jnp.asarray(cond),
        jnp.asarray(mask), JVideoCtx(num_frames=F), 0.7)
    with torch.no_grad():
        got_down, got_mid = m(t(x), ts, t(ctx), t(cond), t(mask), VideoCtx(F, ()),
                              conditioning_scale=0.7)
    assert len(got_down) == len(want_down) == 12
    for i, (g, w) in enumerate(zip(got_down + (got_mid,), tuple(want_down) + (want_mid,))):
        assert g.shape == w.shape, i
        assert np.abs(np.asarray(w)).max() > 0, i
        assert rel_err(g, w) < 1e-3, (i, rel_err(g, w))


@pytest.mark.parametrize("zero_init", [True, False])
def test_residuals_in_the_ad_unet(zero_init):
    """A freshly built (zero-init) SparseControlNet leaves the AD UNet's
    output exactly as it is; with its projections drawn, its residuals move
    the output."""
    from univst_torch.models.layers import VideoCtx
    from univst_torch.models.sparse_controlnet import SparseControlNet, SparseControlNetConfig
    from univst_torch.models.unet_ad import UNetAnimateDiff, UNetADConfig

    torch.manual_seed(0)
    unet = UNetAnimateDiff(UNetADConfig.tiny()).eval()
    cnet = SparseControlNet(SparseControlNetConfig.tiny()).eval()
    if not zero_init:
        with torch.no_grad():
            for conv in [*cnet.controlnet_down_blocks, cnet.controlnet_mid_block,
                         cnet.controlnet_cond_embedding.conv_out]:
                conv.weight.normal_(0, conv.weight[0].numel() ** -0.5)
    x, ts, ctx, cond, mask = (t(a) if isinstance(a, np.ndarray) else a for a in _inputs(2))
    vctx = VideoCtx(num_frames=F, frame_indices=())
    with torch.no_grad():
        res = cnet(x, ts, ctx, cond, mask, vctx)
        plain, _ = unet(x, ts, ctx, vctx)
        ctrl, _ = unet(x, ts, ctx, vctx, controlnet_residuals=res)
    if zero_init:
        assert all(r.abs().max() == 0 for r in res[0] + (res[1],))
        torch.testing.assert_close(ctrl, plain, rtol=0, atol=0)
    else:
        assert (ctrl - plain).abs().max().item() > 1e-4
