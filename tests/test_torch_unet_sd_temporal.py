"""The SD UNet's inflated form (``UNetSDConfig(temporal_identity=False)``:
a dirac-initialized temporal tap after every 3x3 conv and a zero-output
temporal attention after every transformer block's FF) against the JAX
package's, on the tiny config (4 frames, 8x8 latents, fp32, CPU), with the
temporal weights carried across under the reference's key names
(``*.conv_temporal``, ``transformer_blocks.0.{attn,norm}_temporal``).

``init``: the temporal layers at their init, where the inflated model is
the 2D one (held against the port's elided form too); ``trained``: every
temporal tap and temporal ``to_out`` drawn from a numpy seed, so both reach
the output.

Tolerance: relative 1e-3 of the max for the whole UNet against JAX (as
``test_torch_unet_ad.py``); 1e-5 between the port's two forms at init.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import rel_err, t, to_np
from univst_torch.models import convert as tcv

F, HW = 4, 8


def _train_temporal(tree, rng):
    """The params with every temporal conv tap (dirac + noise) and every
    temporal attention's to_out (zero at init) drawn from ``rng``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            v = _train_temporal(v, rng)
            if k == "temporal":
                v = {**v, "kernel": v["kernel"] + 0.2 * rng.standard_normal(
                    v["kernel"].shape).astype(np.float32)}
            elif k == "attn_temporal":
                kern = v["to_out"]["kernel"]
                v = {**v, "to_out": {**v["to_out"], "kernel": (rng.standard_normal(kern.shape)
                                                               / np.sqrt(kern.shape[0])
                                                               ).astype(np.float32)}}
        out[k] = v
    return out


@pytest.fixture(scope="module")
def jax_inflated():
    from univst_tpu.core.config import SD_BASE_FRAME_INDICES
    from univst_tpu.models.layers import VideoCtx
    from univst_tpu.models.unet_sd import UNetPseudo3D, UNetSDConfig

    cfg = UNetSDConfig.tiny(temporal_identity=False, capture_up_block=2)
    unet = UNetPseudo3D(cfg, dtype=jnp.float32)
    params = jax.jit(unet.init, static_argnums=4)(
        jax.random.PRNGKey(0), jnp.zeros((F, HW, HW, 4)), jnp.asarray(0),
        jnp.zeros((1, 77, 32)), VideoCtx(num_frames=F, frame_indices=SD_BASE_FRAME_INDICES))
    return unet, to_np(params["params"]), cfg


@pytest.mark.parametrize("weights", ["init", "trained"])
def test_inflated_sd_unet_matches_jax(jax_inflated, weights):
    from univst_tpu.core.config import SD_BASE_FRAME_INDICES
    from univst_tpu.models.layers import VideoCtx as JVideoCtx
    from univst_torch.models.layers import VideoCtx
    from univst_torch.models.unet_sd import UNetPseudo3D, UNetSDConfig

    unet, params, cfg = jax_inflated
    if weights == "trained":
        params = _train_temporal(params, np.random.default_rng(1))
    sd = tcv.flax_unet_to_state_dict(params, cfg)
    assert any(k.endswith("conv1.conv_temporal.weight") for k in sd)
    assert any(".attn_temporal.to_out.0." in k for k in sd)
    m = UNetPseudo3D(UNetSDConfig.tiny(temporal_identity=False, capture_up_block=2)).eval()
    m.load_state_dict(tcv.to_torch_state_dict(sd), strict=True)

    rng = np.random.default_rng(2)
    x = rng.standard_normal((F, HW, HW, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 77, 32)).astype(np.float32)
    want, want_feat = jax.jit(unet.apply)({"params": params}, jnp.asarray(x), jnp.asarray(301),
                                          jnp.asarray(ctx), JVideoCtx(F, SD_BASE_FRAME_INDICES))
    vctx = VideoCtx(F, SD_BASE_FRAME_INDICES)
    with torch.no_grad():
        got, got_feat = m(t(x), 301, t(ctx), vctx)
    assert rel_err(got, want) < 1e-3 and rel_err(got_feat, want_feat) < 1e-3
    if weights == "init":  # the temporal layers are identities: the elided form's output
        flat = UNetPseudo3D(UNetSDConfig.tiny(capture_up_block=2)).eval()
        flat.load_state_dict({k: v for k, v in m.state_dict().items() if "_temporal" not in k},
                             strict=True)
        with torch.no_grad():
            plain, _ = flat(t(x), 301, t(ctx), vctx)
        assert rel_err(got, plain) < 1e-5
