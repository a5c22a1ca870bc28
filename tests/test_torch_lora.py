"""Live LoRA in the port (``univst_torch.models.lora``): the cases of
``tests/test_lora.py`` on the port, and the port against the JAX package.

The base weights are a synthetic diffusers-layout tiny SD UNet checkpoint
and the LoRA targets a few attention projections
(``tests/test_lora.py::_synthetic_lora``): the JAX package's ``merge_lora``
raises on conv, feed-forward and text-encoder LoRAs (ROADMAP queue 3), so
the JAX side holds only attention / linear LoRAs.

Tolerances: the live weights equal the merge path's to rtol 1e-5, atol 1e-6
(``merge(base, lora, 1) - base`` then ``base + alpha * delta`` against
``base + alpha * up @ down``, fp32); the deltas of the two packages to 1e-6
(the same numpy arithmetic); scale 0 and the inert adapter exactly; the
UNet forward with the adapted weights to 1e-4 of the output's max (fp32,
two frameworks, the sums in other orders).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import rel_err, t
from tests.test_convert import _synthetic_sd_unet_sd
from tests.test_lora import _synthetic_lora
from univst_tpu.models import convert as jcv
from univst_tpu.models import lora as jlora
from univst_tpu.models.unet_sd import UNetSDConfig as JUNetCfg
from univst_torch.models import convert as tcv
from univst_torch.models.convert_ldm import merge_lora
from univst_torch.models.lora import LoRALinearLayer, apply_lora, lora_delta_state_dict

JCFG = JUNetCfg.tiny(temporal_identity=True)
ALPHA = 0.37


def _weights(seed):
    """(base diffusers state dict with every weight at 1/sqrt(fan-in) scale,
    LoRA on it)."""
    rng = np.random.default_rng(seed)
    base = _synthetic_sd_unet_sd(JCFG, rng)
    # the synthetic checkpoint's unit-normal weights blow activations up by
    # sqrt(fan-in) a layer; at lecun scale the forward stays well-conditioned
    base = {k: (v / np.sqrt(np.prod(v.shape[1:])) if v.ndim > 1 else v).astype(np.float32)
            for k, v in base.items()}
    return base, _synthetic_lora(base, rng)


@functools.lru_cache(maxsize=None)
def _unet(seed):
    from univst_torch.models.unet_sd import UNetPseudo3D, UNetSDConfig

    base, lora = _weights(seed)
    m = UNetPseudo3D(UNetSDConfig.tiny()).eval()
    m.load_state_dict(tcv.to_torch_state_dict(base), strict=True)
    return m, base, lora


def test_live_lora_matches_merge_path():
    m, base, lora = _unet(0)
    merged = merge_lora(base, lora, alpha=ALPHA)
    live = apply_lora(m, lora_delta_state_dict(m.state_dict(), lora), scale=ALPHA)
    own = m.state_dict()
    changed = 0
    for k, want in merged.items():
        got = live.get(k, own[k]).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=k)
        changed += int(np.abs(want - base[k]).max() > 0)
    assert changed >= 6  # the adapted projections actually moved


def test_apply_lora_scale_zero_is_identity():
    m, _, lora = _unet(1)
    own = m.state_dict()
    out = apply_lora(m, lora_delta_state_dict(own, lora), scale=0.0)
    assert out
    for k, v in out.items():
        assert torch.equal(v, own[k]), k


def test_lora_linear_layer_inert_at_init():
    torch.manual_seed(0)
    layer = LoRALinearLayer(8, 8, rank=2)
    x = torch.tensor(np.random.default_rng(2).standard_normal((3, 5, 8)), dtype=torch.float32)
    assert torch.equal(layer(x), torch.zeros(3, 5, 8))  # zero-init up
    # with a nonzero up weight it gives the rank-factorized delta
    with torch.no_grad():
        layer.up.weight.fill_(1.0)
    want = (x @ layer.down.weight.T) @ layer.up.weight.T
    torch.testing.assert_close(layer(x), want, rtol=1e-5, atol=0)
    assert LoRALinearLayer(3, 16, rank=4).down.out_features == 3  # rank clamped


def test_delta_matches_the_jax_package():
    """JAX ``lora_delta_params`` (a Flax tree) carried through
    ``flax_unet_to_state_dict`` equals the port's delta on the keys the LoRA
    changes, and is zero elsewhere."""
    m, base, lora = _unet(2)
    mine = lora_delta_state_dict(m.state_dict(), lora)
    tree = jlora.lora_delta_params(base, lora, functools.partial(jcv.convert_sd_unet, cfg=JCFG))
    theirs = tcv.flax_unet_to_state_dict(tree, JCFG)
    assert sorted(theirs) == sorted(m.state_dict())
    assert len(mine) == len(lora) // 2
    for k, want in theirs.items():
        got = mine[k].numpy() if k in mine else np.zeros_like(want)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=k)


def test_adapted_unet_forward_matches_jax():
    """The tiny SD UNet with the adapted weights (``functional_call``)
    against the JAX UNet on ``apply_lora``'d params, same inputs."""
    from univst_tpu.core.config import SD_BASE_FRAME_INDICES
    from univst_tpu.models.layers import VideoCtx as JVideoCtx
    from univst_tpu.models.unet_sd import UNetPseudo3D as JUNet
    from univst_torch.models.layers import VideoCtx

    m, base, lora = _unet(3)
    f = 2
    rng = np.random.default_rng(4)
    x = rng.standard_normal((f, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 77, 32)).astype(np.float32)
    convert = functools.partial(jcv.convert_sd_unet, cfg=JCFG)
    jparams = jlora.apply_lora(convert(base), jlora.lora_delta_params(base, lora, convert),
                               scale=ALPHA)
    want, _ = jax.jit(JUNet(JCFG, dtype=jnp.float32).apply)(
        {"params": jparams}, jnp.asarray(x), jnp.asarray(301), jnp.asarray(ctx),
        JVideoCtx(f, SD_BASE_FRAME_INDICES))
    adapted = apply_lora(m, lora_delta_state_dict(m.state_dict(), lora), scale=ALPHA)
    with torch.no_grad():
        got, _ = torch.func.functional_call(
            m, adapted, (t(x), 301, t(ctx), VideoCtx(f, SD_BASE_FRAME_INDICES)))
        plain, _ = m(t(x), 301, t(ctx), VideoCtx(f, SD_BASE_FRAME_INDICES))
    assert got.shape == want.shape and rel_err(got, want) < 1e-4
    assert rel_err(plain, want) > 1e-3  # the adapter moved the output
    assert m.state_dict()[next(iter(adapted))].equal(t(base[next(iter(adapted))]))
