"""Shared fixtures of the PyTorch port's parity tests: tiny JAX modules with
their params, and the same weights carried into the port's modules through
``univst_torch.models.convert`` with a strict load.

Two things keep these tests inside the suite's clock on a CPU shared by
several pytest-xdist workers:
  * each worker's torch intra-op pool gets the worker's share of the cores
    (importing this module sets it; with torch's default of every core per
    process, six workers oversubscribe eight cores and a torch-only test
    runs ~20x slower);
  * :func:`seeded_init` stands in for Flax's random init: XLA takes 1-2
    minutes on the CPU to compile the init graph of one tiny UNet, while
    the parity tests need only some weights, the same on both sides.
"""

from __future__ import annotations

import contextlib
import functools
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import torch

from univst_torch.models import convert as tcv

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))


def fill_params(shapes, rng: np.random.Generator):
    """Numpy params for a tree of ``jax.ShapeDtypeStruct`` leaves in the
    families of the JAX package's init: kernels and embeddings lecun-normal
    (a normal truncated at 2 sigma, variance 1 / fan-in; fan-in is every
    axis but the last), biases 0, norm scales 1, blend factors 0.5."""
    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "bias":
            return np.zeros(s.shape, s.dtype)
        if name == "scale":
            return np.ones(s.shape, s.dtype)
        if name == "mix_factor":
            return np.full(s.shape, 0.5, s.dtype)
        x = rng.standard_normal(s.shape)
        while (out := np.abs(x) > 2.0).any():
            x[out] = rng.standard_normal(int(out.sum()))
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 1
        # 0.8796: the std of a unit normal truncated at 2 sigma
        return (x / 0.87962566103423978 / np.sqrt(fan_in)).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@contextlib.contextmanager
def seeded_init(seed: int = 0):
    """Within this block, Flax's ``Module.init`` returns :func:`fill_params`
    weights (numpy draws from ``seed``, one stream for all the inits in
    the block, in call order) of the shapes the real init would give
    (``jax.eval_shape``, no compile). A JAX package build function called inside
    it builds its modules as always and skips only the random init."""
    rng = np.random.default_rng(seed)
    real = nn.Module.init

    def init(self, rngs, *args, **kwargs):
        arrays = [i for i, a in enumerate(args) if hasattr(a, "shape")]

        def abstract(rngs, *arr):
            full = list(args)
            for i, a in zip(arrays, arr):
                full[i] = a
            return real(self, rngs, *full, **kwargs)

        return fill_params(jax.eval_shape(abstract, rngs, *[args[i] for i in arrays]), rng)

    nn.Module.init = init
    try:
        yield
    finally:
        nn.Module.init = real


SD21_TINY_CTX = 48  # the tiny context width (SD-2.1: 1024, SD-1.5: 768; SD-1.5-tiny: 32)


def sd21_tiny_configs(unet_mod, clip_mod):
    """SD-2.1's topology at tiny widths in one package's config classes
    (``unet_sd``, ``clip_text``): linear ``proj_in`` / ``proj_out``, heads
    of 16 at every level, a GELU CLIP of width ``SD21_TINY_CTX``."""
    unet = unet_mod.UNetSDConfig(block_out_channels=(32, 64, 64, 64), num_heads=(2, 4, 4, 4),
                                 cross_attention_dim=SD21_TINY_CTX, norm_num_groups=8,
                                 use_linear_projection=True, temporal_identity=True)
    clip = clip_mod.CLIPTextConfig(hidden_size=SD21_TINY_CTX, num_layers=2, num_heads=3,
                                   intermediate_size=2 * SD21_TINY_CTX, hidden_act="gelu")
    return unet, clip


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def t(x, dtype=torch.float32):
    """numpy / jax array -> torch CPU tensor (a copy)."""
    return torch.tensor(np.asarray(x), dtype=dtype)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


@functools.lru_cache(maxsize=None)
def jax_unet(f: int = 4, hw: int = 8, capture_up_block=2, seed: int = 0):
    from univst_tpu.core.config import SD_BASE_FRAME_INDICES
    from univst_tpu.models.layers import VideoCtx
    from univst_tpu.models.unet_sd import UNetPseudo3D, UNetSDConfig

    cfg = UNetSDConfig.tiny(temporal_identity=True, capture_up_block=capture_up_block)
    unet = UNetPseudo3D(cfg, dtype=jnp.float32)
    vctx = VideoCtx(num_frames=f, frame_indices=SD_BASE_FRAME_INDICES)
    with seeded_init(seed):
        params = unet.init(jax.random.PRNGKey(seed), jnp.zeros((f, hw, hw, 4)),
                           jnp.asarray(0), jnp.zeros((1, 77, 32)), vctx)["params"]
    return unet, to_np(params), cfg


def torch_unet(params, cfg):
    from univst_torch.models.unet_sd import UNetPseudo3D, UNetSDConfig

    tcfg = UNetSDConfig.tiny(capture_up_block=cfg.capture_up_block)
    m = UNetPseudo3D(tcfg).eval()
    m.load_state_dict(tcv.to_torch_state_dict(tcv.flax_unet_to_state_dict(params, cfg)),
                      strict=True)
    return m


@functools.lru_cache(maxsize=None)
def jax_vae(f: int = 4, seed: int = 1):
    from univst_tpu.models.vae import AutoencoderKL, VAEConfig

    cfg = VAEConfig.tiny(temporal_decoder=True)
    vae = AutoencoderKL(cfg, dtype=jnp.float32)
    with seeded_init(seed):
        params = vae.init(jax.random.PRNGKey(seed), jnp.zeros((f, 32, 32, 3)), f)["params"]
    return vae, to_np(params), cfg


def torch_vae(params, cfg):
    from univst_torch.models.vae import AutoencoderKL, VAEConfig

    m = AutoencoderKL(VAEConfig.tiny(temporal_decoder=True)).eval()
    m.load_state_dict(tcv.to_torch_state_dict(tcv.flax_vae_to_state_dict(params, cfg)),
                      strict=True)
    return m


@functools.lru_cache(maxsize=None)
def jax_clip(seed: int = 2):
    from univst_tpu.models.clip_text import CLIPTextConfig, CLIPTextModel

    cfg = CLIPTextConfig.tiny()
    model = CLIPTextModel(cfg, dtype=jnp.float32)
    with seeded_init(seed):
        params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 77), jnp.int32))["params"]
    return model, to_np(params), cfg


def torch_clip(params, cfg):
    from univst_torch.models.clip_text import CLIPTextConfig, CLIPTextModel

    m = CLIPTextModel(CLIPTextConfig.tiny()).eval()
    m.load_state_dict(tcv.to_torch_state_dict(tcv.flax_clip_to_state_dict(params, cfg)),
                      strict=True)
    return m
