"""Shared fixtures of the PyTorch port's parity tests: tiny JAX modules with
their params, and the same weights carried into the port's modules through
``univst_torch.models.convert`` with a strict load."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from univst_torch.models import convert as tcv


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
    params = jax.jit(unet.init)(jax.random.PRNGKey(seed), jnp.zeros((f, hw, hw, 4)),
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
    params = jax.jit(vae.init, static_argnums=2)(
        jax.random.PRNGKey(seed), jnp.zeros((f, 32, 32, 3)), f)["params"]
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
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 77), jnp.int32))["params"]
    return model, to_np(params), cfg


def torch_clip(params, cfg):
    from univst_torch.models.clip_text import CLIPTextConfig, CLIPTextModel

    m = CLIPTextModel(CLIPTextConfig.tiny()).eval()
    m.load_state_dict(tcv.to_torch_state_dict(tcv.flax_clip_to_state_dict(params, cfg)),
                      strict=True)
    return m
