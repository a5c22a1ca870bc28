"""Weights carried into the port.

Two directions meet here:
  * ``flax_*_to_state_dict`` turn the JAX package's Flax param trees (nested
    dicts of numpy arrays) into the port's state dicts. The port's module
    names follow the diffusers/transformers keys, so these are the keys the
    released checkpoints use (and that ``univst_tpu/models/synth_ckpt.py``
    emits). The layout transforms are the inverse of the JAX package's
    converters: linear ``[in, out]`` -> ``[out, in]``, NHWC conv
    ``[kh, kw, in, out]`` -> ``[out, in, kh, kw]``.
  * :func:`load_pretrained` reads a diffusers-layout checkpoint directory
    (``unet/``, ``vae/``, ``text_encoder/``) and loads it with
    ``strict=True``, so a missing or unexpected key fails loudly.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch


class _Emitter:
    """Walks a Flax param tree and emits torch-layout key/value pairs."""

    def __init__(self, params: Mapping):
        self.params = params
        self.out: Dict[str, np.ndarray] = {}

    def _node(self, path: str):
        node = self.params
        for p in path.split("/"):
            if not isinstance(node, Mapping) or p not in node:
                return None
            node = node[p]
        return node

    def has(self, path: str) -> bool:
        return self._node(path) is not None

    def leaf(self, path: str) -> np.ndarray:
        node = self._node(path)
        if node is None or getattr(node, "shape", None) is None:
            raise KeyError(f"flax params have no leaf {path}")
        return np.asarray(node, dtype=np.float32)

    def put(self, key: str, value: np.ndarray):
        if key in self.out:
            raise ValueError(f"duplicate torch key {key}")
        self.out[key] = np.ascontiguousarray(value)

    def linear(self, src: str, dst: str, bias: bool = True):
        self.put(src + ".weight", self.leaf(dst + "/kernel").T)  # [in, out] -> [out, in]
        if bias:
            self.put(src + ".bias", self.leaf(dst + "/bias"))

    def conv2d(self, src: str, dst: str):
        # [kh, kw, in, out] -> [out, in, kh, kw]
        self.put(src + ".weight", np.transpose(self.leaf(dst + "/kernel"), (3, 2, 0, 1)))
        self.put(src + ".bias", self.leaf(dst + "/bias"))

    def conv_time(self, src: str, dst: str):
        # frame-axis conv [3, 1, in, out] -> Conv3d [out, in, 3, 1, 1]
        k = self.leaf(dst + "/kernel")
        self.put(src + ".weight", np.transpose(k[:, 0], (2, 1, 0))[..., None, None])
        self.put(src + ".bias", self.leaf(dst + "/bias"))

    def norm(self, src: str, dst: str):
        self.put(src + ".weight", self.leaf(dst + "/scale"))
        self.put(src + ".bias", self.leaf(dst + "/bias"))


def _unet_transformer(e: _Emitter, src: str, dst: str, use_linear: bool):
    e.norm(f"{src}.norm", f"{dst}/norm")
    for p in ("proj_in", "proj_out"):
        if use_linear:
            e.linear(f"{src}.{p}", f"{dst}/{p}")
        else:  # 1x1 conv applied as a dense layer: [in, out] -> [out, in, 1, 1]
            e.put(f"{src}.{p}.weight", e.leaf(f"{dst}/{p}/kernel").T[:, :, None, None])
            e.put(f"{src}.{p}.bias", e.leaf(f"{dst}/{p}/bias"))
    blk_s, blk_d = f"{src}.transformer_blocks.0", f"{dst}/block"
    for attn in ("attn1", "attn2"):
        for p in ("to_q", "to_k", "to_v"):
            e.linear(f"{blk_s}.{attn}.{p}", f"{blk_d}/{attn}/{p}", bias=False)
        e.linear(f"{blk_s}.{attn}.to_out.0", f"{blk_d}/{attn}/to_out")
    for ln in ("norm1", "norm2", "norm3"):
        e.norm(f"{blk_s}.{ln}", f"{blk_d}/{ln}")
    e.linear(f"{blk_s}.ff.net.0.proj", f"{blk_d}/ff/proj")
    e.linear(f"{blk_s}.ff.net.2", f"{blk_d}/ff/out")


def _unet_resnet(e: _Emitter, src: str, dst: str):
    e.norm(f"{src}.norm1", f"{dst}/norm1")
    e.conv2d(f"{src}.conv1", f"{dst}/conv1/spatial")
    e.linear(f"{src}.time_emb_proj", f"{dst}/time_emb_proj")
    e.norm(f"{src}.norm2", f"{dst}/norm2")
    e.conv2d(f"{src}.conv2", f"{dst}/conv2/spatial")
    if e.has(f"{dst}/conv_shortcut/spatial/kernel"):
        e.conv2d(f"{src}.conv_shortcut", f"{dst}/conv_shortcut/spatial")


def flax_unet_to_state_dict(params: Mapping, cfg) -> Dict[str, np.ndarray]:
    """The JAX ``UNetPseudo3D`` params (temporal layers elided) as a
    diffusers ``UNet2DConditionModel`` state dict."""
    e = _Emitter(params)
    n = len(cfg.block_out_channels)
    lin = cfg.use_linear_projection
    e.conv2d("conv_in", "conv_in/spatial")
    e.linear("time_embedding.linear_1", "time_embedding/linear_1")
    e.linear("time_embedding.linear_2", "time_embedding/linear_2")
    for i in range(n):
        for j in range(cfg.layers_per_block):
            _unet_resnet(e, f"down_blocks.{i}.resnets.{j}", f"down_{i}/resnet_{j}")
            if cfg.down_block_has_attn[i]:
                _unet_transformer(e, f"down_blocks.{i}.attentions.{j}", f"down_{i}/attn_{j}", lin)
        if i < n - 1:
            e.conv2d(f"down_blocks.{i}.downsamplers.0.conv", f"down_{i}/downsample/spatial")
    _unet_resnet(e, "mid_block.resnets.0", "mid/resnet_0")
    _unet_resnet(e, "mid_block.resnets.1", "mid/resnet_1")
    _unet_transformer(e, "mid_block.attentions.0", "mid/attn_0", lin)
    for i in range(n):
        for j in range(cfg.layers_per_block + 1):
            _unet_resnet(e, f"up_blocks.{i}.resnets.{j}", f"up_{i}/resnet_{j}")
            if cfg.up_block_has_attn[i]:
                _unet_transformer(e, f"up_blocks.{i}.attentions.{j}", f"up_{i}/attn_{j}", lin)
        if i < n - 1:
            e.conv2d(f"up_blocks.{i}.upsamplers.0.conv", f"up_{i}/upsample/spatial")
    e.norm("conv_norm_out", "conv_norm_out")
    e.conv2d("conv_out", "conv_out/spatial")
    return e.out


def _vae_resnet(e: _Emitter, src: str, dst: str):
    e.norm(f"{src}.norm1", f"{dst}/norm1")
    e.conv2d(f"{src}.conv1", f"{dst}/conv1")
    e.norm(f"{src}.norm2", f"{dst}/norm2")
    e.conv2d(f"{src}.conv2", f"{dst}/conv2")
    if e.has(f"{dst}/conv_shortcut/kernel"):
        e.conv2d(f"{src}.conv_shortcut", f"{dst}/conv_shortcut")


def _vae_temporal_resnet(e: _Emitter, src: str, dst: str):
    e.norm(f"{src}.norm1", f"{dst}/norm1")
    e.conv_time(f"{src}.conv1", f"{dst}/conv1")
    e.norm(f"{src}.norm2", f"{dst}/norm2")
    e.conv_time(f"{src}.conv2", f"{dst}/conv2")
    if e.has(f"{dst}/conv_shortcut/kernel"):  # [in, out] -> [out, in, 1, 1, 1]
        e.put(f"{src}.conv_shortcut.weight",
              e.leaf(f"{dst}/conv_shortcut/kernel").T[..., None, None, None])
        e.put(f"{src}.conv_shortcut.bias", e.leaf(f"{dst}/conv_shortcut/bias"))


def _vae_attention(e: _Emitter, src: str, dst: str):
    e.norm(f"{src}.group_norm", f"{dst}/norm")
    for p in ("to_q", "to_k", "to_v"):
        e.linear(f"{src}.{p}", f"{dst}/{p}")
    e.linear(f"{src}.to_out.0", f"{dst}/to_out")


def flax_vae_to_state_dict(params: Mapping, cfg) -> Dict[str, np.ndarray]:
    """The JAX ``AutoencoderKL`` params as a diffusers
    ``AutoencoderKL(TemporalDecoder)`` state dict."""
    e = _Emitter(params)
    n = len(cfg.block_out_channels)
    e.conv2d("encoder.conv_in", "encoder/conv_in")
    for i in range(n):
        for j in range(cfg.layers_per_block):
            _vae_resnet(e, f"encoder.down_blocks.{i}.resnets.{j}", f"encoder/down_{i}_res_{j}")
        if i < n - 1:
            e.conv2d(f"encoder.down_blocks.{i}.downsamplers.0.conv", f"encoder/down_{i}_conv")
    _vae_resnet(e, "encoder.mid_block.resnets.0", "encoder/mid_res_0")
    _vae_attention(e, "encoder.mid_block.attentions.0", "encoder/mid_attn")
    _vae_resnet(e, "encoder.mid_block.resnets.1", "encoder/mid_res_1")
    e.norm("encoder.conv_norm_out", "encoder/norm_out")
    e.conv2d("encoder.conv_out", "encoder/conv_out")
    e.conv2d("quant_conv", "encoder/quant_conv")

    e.conv2d("decoder.conv_in", "decoder/conv_in")
    temporal = cfg.temporal_decoder

    def dec_res(src, dst):
        if temporal:
            _vae_resnet(e, f"{src}.spatial_res_block", f"{dst}/spatial")
            _vae_temporal_resnet(e, f"{src}.temporal_res_block", f"{dst}/temporal")
            e.put(f"{src}.time_mixer.mix_factor", e.leaf(f"{dst}/time_mixer/mix_factor").reshape(()))
        else:
            _vae_resnet(e, src, dst)

    dec_res("decoder.mid_block.resnets.0", "decoder/mid_res_0")
    _vae_attention(e, "decoder.mid_block.attentions.0", "decoder/mid_attn")
    dec_res("decoder.mid_block.resnets.1", "decoder/mid_res_1")
    for i in range(n):
        for j in range(cfg.layers_per_block + 1):
            dec_res(f"decoder.up_blocks.{i}.resnets.{j}", f"decoder/up_{i}_res_{j}")
        if i < n - 1:
            e.conv2d(f"decoder.up_blocks.{i}.upsamplers.0.conv", f"decoder/up_{i}_conv")
    e.norm("decoder.conv_norm_out", "decoder/norm_out")
    e.conv2d("decoder.conv_out", "decoder/conv_out")
    if temporal:
        e.conv_time("decoder.time_conv_out", "decoder/time_conv_out")
    else:
        e.conv2d("post_quant_conv", "decoder/post_quant_conv")
    return e.out


def flax_clip_to_state_dict(params: Mapping, cfg) -> Dict[str, np.ndarray]:
    """The JAX ``CLIPTextModel`` params as a transformers ``CLIPTextModel``
    state dict (with the persisted ``position_ids`` buffer)."""
    e = _Emitter(params)
    pre = "text_model."
    e.put(pre + "embeddings.token_embedding.weight", e.leaf("token_embedding/embedding"))
    e.put(pre + "embeddings.position_embedding.weight", e.leaf("position_embedding"))
    e.put(pre + "embeddings.position_ids", np.arange(cfg.max_positions, dtype=np.int64)[None])
    for i in range(cfg.num_layers):
        s, d = f"{pre}encoder.layers.{i}", f"layer_{i}"
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            e.linear(f"{s}.self_attn.{p}", f"{d}/self_attn/{p}")
        e.norm(f"{s}.layer_norm1", f"{d}/layer_norm1")
        e.norm(f"{s}.layer_norm2", f"{d}/layer_norm2")
        e.linear(f"{s}.mlp.fc1", f"{d}/fc1")
        e.linear(f"{s}.mlp.fc2", f"{d}/fc2")
    e.norm(pre + "final_layer_norm", "final_layer_norm")
    if cfg.projection_dim is not None:
        e.linear("text_projection", "text_projection", bias=False)
    return e.out


def to_torch_state_dict(sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _find_weights(dirpath: str) -> Optional[str]:
    for pat in ("*.safetensors", "*.bin", "*.pt"):
        hits = sorted(glob.glob(os.path.join(dirpath, pat)))
        if hits:
            return hits[0]
    return None


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """A .safetensors / .bin / .pt weights file as a dict of CPU tensors."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return dict(load_file(path))
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd.get("state_dict", sd)


def load_pretrained(path: str, unet=None, vae=None, text_encoder=None) -> None:
    """Load ``{path}/unet``, ``{path}/vae`` and ``{path}/text_encoder`` into
    the given modules with ``strict=True`` (diffusers/transformers layout,
    as ``scripts/make_synthetic_checkpoints.py`` writes it). A module whose
    folder is missing raises."""
    for sub, module in (("unet", unet), ("vae", vae), ("text_encoder", text_encoder)):
        if module is None:
            continue
        weights = _find_weights(os.path.join(path, sub))
        if weights is None:
            raise FileNotFoundError(f"no weights file under {os.path.join(path, sub)}")
        module.load_state_dict(load_state_dict_file(weights), strict=True)
