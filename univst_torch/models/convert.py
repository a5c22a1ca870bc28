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
    (``unet/``, ``vae/``, ``text_encoder/``; for SD3 ``transformer/``,
    ``vae/``, ``text_encoder/``, ``text_encoder_2/``, ``text_encoder_3/``)
    and loads it strictly, so a missing or unexpected key fails loudly. The
    one exception is AnimateDiff's motion modules, which a 2D ``unet/``
    checkpoint does not carry: :func:`load_motion_module` loads them from
    their own file. A folder may be sharded (its ``*.index.json`` maps each
    key to one of its files, as SD3-medium's ``text_encoder_3`` and
    SD3.5-large's ``transformer`` ship); ``.safetensors`` files are read by
    :mod:`univst_torch.utils.safetensors`.
"""

from __future__ import annotations

import glob
import json
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

    def conv1d(self, src: str, dst: str):
        # frame-axis conv [k, 1, in, out] -> Conv1d [out, in, k]
        self.put(src + ".weight", np.transpose(self.leaf(dst + "/kernel")[:, 0], (2, 1, 0)))
        self.put(src + ".bias", self.leaf(dst + "/bias"))

    def pseudo_conv(self, src: str, dst: str):
        """A pseudo-3D conv: the spatial conv under ``src``, and its temporal
        tap, where the params have one, under ``src.conv_temporal``. Params
        with no ``spatial`` level are a plain 2D conv (AnimateDiff)."""
        if not self.has(dst + "/spatial"):
            return self.conv2d(src, dst)
        self.conv2d(src, dst + "/spatial")
        if self.has(dst + "/temporal"):
            self.conv1d(src + ".conv_temporal", dst + "/temporal")

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
        _attention(e, f"{blk_s}.{attn}", f"{blk_d}/{attn}")
    for ln in ("norm1", "norm2", "norm3"):
        e.norm(f"{blk_s}.{ln}", f"{blk_d}/{ln}")
    e.linear(f"{blk_s}.ff.net.0.proj", f"{blk_d}/ff/proj")
    e.linear(f"{blk_s}.ff.net.2", f"{blk_d}/ff/out")
    if e.has(f"{blk_d}/attn_temporal"):  # the inflated SD UNet
        _attention(e, f"{blk_s}.attn_temporal", f"{blk_d}/attn_temporal")
        e.norm(f"{blk_s}.norm_temporal", f"{blk_d}/norm_temporal")


def _attention(e: _Emitter, src: str, dst: str):
    for p in ("to_q", "to_k", "to_v"):
        e.linear(f"{src}.{p}", f"{dst}/{p}", bias=False)
    e.linear(f"{src}.to_out.0", f"{dst}/to_out")


def _unet_resnet(e: _Emitter, src: str, dst: str):
    e.norm(f"{src}.norm1", f"{dst}/norm1")
    e.pseudo_conv(f"{src}.conv1", f"{dst}/conv1")
    e.linear(f"{src}.time_emb_proj", f"{dst}/time_emb_proj")
    e.norm(f"{src}.norm2", f"{dst}/norm2")
    e.pseudo_conv(f"{src}.conv2", f"{dst}/conv2")
    if e.has(f"{dst}/conv_shortcut"):
        e.pseudo_conv(f"{src}.conv_shortcut", f"{dst}/conv_shortcut")


def flax_unet_to_state_dict(params: Mapping, cfg) -> Dict[str, np.ndarray]:
    """The JAX ``UNetPseudo3D`` params as a diffusers ``UNet2DConditionModel``
    state dict; the inflated form's temporal layers (where the params have
    them) under the reference's names: ``*.conv_temporal``,
    ``transformer_blocks.0.{attn,norm}_temporal``."""
    e = _Emitter(params)
    n = len(cfg.block_out_channels)
    lin = cfg.use_linear_projection
    e.pseudo_conv("conv_in", "conv_in")
    e.linear("time_embedding.linear_1", "time_embedding/linear_1")
    e.linear("time_embedding.linear_2", "time_embedding/linear_2")
    for i in range(n):
        for j in range(cfg.layers_per_block):
            _unet_resnet(e, f"down_blocks.{i}.resnets.{j}", f"down_{i}/resnet_{j}")
            if cfg.down_block_has_attn[i]:
                _unet_transformer(e, f"down_blocks.{i}.attentions.{j}", f"down_{i}/attn_{j}", lin)
        if i < n - 1:
            e.pseudo_conv(f"down_blocks.{i}.downsamplers.0.conv", f"down_{i}/downsample")
    _unet_resnet(e, "mid_block.resnets.0", "mid/resnet_0")
    _unet_resnet(e, "mid_block.resnets.1", "mid/resnet_1")
    _unet_transformer(e, "mid_block.attentions.0", "mid/attn_0", lin)
    for i in range(n):
        for j in range(cfg.layers_per_block + 1):
            _unet_resnet(e, f"up_blocks.{i}.resnets.{j}", f"up_{i}/resnet_{j}")
            if cfg.up_block_has_attn[i]:
                _unet_transformer(e, f"up_blocks.{i}.attentions.{j}", f"up_{i}/attn_{j}", lin)
        if i < n - 1:
            e.pseudo_conv(f"up_blocks.{i}.upsamplers.0.conv", f"up_{i}/upsample")
    e.norm("conv_norm_out", "conv_norm_out")
    e.pseudo_conv("conv_out", "conv_out")
    return e.out


def _motion_module(e: _Emitter, src: str, dst: str, cfg):
    """One motion module under the ``mm_sd_v15_v2`` key names (the inverse
    of ``univst_tpu/models/convert.py::convert_motion_module``)."""
    tt = f"{src}.temporal_transformer"
    e.norm(f"{tt}.norm", f"{dst}/norm")
    e.linear(f"{tt}.proj_in", f"{dst}/proj_in")
    e.linear(f"{tt}.proj_out", f"{dst}/proj_out")
    for blk in range(cfg.motion_num_blocks):
        tb, db = f"{tt}.transformer_blocks.{blk}", f"{dst}/block_{blk}"
        for a in range(cfg.motion_attention_layers):
            _attention(e, f"{tb}.attention_blocks.{a}", f"{db}_attn_{a}")
            e.norm(f"{tb}.norms.{a}", f"{db}_norm_{a}")
        e.linear(f"{tb}.ff.net.0.proj", f"{db}_ff/proj")
        e.linear(f"{tb}.ff.net.2", f"{db}_ff/out")
        e.norm(f"{tb}.ff_norm", f"{db}_ff_norm")


def _ad_encoder(e: _Emitter, cfg) -> None:
    """The AnimateDiff UNet's down blocks and mid block (2D part and motion
    modules), shared by the UNet and the SparseControlNet."""
    n = len(cfg.block_out_channels)
    lin = cfg.use_linear_projection
    for i in range(n):
        for j in range(cfg.layers_per_block):
            _unet_resnet(e, f"down_blocks.{i}.resnets.{j}", f"down_{i}_resnet_{j}")
            if cfg.down_block_has_attn[i]:
                _unet_transformer(e, f"down_blocks.{i}.attentions.{j}", f"down_{i}_attn_{j}", lin)
            _motion_module(e, f"down_blocks.{i}.motion_modules.{j}", f"down_{i}_motion_{j}", cfg)
        if i < n - 1:
            e.conv2d(f"down_blocks.{i}.downsamplers.0.conv", f"down_{i}_downsample")
    _unet_resnet(e, "mid_block.resnets.0", "mid_resnet_0")
    _unet_transformer(e, "mid_block.attentions.0", "mid_attn_0", lin)
    if cfg.motion_mid_block:
        _motion_module(e, "mid_block.motion_modules.0", "mid_motion", cfg)
    _unet_resnet(e, "mid_block.resnets.1", "mid_resnet_1")


def flax_ad_unet_to_state_dict(params: Mapping, cfg) -> Dict[str, np.ndarray]:
    """The JAX ``UNetAnimateDiff`` params, 2D part and motion modules, as the
    port's ``UNetAnimateDiff`` state dict: diffusers keys for the 2D part,
    ``mm_sd_v15_v2`` keys for the motion modules."""
    e = _Emitter(params)
    n = len(cfg.block_out_channels)
    lin = cfg.use_linear_projection
    e.conv2d("conv_in", "conv_in")
    e.linear("time_embedding.linear_1", "time_embedding/linear_1")
    e.linear("time_embedding.linear_2", "time_embedding/linear_2")
    _ad_encoder(e, cfg)
    for i in range(n):
        for j in range(cfg.layers_per_block + 1):
            _unet_resnet(e, f"up_blocks.{i}.resnets.{j}", f"up_{i}_resnet_{j}")
            if cfg.up_block_has_attn[i]:
                _unet_transformer(e, f"up_blocks.{i}.attentions.{j}", f"up_{i}_attn_{j}", lin)
            _motion_module(e, f"up_blocks.{i}.motion_modules.{j}", f"up_{i}_motion_{j}", cfg)
        if i < n - 1:
            e.conv2d(f"up_blocks.{i}.upsamplers.0.conv", f"up_{i}_upsample")
    e.norm("conv_norm_out", "conv_norm_out")
    e.conv2d("conv_out", "conv_out")
    return e.out


def flax_sparse_controlnet_to_state_dict(params: Mapping, cfg) -> Dict[str, np.ndarray]:
    """The JAX ``SparseControlNet`` params as the port's ``SparseControlNet``
    state dict (the key names of the public AnimateDiff SparseCtrl
    checkpoints, see ``univst_torch.models.sparse_controlnet``)."""
    e = _Emitter(params)
    e.conv2d("conv_in", "conv_in")
    e.linear("time_embedding.linear_1", "time_embedding/linear_1")
    e.linear("time_embedding.linear_2", "time_embedding/linear_2")
    if cfg.use_simplified_condition_embedding:
        e.conv2d("controlnet_cond_embedding", "cond_embed_simple")
    else:
        e.conv2d("controlnet_cond_embedding.conv_in", "cond_embedding/conv_in")
        for i in range(len(cfg.cond_embed_channels) - 1):
            e.conv2d(f"controlnet_cond_embedding.blocks.{2 * i}", f"cond_embedding/block_{i}_a")
            e.conv2d(f"controlnet_cond_embedding.blocks.{2 * i + 1}",
                     f"cond_embedding/block_{i}_b")
        e.conv2d("controlnet_cond_embedding.conv_out", "cond_embedding/conv_out")
    _ad_encoder(e, cfg.unet)
    r = 0
    while e.has(f"ctrl_down_{r}"):
        e.conv2d(f"controlnet_down_blocks.{r}", f"ctrl_down_{r}")
        r += 1
    e.conv2d("controlnet_mid_block", "ctrl_mid")
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


def flax_mmdit_to_state_dict(params: Mapping, cfg) -> Dict[str, np.ndarray]:
    """The JAX ``MMDiT`` params as a diffusers ``SD3Transformer2DModel``
    state dict. ``pos_embed.pos_embed`` is written as zeros, as
    ``synth_ckpt.synth_mmdit`` writes it: both packages recompute the fixed
    table and ignore the stored one."""
    e = _Emitter(params)
    k = e.leaf("patch_proj/kernel")  # [p*p*C, D] over (p, p, C)-flattened patches
    d = k.shape[1]
    p = cfg.patch_size
    e.put("pos_embed.proj.weight", np.transpose(k.reshape(p, p, -1, d), (3, 2, 0, 1)))
    e.put("pos_embed.proj.bias", e.leaf("patch_proj/bias"))
    e.put("pos_embed.pos_embed", np.zeros((1, cfg.pos_embed_max_size**2, d), np.float32))
    for emb in ("timestep_embedder", "text_embedder"):
        for lin in ("linear_1", "linear_2"):
            e.linear(f"time_text_embed.{emb}.{lin}", f"{emb}/{lin}")
    e.linear("context_embedder", "context_embedder")

    def qk_norms(src, dst, names):
        if cfg.qk_norm == "rms":
            for nm in names:
                e.put(f"{src}.{nm}.weight", e.leaf(f"{dst}/{nm}/scale"))

    for i in range(cfg.num_layers):
        s, b = f"transformer_blocks.{i}", f"block_{i}"
        pre_only = i == cfg.num_layers - 1
        e.linear(f"{s}.norm1.linear", f"{b}/norm1/linear")
        if i in cfg.dual_attention_layers:
            for q in ("to_q", "to_k", "to_v"):
                e.linear(f"{s}.attn2.{q}", f"{b}/attn2/{q}")
            e.linear(f"{s}.attn2.to_out.0", f"{b}/attn2/to_out")
            qk_norms(f"{s}.attn2", f"{b}/attn2", ("norm_q", "norm_k"))
        e.linear(f"{s}.norm1_context.linear", f"{b}/norm1_context/linear")
        for q in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj"):
            e.linear(f"{s}.attn.{q}", f"{b}/attn/{q}")
        e.linear(f"{s}.attn.to_out.0", f"{b}/attn/to_out")
        if not pre_only:
            e.linear(f"{s}.attn.to_add_out", f"{b}/attn/to_add_out")
        qk_norms(f"{s}.attn", f"{b}/attn", ("norm_q", "norm_k", "norm_added_q", "norm_added_k"))
        for ff in ("ff",) if pre_only else ("ff", "ff_context"):
            e.linear(f"{s}.{ff}.net.0.proj", f"{b}/{ff}/fc1")
            e.linear(f"{s}.{ff}.net.2", f"{b}/{ff}/fc2")
    e.linear("norm_out.linear", "norm_out_linear")
    e.linear("proj_out", "proj_out")
    return e.out


def flax_t5_to_state_dict(params: Mapping, cfg) -> Dict[str, np.ndarray]:
    """The JAX ``T5Encoder`` params as a transformers ``T5EncoderModel``
    state dict (the embedding under both of its tied names)."""
    e = _Emitter(params)
    emb = e.leaf("token_embedding/embedding")
    e.put("shared.weight", emb)
    e.put("encoder.embed_tokens.weight", emb)
    e.put("encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight",
          e.leaf("rel_bias"))
    for i in range(cfg.num_layers):
        s = f"encoder.block.{i}"
        for q in ("q", "k", "v", "o"):
            e.linear(f"{s}.layer.0.SelfAttention.{q}", f"layer_{i}_{q}", bias=False)
        e.put(f"{s}.layer.0.layer_norm.weight", e.leaf(f"layer_{i}_norm_attn/scale"))
        for src, dst in (("wi_0", "wi0"), ("wi_1", "wi1"), ("wo", "wo")):
            e.linear(f"{s}.layer.1.DenseReluDense.{src}", f"layer_{i}_{dst}", bias=False)
        e.put(f"{s}.layer.1.layer_norm.weight", e.leaf(f"layer_{i}_norm_ff/scale"))
    e.put("encoder.final_layer_norm.weight", e.leaf("final_norm/scale"))
    return e.out


def to_torch_state_dict(sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _find_weights(dirpath: str) -> Optional[str]:
    """A module folder's weights: its shard index (``*.index.json``) where
    it has one, else its first ``*.safetensors``, ``*.bin`` or ``*.pt`` in
    that order of preference (univst_tpu/pipelines/sd.py:43-44, which knows
    no index); None when it has none."""
    for pat in ("*.index.json", "*.safetensors", "*.bin", "*.pt"):
        hits = sorted(glob.glob(os.path.join(dirpath, pat)))
        if hits:
            return hits[0]
    return None


def _load_sharded(index_path: str) -> Dict[str, torch.Tensor]:
    """Every shard that a ``*.index.json``'s ``weight_map`` names, merged.
    Refuses an index that names a key twice or a shard that is missing
    (before any shard is read), and a shard whose keys are not the ones the
    index maps to it."""
    def no_duplicates(pairs):
        keys = [k for k, _ in pairs]
        if len(set(keys)) != len(keys):
            dup = sorted({k for k in keys if keys.count(k) > 1})
            raise ValueError(f"{index_path}: the index names {dup[:5]} twice")
        return dict(pairs)

    with open(index_path) as f:
        weight_map = json.load(f, object_pairs_hook=no_duplicates).get("weight_map")
    if not isinstance(weight_map, dict) or not weight_map:
        raise ValueError(f"{index_path}: no weight_map")
    folder = os.path.dirname(index_path)
    shards = sorted(set(weight_map.values()))
    for shard in shards:
        if os.path.basename(shard) != shard or not os.path.isfile(os.path.join(folder, shard)):
            raise FileNotFoundError(f"{index_path}: the index names a shard {shard!r} that "
                                    f"is not a file of {folder}")
    out: Dict[str, torch.Tensor] = {}
    for shard in shards:
        part = load_state_dict_file(os.path.join(folder, shard))
        want = {k for k, v in weight_map.items() if v == shard}
        if set(part) != want:
            raise ValueError(f"{index_path}: shard {shard} holds keys "
                             f"{sorted(set(part) - want)[:5]} the index does not map to it "
                             f"and lacks {sorted(want - set(part))[:5]}")
        out.update(part)
    return out


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """A .safetensors / .bin / .pt / .ckpt weights file, or a shard index
    (``*.index.json``: its shards merged), as a dict of CPU tensors; a
    pickle that nests its weights under ``state_dict`` (the AnimateDiff
    motion and LDM checkpoints) gives that dict."""
    if path.endswith(".index.json"):
        return _load_sharded(path)
    if path.endswith(".safetensors"):
        from univst_torch.utils.safetensors import load_file

        return load_file(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd.get("state_dict", sd)


def _is_motion_key(key: str) -> bool:
    return ".motion_modules." in key


def load_strict(module, sd: Mapping[str, torch.Tensor], name: str) -> None:
    """``load_state_dict`` that accepts no unexpected key and misses none,
    except the motion modules of an AnimateDiff UNet, which 2D checkpoints
    do not carry (reference load_weights, animatediff/utils/util.py:89-121)."""
    missing, unexpected = module.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not _is_motion_key(k)]
    if missing or unexpected:
        raise RuntimeError(f"{name}: missing keys {missing[:5]}, unexpected keys "
                           f"{unexpected[:5]}")


def load_motion_module(unet, path: str) -> None:
    """Load an ``mm_sd_v15_v2``-style motion checkpoint into ``unet``'s motion
    modules. Every motion-module weight must be there and every key must
    map (the reference's zero-unexpected-keys assertion, util.py:119-120);
    the ``pos_encoder.pe`` tables some checkpoints carry are skipped (the
    port recomputes them)."""
    sd = {k: v for k, v in load_state_dict_file(path).items() if not k.endswith("pos_encoder.pe")}
    own = {k for k in unet.state_dict() if _is_motion_key(k)}
    missing, stray = sorted(own - set(sd)), sorted(set(sd) - own)
    if missing or stray:
        raise RuntimeError(f"motion checkpoint {path}: missing keys {missing[:5]}, "
                           f"keys that map to no motion module {stray[:5]}")
    unet.load_state_dict(sd, strict=False)


def load_pretrained(path: str, unet=None, vae=None, text_encoder=None, transformer=None,
                    text_encoder_2=None, text_encoder_3=None) -> None:
    """Load each given module from its diffusers subfolder of ``path``
    (``unet``, ``vae``, ``text_encoder``; SD3: ``transformer``,
    ``text_encoder_2``, ``text_encoder_3``) with :func:`load_strict`
    (diffusers/transformers layout, as ``univst_torch.tools.
    make_synthetic_checkpoints`` writes it; a folder may be sharded). A module
    whose folder is missing raises."""
    for sub, module in (("unet", unet), ("vae", vae), ("text_encoder", text_encoder),
                        ("transformer", transformer), ("text_encoder_2", text_encoder_2),
                        ("text_encoder_3", text_encoder_3)):
        if module is None:
            continue
        weights = _find_weights(os.path.join(path, sub))
        if weights is None:
            raise FileNotFoundError(f"no weights file under {os.path.join(path, sub)}")
        load_strict(module, load_state_dict_file(weights), sub)


# ---------------------------------------------------------------------------
# RAFT (princeton-vl key names: fnet.* / cnet.* / update_block.*)
# ---------------------------------------------------------------------------


def _raft_mask_channels_to_torch(x: np.ndarray) -> np.ndarray:
    """``mask_conv2``'s 576 output channels from the JAX package's order
    ``(8, 8, 9)`` (neighbor last) to torchvision's ``(9, 8, 8)`` (neighbor
    first), along axis 0."""
    return x.reshape((64, 9) + x.shape[1:]).swapaxes(0, 1).reshape(x.shape)


def flax_raft_to_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """The JAX package's RAFT params -> the port's state dict. ``cnet``'s
    batch norms hold the folded inference ``scale`` / ``bias`` there; they
    become a BatchNorm2d (eps 1e-5) with ``running_mean = 0`` and
    ``running_var = 1 - eps``, which computes ``x * scale + bias`` (to fp32
    rounding of ``sqrt(1 - eps + eps)``). ``mask_conv2``'s output channels
    are permuted to torchvision's order (the JAX package reads them
    neighbor-last)."""
    e = _Emitter(params)
    eps = 1e-5

    def bn(src, dst):
        scale = e.leaf(dst + "/scale")
        e.put(src + ".weight", scale)
        e.put(src + ".bias", e.leaf(dst + "/bias"))
        e.put(src + ".running_mean", np.zeros_like(scale))
        e.put(src + ".running_var", np.full_like(scale, 1.0 - eps))
        e.put(src + ".num_batches_tracked", np.asarray(0, np.int64))

    for enc, norm in (("fnet", "instance"), ("cnet", "batch")):
        e.conv2d(f"{enc}.conv1", f"{enc}/conv1")
        if norm == "batch":
            bn(f"{enc}.norm1", f"{enc}/norm1")
        for stage in (1, 2, 3):
            for blk in (0, 1):
                s, d = f"{enc}.layer{stage}.{blk}", f"{enc}/layer{stage}_{blk}"
                e.conv2d(f"{s}.conv1", f"{d}/conv1")
                e.conv2d(f"{s}.conv2", f"{d}/conv2")
                if norm == "batch":
                    bn(f"{s}.norm1", f"{d}/norm1")
                    bn(f"{s}.norm2", f"{d}/norm2")
                if e.has(f"{d}/downsample"):
                    e.conv2d(f"{s}.downsample.0", f"{d}/downsample")
                    if norm == "batch":
                        bn(f"{s}.downsample.1", f"{d}/norm3")
        e.conv2d(f"{enc}.conv2", f"{enc}/conv2")
    for name in ("convc1", "convc2", "convf1", "convf2", "conv"):
        e.conv2d(f"update_block.encoder.{name}", f"update_block/{name}")
    for name in ("convz1", "convr1", "convq1", "convz2", "convr2", "convq2"):
        e.conv2d(f"update_block.gru.{name}", f"update_block/gru/{name}")
    e.conv2d("update_block.flow_head.conv1", "update_block/flow_head_conv1")
    e.conv2d("update_block.flow_head.conv2", "update_block/flow_head_conv2")
    e.conv2d("update_block.mask.0", "update_block/mask_conv1")
    e.conv2d("update_block.mask.2", "update_block/mask_conv2")
    for leaf in ("weight", "bias"):
        key = f"update_block.mask.2.{leaf}"
        e.out[key] = np.ascontiguousarray(_raft_mask_channels_to_torch(e.out[key]))
    return e.out


def _torchvision_raft_to_princeton(sd: Mapping) -> Dict:
    """torchvision ``Raft_Large_Weights`` key names -> princeton-vl's (the
    JAX package's ``convert.py:558-615``): the two module trees are the same
    architecture under other names. Longest source prefix first, so a
    block's rename wins over its encoder stem's."""
    renames = [
        ("update_block.motion_encoder.convcorr1.0", "update_block.encoder.convc1"),
        ("update_block.motion_encoder.convcorr2.0", "update_block.encoder.convc2"),
        ("update_block.motion_encoder.convflow1.0", "update_block.encoder.convf1"),
        ("update_block.motion_encoder.convflow2.0", "update_block.encoder.convf2"),
        ("update_block.motion_encoder.conv.0", "update_block.encoder.conv"),
        ("mask_predictor.convrelu.0", "update_block.mask.0"),
        ("mask_predictor.conv", "update_block.mask.2"),
    ]
    for g in (1, 2):
        for gate in "zrq":
            renames.append((f"update_block.recurrent_block.convgru{g}.conv{gate}",
                            f"update_block.gru.conv{gate}{g}"))
    for src, dst in (("feature_encoder", "fnet"), ("context_encoder", "cnet")):
        renames += [(f"{src}.convnormrelu.0", f"{dst}.conv1"),
                    (f"{src}.convnormrelu.1", f"{dst}.norm1"), (f"{src}.conv.", f"{dst}.conv2.")]
        for stage in (1, 2, 3):
            for blk in (0, 1):
                s, d = f"{src}.layer{stage}.{blk}", f"{dst}.layer{stage}.{blk}"
                renames += [(f"{s}.convnormrelu1.0", f"{d}.conv1"),
                            (f"{s}.convnormrelu1.1", f"{d}.norm1"),
                            (f"{s}.convnormrelu2.0", f"{d}.conv2"),
                            (f"{s}.convnormrelu2.1", f"{d}.norm2"),
                            (f"{s}.downsample.", f"{d}.downsample.")]
    renames.sort(key=lambda ab: -len(ab[0]))
    out = {}
    for k, v in sd.items():
        for a, b in renames:
            if k.startswith(a):
                k = b + k[len(a):]
                break
        out[k] = v
    return out


def load_raft(src, cfg=None):
    """A RAFT-large module (``RAFTConfig()`` unless ``cfg``) loaded strictly
    from a checkpoint path or a state dict, in eval mode on the CPU. Takes
    both layouts: princeton-vl (raft-things/sintel .pth; ``module.``
    prefixes stripped) and torchvision ``Raft_Large_Weights``
    (``feature_encoder.`` keys, renamed). princeton-vl's residual blocks
    register their downsampling norm twice (``norm3`` and ``downsample.1``):
    the ``norm3`` copy is dropped after checking it equals the other."""
    from univst_torch.models.raft import RAFT, RAFTConfig

    sd = load_state_dict_file(src) if isinstance(src, str) else dict(src)
    sd = {k[len("module."):] if k.startswith("module.") else k: torch.as_tensor(v)
          for k, v in sd.items()}
    if any(k.startswith("feature_encoder.") for k in sd):
        sd = _torchvision_raft_to_princeton(sd)
    for k in [k for k in sd if ".norm3." in k]:
        twin = k.replace(".norm3.", ".downsample.1.")
        v = sd.pop(k)
        if twin not in sd or not torch.equal(v, sd[twin]):
            raise RuntimeError(f"RAFT checkpoint: {k} has no equal {twin}")
    model = RAFT(cfg if cfg is not None else RAFTConfig())
    model.load_state_dict(sd, strict=True)
    return model.eval()
