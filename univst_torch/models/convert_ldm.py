"""LDM (CompVis/DreamBooth .ckpt/.safetensors) -> diffusers-layout key remap,
plus LoRA weight merging — the port's own copy of
``univst_tpu/models/convert_ldm.py``.

Rebuild of the reference weight plumbing in
backbones/animatediff/utils/convert_from_ckpt.py (convert_ldm_unet_checkpoint,
convert_ldm_vae_checkpoint, convert_ldm_clip_checkpoint) and
convert_lora_safetensor_to_diffusers.py (convert_lora) — the path that lets
AnimateDiff load personalized DreamBooth checkpoints and LoRAs
(load_weights, utils/util.py:122-176).

These functions translate key NAMES of numpy state dicts only (and merge
LoRA deltas); the outputs load into the port's modules through
``univst_torch.models.convert``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

# SD-1.5 topology constants (4 levels, 2 resnets/level)
_N_LEVELS = 4
_LAYERS = 2


def ldm_unet_to_diffusers(state_dict: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """model.diffusion_model.* -> diffusers UNet2DConditionModel keys."""
    src = {
        k[len("model.diffusion_model."):]: v
        for k, v in state_dict.items()
        if k.startswith("model.diffusion_model.")
    }
    if not src:  # already stripped
        src = dict(state_dict)
    out: Dict[str, np.ndarray] = {}

    def move(a, b):
        for suf in (".weight", ".bias"):
            if a + suf in src:
                out[b + suf] = src.pop(a + suf)

    def resnet(a, b):
        move(a + ".in_layers.0", b + ".norm1")
        move(a + ".in_layers.2", b + ".conv1")
        move(a + ".emb_layers.1", b + ".time_emb_proj")
        move(a + ".out_layers.0", b + ".norm2")
        move(a + ".out_layers.3", b + ".conv2")
        move(a + ".skip_connection", b + ".conv_shortcut")

    def transformer(a, b):
        move(a + ".norm", b + ".norm")
        move(a + ".proj_in", b + ".proj_in")
        move(a + ".proj_out", b + ".proj_out")
        ta, tb = a + ".transformer_blocks.0", b + ".transformer_blocks.0"
        for part in ("attn1", "attn2"):
            for p in ("to_q", "to_k", "to_v"):
                move(f"{ta}.{part}.{p}", f"{tb}.{part}.{p}")
            move(f"{ta}.{part}.to_out.0", f"{tb}.{part}.to_out.0")
        for ln in ("norm1", "norm2", "norm3"):
            move(f"{ta}.{ln}", f"{tb}.{ln}")
        move(ta + ".ff.net.0.proj", tb + ".ff.net.0.proj")
        move(ta + ".ff.net.2", tb + ".ff.net.2")

    move("time_embed.0", "time_embedding.linear_1")
    move("time_embed.2", "time_embedding.linear_2")
    move("input_blocks.0.0", "conv_in")
    # down path: input_blocks 1..11; every 3rd (3,6,9) is a downsampler
    for i in range(1, 12):
        level, layer = (i - 1) // 3, (i - 1) % 3
        if layer == 2:  # downsample op
            move(f"input_blocks.{i}.0.op", f"down_blocks.{level}.downsamplers.0.conv")
        else:
            resnet(f"input_blocks.{i}.0", f"down_blocks.{level}.resnets.{layer}")
            transformer(f"input_blocks.{i}.1", f"down_blocks.{level}.attentions.{layer}")
    resnet("middle_block.0", "mid_block.resnets.0")
    transformer("middle_block.1", "mid_block.attentions.0")
    resnet("middle_block.2", "mid_block.resnets.1")
    # up path: output_blocks 0..11, 3 per level; upsampler ends blocks 2,5,8
    for i in range(12):
        level, layer = i // 3, i % 3
        resnet(f"output_blocks.{i}.0", f"up_blocks.{level}.resnets.{layer}")
        transformer(f"output_blocks.{i}.1", f"up_blocks.{level}.attentions.{layer}")
        if layer == 2 and level < _N_LEVELS - 1:
            # the upsampler is the last submodule: index 1 in no-attn blocks,
            # 2 in attention blocks
            for idx in (1, 2):
                move(f"output_blocks.{i}.{idx}.conv",
                     f"up_blocks.{level}.upsamplers.0.conv")
    move("out.0", "conv_norm_out")
    move("out.2", "conv_out")
    leftovers = [k for k in src if not k.endswith("position_ids")]
    if leftovers:
        raise ValueError(f"unmapped LDM UNet keys: {sorted(leftovers)[:5]}")
    return out


def ldm_vae_to_diffusers(state_dict: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """first_stage_model.* -> diffusers AutoencoderKL keys."""
    src = {
        k[len("first_stage_model."):]: v
        for k, v in state_dict.items()
        if k.startswith("first_stage_model.")
    }
    if not src:
        src = dict(state_dict)
    out: Dict[str, np.ndarray] = {}

    def move(a, b, squeeze=False):
        for suf in (".weight", ".bias"):
            if a + suf in src:
                v = src.pop(a + suf)
                if squeeze and suf == ".weight" and v.ndim == 4:
                    v = v[:, :, 0, 0]  # attention 1x1 convs -> linear
                out[b + suf] = v

    def resnet(a, b):
        move(a + ".norm1", b + ".norm1")
        move(a + ".conv1", b + ".conv1")
        move(a + ".norm2", b + ".norm2")
        move(a + ".conv2", b + ".conv2")
        move(a + ".nin_shortcut", b + ".conv_shortcut")

    def attn(a, b):
        move(a + ".norm", b + ".group_norm")
        move(a + ".q", b + ".to_q", squeeze=True)
        move(a + ".k", b + ".to_k", squeeze=True)
        move(a + ".v", b + ".to_v", squeeze=True)
        move(a + ".proj_out", b + ".to_out.0", squeeze=True)

    n = max(
        (int(k.split(".")[2]) for k in src if k.startswith("encoder.down.")), default=-1
    ) + 1
    move("encoder.conv_in", "encoder.conv_in")
    for i in range(n):
        for j in range(_LAYERS):
            resnet(f"encoder.down.{i}.block.{j}", f"encoder.down_blocks.{i}.resnets.{j}")
        move(f"encoder.down.{i}.downsample.conv",
             f"encoder.down_blocks.{i}.downsamplers.0.conv")
    resnet("encoder.mid.block_1", "encoder.mid_block.resnets.0")
    attn("encoder.mid.attn_1", "encoder.mid_block.attentions.0")
    resnet("encoder.mid.block_2", "encoder.mid_block.resnets.1")
    move("encoder.norm_out", "encoder.conv_norm_out")
    move("encoder.conv_out", "encoder.conv_out")
    move("quant_conv", "quant_conv")

    move("decoder.conv_in", "decoder.conv_in")
    resnet("decoder.mid.block_1", "decoder.mid_block.resnets.0")
    attn("decoder.mid.attn_1", "decoder.mid_block.attentions.0")
    resnet("decoder.mid.block_2", "decoder.mid_block.resnets.1")
    # LDM decoder 'up' levels are reversed relative to diffusers up_blocks
    for i in range(n):
        ldm_i = n - 1 - i
        for j in range(_LAYERS + 1):
            resnet(f"decoder.up.{ldm_i}.block.{j}", f"decoder.up_blocks.{i}.resnets.{j}")
        move(f"decoder.up.{ldm_i}.upsample.conv",
             f"decoder.up_blocks.{i}.upsamplers.0.conv")
    move("decoder.norm_out", "decoder.conv_norm_out")
    move("decoder.conv_out", "decoder.conv_out")
    move("post_quant_conv", "post_quant_conv")
    leftovers = list(src)
    if leftovers:
        raise ValueError(f"unmapped LDM VAE keys: {sorted(leftovers)[:5]}")
    return out


def ldm_clip_to_hf(state_dict: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """cond_stage_model.transformer.* -> HF CLIPTextModel keys."""
    out = {}
    pre = "cond_stage_model.transformer."
    for k, v in state_dict.items():
        if k.startswith(pre) and "position_ids" not in k:
            out[k[len(pre):]] = v
    return out


def merge_lora(
    base: Mapping[str, np.ndarray],
    lora: Mapping[str, np.ndarray],
    alpha: float = 0.6,
) -> Dict[str, np.ndarray]:
    """Merge a webui-format LoRA into base diffusers weights:
    W <- W + alpha * up @ down (reference convert_lora,
    convert_lora_safetensor_to_diffusers.py:24-100).

    LoRA keys look like ``lora_unet_<path>_<name>.lora_up.weight`` with '_'
    for '.'; this handles the common linear/conv1x1 cases.
    """
    out = dict(base)
    ups = {k: v for k, v in lora.items() if ".lora_up.weight" in k}
    for up_key, up in ups.items():
        down_key = up_key.replace(".lora_up.", ".lora_down.")
        down = lora[down_key]
        stem = up_key.split(".lora_up.")[0]
        for prefix in ("lora_unet_", "lora_te_"):
            if stem.startswith(prefix):
                stem = stem[len(prefix):]
        # '_' -> '.' except inside known compound tokens (the JAX package's
        # list also joins "ff.net" and "encoder.layers", which are dotted
        # paths in the diffusers/transformers keys: its merge of a LoRA on
        # a feed-forward or any text-encoder layer raises a KeyError)
        target = stem.replace("_", ".") + ".weight"
        for tok in ("down.blocks", "up.blocks", "mid.block", "transformer.blocks",
                    "attentions", "resnets", "proj.in", "proj.out", "to.q", "to.k",
                    "to.v", "to.out", "text.model", "self.attn", "out.proj",
                    "q.proj", "k.proj", "v.proj", "time.emb.proj", "conv.shortcut",
                    "final.layer.norm", "layer.norm"):
            target = target.replace(tok, tok.replace(".", "_"))
        if target not in out:
            raise KeyError(f"LoRA target {target!r} not found in base weights")
        w = out[target]
        u = up.astype(np.float32)
        d = down.astype(np.float32)
        if w.ndim == 4:  # conv: up [o, r(, 1, 1)], down [r, i(, kh, kw)]
            # (the JAX package's einsum here names axes '1', which numpy
            # refuses: its conv LoRA merge raises)
            delta = (u.reshape(u.shape[0], -1) @ d.reshape(d.shape[0], -1)).reshape(w.shape)
        else:
            delta = u @ d
        out[target] = (w.astype(np.float32) + alpha * delta).astype(w.dtype)
    return out
