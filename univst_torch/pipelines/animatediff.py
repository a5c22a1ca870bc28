"""AnimateDiff-v2 pipeline builder — port of
``univst_tpu/pipelines/animatediff.py`` (rebuild of the AnimationPipeline
wiring, backbones/animatediff/pipelines/pipeline_animation.py:50, and the
runner's model build, src/animatediff/run_content_inversion_animatediff.py:
43-62).

It returns an ``SDVideoPipeline``: the stages and loops are the SD ones;
the denoiser is the AnimateDiff UNet, the DDIM betas are plain 'linear'
(animatediff-v2.yaml:16-20), the shift constants are AnimateDiff's, both
frame-index sets are empty (the backbone builds no cross-frame K/V), and
stylization runs capture-and-inject (``style_singleton=False``: the motion
modules give each style frame its own position).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from univst_torch.core.config import AD_STYLE_SHIFT
from univst_torch.core.scheduler import DDIMConfig, DDIMSchedule
from univst_torch.models import convert as cv
from univst_torch.models.clip_text import CLIPTextConfig, CLIPTextModel, Tokenizer
from univst_torch.models.unet_ad import UNetADConfig, UNetAnimateDiff
from univst_torch.models.vae import AutoencoderKL, VAEConfig
from univst_torch.pipelines.sd import SDVideoPipeline, random_init_, resolve_device, set_precision


def _numpy_state(path: str):
    return {k: v.float().numpy() for k, v in cv.load_state_dict_file(path).items()}


def build_animatediff(
    pretrained_model_path: Optional[str] = None,
    motion_module_path: Optional[str] = None,
    variant: str = "ad",
    num_frames: int = 16,
    dtype: torch.dtype = torch.bfloat16,
    capture_up_block: Optional[int] = None,
    seed: int = 0,
    dreambooth_path: Optional[str] = None,
    lora_path: Optional[str] = None,
    lora_alpha: float = 0.8,
    device=None,
    mesh=None,
) -> SDVideoPipeline:
    """Build the AnimateDiff pipeline on ``device`` (CUDA unless the CPU is
    asked for): the AnimateDiff UNet, the SVD temporal-decoder VAE and the
    SD-1.5 CLIP (``variant='tiny'``: their tiny configs). Weights are seeded
    random (``seed``; the motion modules' ``proj_out`` stays zero, as the
    reference initializes it), then loaded in the reference's order
    (load_weights, animatediff/utils/util.py:89-176):

      * ``pretrained_model_path``: the SD-1.5 ``unet/`` (motion modules may
        be missing), ``vae/`` and ``text_encoder/`` folders present;
      * ``dreambooth_path``: a personalized LDM checkpoint replacing those
        three (its CLIP only where it carries one);
      * ``lora_path``: a webui-format LoRA merged into the UNet and text
        encoder weights at ``lora_alpha``;
      * ``motion_module_path``: the motion checkpoint (``mm_sd_v15_v2``).

    ``mesh``: frame-parallel over it (``SDVideoPipeline.with_mesh``; the
    motion modules' frame attention then runs on all frames of 1/N of the
    tokens, between two all-to-alls).
    """
    device = resolve_device(device)
    set_precision()
    if variant == "ad":
        unet_cfg = UNetADConfig.ad_v2(capture_up_block=capture_up_block)
        vae_cfg, clip_cfg = VAEConfig.svd(), CLIPTextConfig.sd15()
    else:
        unet_cfg = UNetADConfig.tiny(capture_up_block=capture_up_block)
        vae_cfg, clip_cfg = VAEConfig.tiny(temporal_decoder=True), CLIPTextConfig.tiny()
    with torch.device(device):
        unet, vae, text = UNetAnimateDiff(unet_cfg), AutoencoderKL(vae_cfg), CLIPTextModel(clip_cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    for m in (unet, vae, text):
        random_init_(m, gen)
    with torch.no_grad():
        for mm in unet.motion_modules():
            mm.temporal_transformer.proj_out.weight.zero_()

    unet_sd = vae_sd = clip_sd = None
    if pretrained_model_path:
        found = {sub: cv._find_weights(os.path.join(pretrained_model_path, sub))
                 for sub in ("unet", "vae", "text_encoder")}
        unet_sd, vae_sd, clip_sd = (_numpy_state(w) if w else None for w in found.values())
    if dreambooth_path:
        from univst_torch.models.convert_ldm import (
            ldm_clip_to_hf, ldm_unet_to_diffusers, ldm_vae_to_diffusers,
        )

        db = _numpy_state(dreambooth_path)
        unet_sd, vae_sd = ldm_unet_to_diffusers(db), ldm_vae_to_diffusers(db)
        clip_sd = ldm_clip_to_hf(db) or clip_sd
    if lora_path:
        from univst_torch.models.convert_ldm import merge_lora

        lora = _numpy_state(lora_path)

        def part(prefix):
            return {k: v for k, v in lora.items() if k.startswith(prefix)}

        if unet_sd is not None:
            unet_sd = merge_lora(unet_sd, part("lora_unet_"), alpha=lora_alpha)
        if clip_sd is not None:
            clip_sd = merge_lora(clip_sd, part("lora_te_"), alpha=lora_alpha)
    for name, module, sd in (("unet", unet, unet_sd), ("vae", vae, vae_sd),
                             ("text_encoder", text, clip_sd)):
        if sd is not None:
            cv.load_strict(module, cv.to_torch_state_dict(sd), name)
    if motion_module_path:
        cv.load_motion_module(unet, motion_module_path)
    for m in (unet, vae, text):
        m.to(dtype).eval().requires_grad_(False)

    tok_dir = None
    if pretrained_model_path and os.path.isdir(os.path.join(pretrained_model_path, "tokenizer")):
        tok_dir = os.path.join(pretrained_model_path, "tokenizer")
    return SDVideoPipeline(
        unet=unet, vae=vae, text_encoder=text, tokenizer=Tokenizer(tok_dir),
        schedule=DDIMSchedule(DDIMConfig(beta_schedule="linear")), num_frames=num_frames,
        device=device, dtype=dtype, style_shift_cfg=AD_STYLE_SHIFT, base_frame_indices=(),
        pnp_frame_indices=(), style_singleton=False).with_mesh(mesh)
