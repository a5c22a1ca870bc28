"""Localized video style transfer CLI (SD3/SD3.5 backbone) — port of
``univst_tpu/cli/run_video_style_transfer_sd3.py``, flag for flag.

Loads both trajectories and the clean content latents (``ddim_latents_0``)
for the controlled-velocity pull, AdaIN-shifts the initial latents per
frame, runs the flow stylization (style-singleton 2-branch phase, or the
3-branch batch for a style trajectory whose frames differ, then the
stylized-only phase) and writes per-frame PNGs to
{out}/sd3/{content}_{style}/. Runs on CUDA unless ``--platform cpu``;
under ``torchrun`` with ``--mesh data=N[,tensor=M]`` over a dp x tp mesh
(rank 0 writes)."""

from __future__ import annotations

import argparse
import os

from univst_torch.cli.common import add_mesh_flag, is_writer, singleton_style_or_fallback
from univst_torch.cli.run_content_inversion_sd3 import DECODE_CHUNK, build_sd3_pipeline
from univst_torch.utils.io import load_mask, save_frames, seed_everything


def main(args):
    import torch

    from univst_torch.core.adain import latent_adain_sd3
    from univst_torch.core.config import StyleTransferConfig
    from univst_torch.core.trajectory import load_trajectory

    if args.seed is not None:
        seed_everything(args.seed)

    pipe = build_sd3_pipeline(args)
    content_rev = load_trajectory(args.content_inv_path, args.time_steps, reverse=True,
                                  device=pipe.device)
    style_rev = load_trajectory(args.style_inv_path, args.time_steps, reverse=True,
                                device=pipe.device)
    pipe, style_rev = singleton_style_or_fallback(pipe, style_rev, args.style_inv_path,
                                                  args.time_steps)
    # clean content latents (ddim_latents_0, the last of the reversed order)
    img_latents = content_rev[-1]
    # init latent shift, per frame (sd3 pnp_utils.py:305-316)
    init_latents = latent_adain_sd3(content_rev[0], style_rev[0])

    mask = None
    if args.mask_path:
        mask = torch.as_tensor(load_mask(args.mask_path, args.num_frames), device=pipe.device)

    context, pooled = pipe.encode_prompt("")
    pipe.free_text_encoders()
    out = pipe.stylize_latents(
        content_rev, style_rev, init_latents, img_latents, torch.cat([context] * 3),
        torch.cat([pooled] * 3), mask=mask,
        cfg=StyleTransferConfig(num_steps=args.time_steps),
    )
    frames = pipe.decode_latents_uint8(out, chunk=DECODE_CHUNK).cpu().numpy()

    content_name = os.path.normpath(args.content_inv_path).split(os.sep)[-2]
    style_name = os.path.normpath(args.style_inv_path).split(os.sep)[-2]
    out_dir = os.path.join(args.output_path, args.backbone, f"{content_name}_{style_name}")
    if is_writer(pipe.mesh):
        save_frames(frames, out_dir)
    print(f"done -> {out_dir}")


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--pretrained_model_path", type=str, default=None)
    p.add_argument("--content_inv_path", type=str,
                   default="results/contents-inv/sd3/mallard-fly/inversion")
    p.add_argument("--style_inv_path", type=str,
                   default="results/styles-inv/sd3/00033/inversion")
    p.add_argument("--mask_path", type=str, default=None)
    p.add_argument("--output_path", type=str, default="results/stylizations")
    p.add_argument("--weight_dtype", type=str, default="bf16")
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--time_steps", type=int, default=50)
    p.add_argument("--seed", type=int, default=33)
    p.add_argument("--variant", type=str, default="sd3", choices=["sd3", "sd35", "sd35m", "tiny"])
    p.add_argument("--backbone", type=str, default="sd3")
    p.add_argument("--platform", type=str, default=None, help="'cpu' or 'cuda' (default)")
    add_mesh_flag(p)
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
