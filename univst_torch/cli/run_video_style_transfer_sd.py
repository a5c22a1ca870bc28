"""Localized video style transfer CLI (SD backbone) — port of
``univst_tpu/cli/run_video_style_transfer_sd.py``, flag for flag.

Loads both inversion trajectories, AdaIN-shifts the initial noise
(pnp_utils.py latent_adain; AnimateDiff starts from the raw content noise),
runs the stylization loop with optional localized masking, and writes
per-frame PNGs to {out}/{backbone}/{content}_{style}/. Runs on CUDA unless
``--platform cpu``; frame-parallel under ``torchrun`` with ``--mesh data=N``
(rank 0 writes)."""

from __future__ import annotations

import argparse
import os

from univst_torch.cli.common import (
    add_mesh_flag, build_pipeline_from_args, check_backbone, is_writer,
    singleton_style_or_fallback,
)
from univst_torch.utils.io import load_mask, save_frames, seed_everything


def main(args):
    import torch

    from univst_torch.core.adain import latent_adain
    from univst_torch.core.config import StyleTransferConfig
    from univst_torch.core.trajectory import load_trajectory

    check_backbone(args)
    raft = bool(args.smoother) and args.flow == "raft"
    if raft and not args.raft_ckpt:
        raise SystemExit("--flow raft requires --raft_ckpt (torchvision "
                         "Raft_Large_Weights or princeton-vl layout)")
    if args.seed is not None:
        seed_everything(args.seed)

    pipe = build_pipeline_from_args(args)
    if raft:
        import dataclasses

        from univst_torch.models.convert import load_raft
        from univst_torch.models.raft import make_raft_flow

        pipe = dataclasses.replace(
            pipe, flow_fn=make_raft_flow(load_raft(args.raft_ckpt).to(pipe.device)))
    # trajectories ordered so index i holds latents at inversion step N-i
    content_rev = load_trajectory(args.content_inv_path, args.time_steps, reverse=True,
                                  device=pipe.device)
    style_rev = load_trajectory(args.style_inv_path, args.time_steps, reverse=True,
                                device=pipe.device)
    if pipe.style_singleton:
        pipe, style_rev = singleton_style_or_fallback(pipe, style_rev, args.style_inv_path,
                                                      args.time_steps)
    # init latent shift (run_video_style_transfer_sd.py:55-57); the
    # AnimateDiff runner passes the raw content noise instead
    # (run_video_style_transfer_animatediff.py:59-69)
    if args.backbone == "animatediff":
        init_latents = content_rev[0]
    else:
        init_latents = latent_adain(content_rev[0], style_rev[0])

    mask = None
    if args.mask_path:
        mask = torch.as_tensor(load_mask(args.mask_path, args.num_frames), device=pipe.device)

    context = pipe.encode_text(args.prompt)
    out = pipe.stylize_latents(
        content_rev, style_rev, init_latents, torch.cat([context] * 3), mask=mask,
        cfg=StyleTransferConfig(num_steps=args.time_steps, smoother=args.smoother),
    )
    frames = pipe.decode_latents_uint8(out).cpu().numpy()

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
                   default="results/contents-inv/sd/mallard-fly/inversion")
    p.add_argument("--style_inv_path", type=str,
                   default="results/styles-inv/sd/00033/inversion")
    p.add_argument("--mask_path", type=str, default=None,
                   help="directory of propagated per-frame masks; omit for full-frame transfer")
    p.add_argument("--output_path", type=str, default="results/stylizations")
    p.add_argument("--weight_dtype", type=str, default="bf16")
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--time_steps", type=int, default=50)
    p.add_argument("--seed", type=int, default=33)
    p.add_argument("--smoother", type=str, default=None, choices=[None, "pixel"],
                   help="sliding-window flow smoother (the reference ships this "
                        "feature disabled; 'pixel' enables it)")
    p.add_argument("--flow", type=str, default="lk", choices=["lk", "raft"],
                   help="smoother optical flow: built-in Lucas-Kanade pyramid or "
                        "RAFT-large (the reference's flow, cal_optica_flow.py:53)")
    p.add_argument("--raft_ckpt", type=str, default=None,
                   help="RAFT checkpoint (torchvision Raft_Large_Weights or "
                        "princeton-vl .pth) for --flow raft")
    p.add_argument("--variant", type=str, default="sd15", choices=["sd15", "sd21", "tiny"])
    p.add_argument("--backbone", type=str, default="sd")
    p.add_argument("--prompt", type=str, default="",
                   help="shared 3-branch prompt (reference uses '')")
    p.add_argument("--platform", type=str, default=None, help="'cpu' or 'cuda' (default)")
    add_mesh_flag(p)
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
