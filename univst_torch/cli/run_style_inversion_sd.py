"""Style-image DDIM inversion CLI (SD backbone) — port of
``univst_tpu/cli/run_style_inversion_sd.py``, flag for flag.

The style image repeated over frames makes every frame of the SD inversion
identical (the temporal layers are identities, GroupNorm and cross-frame
attention are frame-symmetric over identical frames), so it runs on a single
frame and the trajectory is tiled back to num_frames on save, in the
reference's ``ddim_latents_{i}.pt`` layout. AnimateDiff's motion modules
give each frame its own position, so that backbone inverts all num_frames
frames."""

from __future__ import annotations

import argparse
import os

import numpy as np

from univst_torch.cli.common import (
    add_mesh_flag, build_pipeline_from_args, check_backbone, generator_for, is_writer,
    make_output_tree,
)
from univst_torch.utils.io import load_style_image, save_video, seed_everything


def main(args):
    from univst_torch.core.trajectory import save_trajectory

    check_backbone(args)
    if args.seed is not None:
        seed_everything(args.seed)

    num_frames_out = args.num_frames
    # SD: invert one frame; all repeated frames evolve identically
    n_inv = num_frames_out if args.backbone == "animatediff" else 1
    pipe = build_pipeline_from_args(args, num_frames=n_inv)
    name = os.path.basename(args.style_path).split(".")[0]
    writer = is_writer(pipe.mesh)
    paths = make_output_tree(args.output_path, args.backbone, name, create=writer)

    frames = load_style_image(args.style_path, n_inv, (args.width, args.height))
    latents = pipe.encode_frames(frames, generator_for(pipe.device, args.seed or 0))
    context = pipe.encode_text(args.prompt)

    print("inversion:")
    traj, _ = pipe.invert(latents, context, num_steps=args.time_steps, is_opt=args.is_opt)
    reps = num_frames_out // n_inv
    if writer:
        save_trajectory(traj.repeat(1, reps, 1, 1, 1), paths["inversion"])

    print("reconstruction:")
    lat0 = pipe.reconstruct_latents(traj[-1], context, num_steps=args.time_steps)
    video = np.tile(pipe.decode_latents(lat0).cpu().numpy(), (reps, 1, 1, 1))
    if writer:
        save_video(video, os.path.join(paths["reconstruction"], "style_video.mp4"), fps=8)
    print(f"done -> {paths['base']}")


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--pretrained_model_path", type=str, default=None)
    p.add_argument("--style_path", type=str, default="examples/styles/00033.png")
    p.add_argument("--output_path", type=str, default="results/styles-inv")
    p.add_argument("--weight_dtype", type=str, default="bf16")
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--time_steps", type=int, default=50)
    p.add_argument("--is_opt", action="store_true", help="use EasyInv")
    p.add_argument("--seed", type=int, default=33)
    p.add_argument("--variant", type=str, default="sd15", choices=["sd15", "sd21", "tiny"])
    p.add_argument("--backbone", type=str, default="sd")
    p.add_argument("--prompt", type=str, default="",
                   help="inversion prompt (reference always uses ''; non-empty "
                        "prompts need tokenizer files under --pretrained_model_path)")
    p.add_argument("--platform", type=str, default=None, help="'cpu' or 'cuda' (default)")
    add_mesh_flag(p)
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
