"""Style-image rectified-flow inversion CLI (SD3/SD3.5 backbone) — port of
``univst_tpu/cli/run_style_inversion_sd3.py``, flag for flag.

The style image repeated over frames makes every frame of the inversion
identical (the MMDiT has no per-frame state and attends frame 0 and its
neighbours, all equal), so it runs on a single frame and the trajectory is
tiled back to num_frames on save, in the reference's ``[F, C, H, W]``
``ddim_latents_{i}.pt`` layout. Runs on CUDA unless ``--platform cpu``;
under ``--mesh`` every data rank runs the frame on its tensor share of the
MMDiT (rank 0 writes)."""

from __future__ import annotations

import argparse
import os

import numpy as np

from univst_torch.cli.common import add_mesh_flag, generator_for, is_writer, make_output_tree
from univst_torch.cli.run_content_inversion_sd3 import build_sd3_pipeline
from univst_torch.utils.io import load_style_image, save_video, seed_everything


def main(args):
    from univst_torch.core.trajectory import save_trajectory

    if args.seed is not None:
        seed_everything(args.seed)

    num_frames_out = args.num_frames
    pipe = build_sd3_pipeline(args, num_frames=1)  # invert one frame
    name = os.path.basename(args.style_path).split(".")[0]
    writer = is_writer(pipe.mesh)
    paths = make_output_tree(args.output_path, args.backbone, name, create=writer)

    context, pooled = pipe.encode_prompt("")
    pipe.free_text_encoders()
    frames = load_style_image(args.style_path, 1, (args.width, args.height))
    latents = pipe.encode_frames(frames, generator_for(pipe.device, args.seed or 0))

    print("inversion:")
    traj, _ = pipe.invert(latents, context, pooled, num_steps=args.time_steps,
                          is_rf_solver=args.is_rf_solver)
    if writer:
        save_trajectory(traj.repeat(1, num_frames_out, 1, 1, 1), paths["inversion"],
                        reference_rank=4)

    print("reconstruction:")
    lat0 = pipe.reconstruct_latents(traj[-1], latents, context, pooled,
                                    num_steps=args.time_steps, eta_base=0.85,
                                    eta_trend="constant", start_step=25, end_step=39)
    video = np.tile(pipe.decode_latents(lat0).cpu().numpy(), (num_frames_out, 1, 1, 1))
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
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--time_steps", type=int, default=50)
    p.add_argument("--is_rf_solver", action="store_true")
    p.add_argument("--seed", type=int, default=33)
    p.add_argument("--variant", type=str, default="sd3", choices=["sd3", "sd35", "sd35m", "tiny"])
    p.add_argument("--backbone", type=str, default="sd3")
    p.add_argument("--platform", type=str, default=None, help="'cpu' or 'cuda' (default)")
    add_mesh_flag(p)
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
