"""Content-video DDIM inversion CLI (SD backbone) — port of
``univst_tpu/cli/run_content_inversion_sd.py``, flag for flag.

Inverts the content video with (optionally EasyInv) DDIM, writes the latent
trajectory as ``ddim_latents_{i}.pt`` (reference layout), captures the
up-block feature map for mask propagation, and writes a reconstruction
video as the correctness oracle. Runs on CUDA unless ``--platform cpu``;
frame-parallel under ``torchrun`` with ``--mesh data=N`` (rank 0 writes).
"""

from __future__ import annotations

import argparse
import os

from univst_torch.cli.common import (
    add_mesh_flag, build_pipeline_from_args, generator_for, is_writer, make_output_tree,
    save_feature_pt,
)
from univst_torch.utils.io import load_video, save_video, seed_everything


def main(args):
    from univst_torch.core.trajectory import save_trajectory

    if args.seed is not None:
        seed_everything(args.seed)

    pipe = build_pipeline_from_args(args, capture_up_block=args.ft_indices)
    name = os.path.basename(os.path.normpath(args.content_path)).split(".")[0]
    writer = is_writer(pipe.mesh)
    paths = make_output_tree(args.output_path, args.backbone, name, create=writer)

    frames = load_video(args.content_path, args.num_frames, (args.width, args.height))
    latents = pipe.encode_frames(frames, generator_for(pipe.device, args.seed or 0))
    context = pipe.encode_text(args.prompt)

    print("inversion:")
    traj, feat = pipe.invert(
        latents, context, num_steps=args.time_steps, is_opt=args.is_opt,
        capture_timestep=args.ft_timesteps,
    )
    if writer:
        save_trajectory(traj, paths["inversion"])
    if feat is not None and writer:
        save_feature_pt(feat, paths["features"], args.ft_indices, args.ft_timesteps)

    print("reconstruction:")
    lat0 = pipe.reconstruct_latents(traj[-1], context, num_steps=args.time_steps)
    video = pipe.decode_latents(lat0).cpu().numpy()
    if writer:
        save_video(video, os.path.join(paths["reconstruction"], "content_video.mp4"))
    print(f"done -> {paths['base']}")


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--pretrained_model_path", type=str, default=None,
                   help="diffusers-layout checkpoint dir; random init if omitted")
    p.add_argument("--content_path", type=str, default="examples/contents/mallard-fly")
    p.add_argument("--output_path", type=str, default="results/contents-inv")
    p.add_argument("--weight_dtype", type=str, default="bf16")
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--time_steps", type=int, default=50)
    p.add_argument("--ft_indices", type=int, default=2)
    p.add_argument("--ft_timesteps", type=int, default=301)
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
