"""Content-video rectified-flow inversion CLI (SD3/SD3.5 backbone) — port
of ``univst_tpu/cli/run_content_inversion_sd3.py``, flag for flag.

RF-Inversion (default) or RF-Solver (``--is_rf_solver``) over the MMDiT; the
trajectory is written in the reference format (``[F, C, H, W]`` fp16 per
step: SD3 batches frames), the block feature is captured for mask
propagation, and the controlled-velocity reconstruction is decoded as the
correctness oracle. Runs on CUDA unless ``--platform cpu``; under
``torchrun`` with ``--mesh data=N[,tensor=M]`` over a dp x tp mesh (rank 0
writes).
"""

from __future__ import annotations

import argparse
import os

from univst_torch.cli.common import (
    add_mesh_flag, generator_for, is_writer, make_output_tree, parse_dtype, save_feature_pt,
    setup_device, setup_mesh,
)
from univst_torch.utils.io import load_video, save_video, seed_everything

# frames a VAE decode takes at once: the decoder mixes no frames, and a
# 16-frame decode at 1024 px does not fit beside SD3.5-large on an 80 GB card
DECODE_CHUNK = 4


def build_sd3_pipeline(args, capture_block=None, num_frames=None):
    """Construct the SD3 pipeline from the shared CLI flags, on the
    ``--mesh`` of the torchrun ranks when one is given
    (``univst_tpu/cli/run_content_inversion_sd3.py:35,93``)."""
    from univst_torch.pipelines.sd3 import SD3VideoPipeline

    mesh = setup_mesh(args)
    return SD3VideoPipeline.build(
        pretrained_model_path=args.pretrained_model_path,
        variant=args.variant,
        num_frames=args.num_frames if num_frames is None else num_frames,
        dtype=parse_dtype(args.weight_dtype),
        capture_block=capture_block,
        seed=args.seed or 0,
        device=setup_device(args.platform) if mesh is None else mesh.device,
    ).with_mesh(mesh)


def main(args):
    from univst_torch.core.trajectory import save_trajectory

    if args.seed is not None:
        seed_everything(args.seed)

    pipe = build_sd3_pipeline(args, capture_block=args.ft_indices)
    name = os.path.basename(os.path.normpath(args.content_path)).split(".")[0]
    writer = is_writer(pipe.mesh)
    paths = make_output_tree(args.output_path, args.backbone, name, create=writer)

    # prompts are encoded once; the text encoders (T5-XXL: 9.5 GB) go before
    # the VAE encode, whose activations peak at 1024 px
    context, pooled = pipe.encode_prompt("")
    pipe.free_text_encoders()
    frames = load_video(args.content_path, args.num_frames, (args.width, args.height))
    latents = pipe.encode_frames(frames, generator_for(pipe.device, args.seed or 0))

    print("inversion:")
    traj, feat = pipe.invert(latents, context, pooled, num_steps=args.time_steps,
                             is_rf_solver=args.is_rf_solver, capture_step=args.ft_timesteps)
    if writer:
        save_trajectory(traj, paths["inversion"], reference_rank=4)
    if feat is not None and writer:
        save_feature_pt(feat, paths["features"], args.ft_indices, args.ft_timesteps)

    print("reconstruction:")
    lat0 = pipe.reconstruct_latents(traj[-1], latents, context, pooled,
                                    num_steps=args.time_steps, eta_base=0.85,
                                    eta_trend="constant", start_step=25, end_step=39)
    video = pipe.decode_latents(lat0, chunk=DECODE_CHUNK).cpu().numpy()
    if writer:
        save_video(video, os.path.join(paths["reconstruction"], "content_video.mp4"), fps=8)
    print(f"done -> {paths['base']}")


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--pretrained_model_path", type=str, default=None,
                   help="diffusers-layout checkpoint dir; random init if omitted")
    p.add_argument("--content_path", type=str, default="examples/contents/mallard-fly")
    p.add_argument("--output_path", type=str, default="results/contents-inv")
    p.add_argument("--weight_dtype", type=str, default="bf16")
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--time_steps", type=int, default=50)
    p.add_argument("--ft_indices", type=int, default=20, help="transformer block index")
    p.add_argument("--ft_timesteps", type=int, default=5, help="inversion step index")
    p.add_argument("--is_rf_solver", action="store_true", help="use RF-Solver")
    p.add_argument("--seed", type=int, default=33)
    p.add_argument("--variant", type=str, default="sd3", choices=["sd3", "sd35", "sd35m", "tiny"])
    p.add_argument("--backbone", type=str, default="sd3")
    p.add_argument("--platform", type=str, default=None, help="'cpu' or 'cuda' (default)")
    add_mesh_flag(p)
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
