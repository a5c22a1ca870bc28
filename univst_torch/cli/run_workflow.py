"""One-process UniVST workflow driver — port of
``univst_tpu/cli/run_workflow.py``, flag for flag.

Runs the 4-stage workflow (content inversion, style inversion, mask
propagation, video style transfer — the reference's scripts/start_*.sh)
in one Python process. Each stage reuses the stage CLI's own parser and
``main`` with the argv scripts/start_*.sh would pass, so flags and output
layouts are those of the separate stage CLIs. Runs on CUDA unless
``--platform cpu``; the SD, AnimateDiff and SD3 backbones are ported.
``--mesh data=N[,tensor=M]`` runs the stages over the N x M ranks
``torchrun`` started (NCCL, one rank per card): frame-parallel over
``data``; for SD3 the MMDiT's linears split over ``tensor`` (SD and
AnimateDiff replicate over it). Every rank runs every stage, rank 0 alone
writes the tree (and propagates the masks), and the ranks meet after each
stage. A tensor axis that does not divide the SD3 MMDiT's heads exits with
the reason.

Usage:
  python -m univst_torch.cli.run_workflow --backbone sd \
      --content_path examples/contents/demo-fly \
      --style_path examples/styles/00033.png \
      --mask_path examples/masks/demo-fly.png [--output_root results]
  torchrun --nproc_per_node 4 -m univst_torch.cli.run_workflow --backbone sd \
      --mesh data=4 ...
  torchrun --nproc_per_node 4 -m univst_torch.cli.run_workflow --backbone sd3 \
      --mesh data=2,tensor=2 ...
"""

from __future__ import annotations

import argparse
import gc
import importlib
import os
import time

from univst_torch.cli.common import barrier, is_writer, setup_mesh

_STAGE_MODULES = {
    "sd": ("run_content_inversion_sd", "run_style_inversion_sd",
           "run_video_style_transfer_sd"),
    "animatediff": ("run_content_inversion_animatediff",
                    "run_style_inversion_animatediff",
                    "run_video_style_transfer_animatediff"),
    "sd3": ("run_content_inversion_sd3", "run_style_inversion_sd3",
            "run_video_style_transfer_sd3"),
}


def _argv_for(parser: argparse.ArgumentParser, flags: dict) -> list[str]:
    """An argv for ``parser`` from ``flags``, dropping options the parser does
    not know and None/False values; True renders as a bare flag."""
    known = {s for a in parser._actions for s in a.option_strings}
    argv: list[str] = []
    for k, v in flags.items():
        if k not in known or v is None or v is False:
            continue
        if v is True:
            argv.append(k)
        else:
            argv.extend([k, str(v)])
    return argv


def main(args):
    mesh = setup_mesh(args)
    ci_mod, si_mod, st_mod = (importlib.import_module(f"univst_torch.cli.{m}")
                              for m in _STAGE_MODULES[args.backbone])
    mp_mod = importlib.import_module("univst_torch.cli.mask_propagation")

    # the stage CLIs' own name derivations, so predicted paths never diverge
    name = os.path.basename(os.path.normpath(args.content_path)).split(".")[0]
    sname = os.path.basename(args.style_path).split(".")[0]
    mname = os.path.basename(args.mask_path).split(".")[0]
    root = args.output_root
    stages = (args.stages.split(",") if args.stages != "all"
              else ["content", "style", "mask", "transfer"])
    unknown = set(stages) - {"content", "style", "mask", "transfer"}
    if unknown:
        raise SystemExit(f"unknown --stages {sorted(unknown)}; valid: "
                         "content,style,mask,transfer")

    shared = {
        "--pretrained_model_path": args.pretrained_model_path,
        "--variant": args.variant,
        "--platform": args.platform,
        "--num_frames": args.num_frames,
        "--height": args.height,
        "--width": args.width,
        "--time_steps": args.time_steps,
        "--weight_dtype": args.weight_dtype,
        "--seed": args.seed,
        "--motion_module_path": args.motion_module_path,
        "--dreambooth_path": args.dreambooth_path,
        "--lora_path": args.lora_path,
        "--mesh": args.mesh,
    }

    t_all = time.time()
    ft_i, ft_t = args.ft_indices, args.ft_timesteps

    def run(label, mod, flags, ranks_all: bool = True):
        parser = mod.build_parser()
        stage_args = parser.parse_args(_argv_for(parser, flags))
        t0 = time.time()
        if ranks_all or is_writer(mesh):
            mod.main(stage_args)
        gc.collect()  # drop the stage pipeline before the next build
        barrier(mesh)  # the next stage reads what rank 0 wrote
        if is_writer(mesh):
            print(f"[workflow] {label}: {time.time() - t0:.1f}s", flush=True)
        return stage_args

    if "content" in stages:
        a = run("content inversion", ci_mod, {
            **shared,
            "--content_path": args.content_path,
            "--output_path": f"{root}/contents-inv",
            "--is_opt": args.backbone in ("sd", "animatediff"),
            "--is_rf_solver": args.backbone == "sd3",
            "--ft_indices": args.ft_indices,
            "--ft_timesteps": args.ft_timesteps,
        })
        ft_i, ft_t = a.ft_indices, a.ft_timesteps
    if "style" in stages:
        run("style inversion", si_mod, {
            **shared,
            "--style_path": args.style_path,
            "--output_path": f"{root}/styles-inv",
            "--is_rf_solver": args.backbone == "sd3",
        })
    if "mask" in stages:
        if ft_i is None:  # not given + stage skipped: read the CLI defaults
            p = ci_mod.build_parser().parse_args([])
            ft_i, ft_t = p.ft_indices, p.ft_timesteps
        feature = (f"{root}/contents-inv/{args.backbone}/{name}/features/"
                   f"inversion_feature_map_{ft_i}_block_{ft_t}_step.pt")
        run("mask propagation", mp_mod, {
            "--feature_path": feature,
            "--backbone": args.backbone,
            "--mask_path": args.mask_path,
            "--output_path": f"{root}/masks",
            "--num_frames": args.num_frames,
            "--platform": args.platform,
        }, ranks_all=False)
    if "transfer" in stages:
        run("style transfer", st_mod, {
            **shared,
            "--content_inv_path": f"{root}/contents-inv/{args.backbone}/{name}/inversion",
            "--style_inv_path": f"{root}/styles-inv/{args.backbone}/{sname}/inversion",
            "--mask_path": f"{root}/masks/{args.backbone}/{mname}",
            "--output_path": f"{root}/stylizations",
            "--smoother": args.smoother,
            "--flow": args.flow,
        })
    if is_writer(mesh):
        where = ("one process" if mesh is None
                 else f"{mesh.n_data} x {mesh.n_tensor} ranks (data x tensor)")
        print(f"[workflow] total ({args.backbone}, {where}): {time.time() - t_all:.1f}s")


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--backbone", type=str, default="sd", choices=list(_STAGE_MODULES))
    p.add_argument("--content_path", type=str, default="examples/contents/demo-fly")
    p.add_argument("--style_path", type=str, default="examples/styles/00033.png")
    p.add_argument("--mask_path", type=str, default="examples/masks/demo-fly.png")
    p.add_argument("--output_root", type=str, default="results")
    p.add_argument("--stages", type=str, default="all",
                   help="comma subset of content,style,mask,transfer "
                        "(earlier stage outputs must already exist)")
    p.add_argument("--pretrained_model_path", type=str, default=None)
    p.add_argument("--variant", type=str, default=None)
    p.add_argument("--platform", type=str, default=None, help="'cpu' or 'cuda' (default)")
    p.add_argument("--num_frames", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--time_steps", type=int, default=None)
    p.add_argument("--weight_dtype", type=str, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--mesh", type=str, default=None,
                   help="mesh over the torchrun ranks, 'data=N[,tensor=M]': frames over data, "
                        "the SD3 MMDiT's linears over tensor")
    p.add_argument("--smoother", type=str, default=None)
    p.add_argument("--flow", type=str, default=None)
    p.add_argument("--motion_module_path", type=str, default=None)
    p.add_argument("--dreambooth_path", type=str, default=None)
    p.add_argument("--lora_path", type=str, default=None)
    p.add_argument("--ft_indices", type=int, default=None,
                   help="feature-capture block index (forwarded to the content stage "
                        "and used to locate its feature map when --stages skips it)")
    p.add_argument("--ft_timesteps", type=int, default=None,
                   help="feature-capture timestep (same forwarding rule)")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
