"""Shared CLI plumbing: device selection, dtype parsing, output trees.

Flags and output trees match ``univst_tpu.cli`` (common.py:55,70). The
device is CUDA unless ``--platform cpu`` asks for the CPU. ``--mesh
data=N[,tensor=M]`` runs the stages over the N x M ranks ``torchrun``
started (NCCL, one rank per card; gloo on the CPU): frame-parallel over
``data``, and for SD3 the MMDiT's linears split over ``tensor`` (SD and
AnimateDiff replicate over it, as the JAX package does); rank 0 writes the
output tree, the other ranks write nothing.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

NOT_PORTED = "is not ported to the PyTorch package yet (it runs in univst_tpu)"


def setup_device(platform: Optional[str] = None):
    """``--platform``: None or 'cuda'/'gpu' -> the GPU (raises without one),
    'cpu' -> the CPU."""
    from univst_torch.pipelines.sd import resolve_device

    if platform in (None, "", "cuda", "gpu"):
        return resolve_device(None)
    if platform == "cpu":
        return resolve_device("cpu")
    raise SystemExit(f"--platform {platform!r}: use 'cpu' or 'cuda'")


def parse_dtype(name: str):
    import torch

    return {
        "bf16": torch.bfloat16,
        "bfloat16": torch.bfloat16,
        "fp16": torch.bfloat16,  # fp16 requests map to bf16, as in univst_tpu
        "torch.float16": torch.bfloat16,
        "fp32": torch.float32,
        "float32": torch.float32,
    }[str(name)]


def make_output_tree(output_path: str, backbone: str, name: str, create: bool = True):
    """{out}/{backbone}/{name}/{inversion,reconstruction,features}
    (reference run_content_inversion_sd.py:60-66); ``create=False`` names the
    paths without making them (the ranks of a mesh that write nothing)."""
    base = os.path.join(output_path, backbone, name)
    paths = {
        "base": base,
        "inversion": os.path.join(base, "inversion"),
        "reconstruction": os.path.join(base, "reconstruction"),
        "features": os.path.join(base, "features"),
    }
    for p in paths.values() if create else ():
        os.makedirs(p, exist_ok=True)
    return paths


def save_feature_pt(feature, features_dir: str, ft_index: int, ft_timestep: int):
    """Save the captured decoder feature in the reference's format:
    ``inversion_feature_map_{i}_block_{t}_step.pt`` holding [F, H, W, C] fp16
    (unet_3d_condition.py:429-436)."""
    import torch

    path = os.path.join(
        features_dir, f"inversion_feature_map_{ft_index}_block_{ft_timestep}_step.pt"
    )
    torch.save(torch.as_tensor(feature).detach().float().cpu().to(torch.float16).contiguous(),
               path)
    print(f"save feature map at: {path}")
    return path


def load_feature_pt(path: str) -> np.ndarray:
    import torch

    return torch.load(path, weights_only=True, map_location="cpu").float().numpy()


def check_backbone(args) -> None:
    """The port runs the SD, AnimateDiff and SD3 backbones, on one device or
    over ``--mesh``; a malformed ``--mesh``, or a tensor axis that does not
    divide the SD3 MMDiT's heads, exits with the reason."""
    if getattr(args, "backbone", "sd") not in (None, "sd", "animatediff", "sd3"):
        raise SystemExit(f"--backbone {args.backbone} {NOT_PORTED}")
    spec = getattr(args, "mesh", None)
    if spec:
        from univst_torch.distributed.mesh import parse_mesh_axes

        try:
            axes = parse_mesh_axes(spec)
            if getattr(args, "backbone", "sd") == "sd3" and axes.n_tensor > 1:
                from univst_torch.distributed.tp import check_heads
                from univst_torch.pipelines.sd3 import _configs

                mcfg = _configs(getattr(args, "variant", None) or "sd3", None)[0]
                check_heads(mcfg.num_heads, axes.n_tensor, mcfg.head_dim)
        except ValueError as e:
            raise SystemExit(f"--mesh {spec}: {e}") from e


def setup_mesh(args):
    """The ``--mesh`` flag's mesh over the ``torchrun`` ranks (None without
    the flag); ``--platform cpu`` runs the ranks on the CPU over gloo."""
    check_backbone(args)
    spec = getattr(args, "mesh", None)
    if not spec:
        return None
    from univst_torch.distributed.mesh import parse_mesh_spec

    try:
        return parse_mesh_spec(spec, device="cpu" if args.platform == "cpu" else None)
    except ValueError as e:
        raise SystemExit(f"--mesh {spec}: {e}") from e


def is_writer(mesh) -> bool:
    """Whether this process writes outputs: rank 0 of a mesh, or the only
    process."""
    return mesh is None or mesh.rank == 0


def barrier(mesh) -> None:
    """Wait for every rank (rank 0's files are then on disk)."""
    if mesh is not None:
        import torch.distributed as dist

        dist.barrier(group=mesh.group)


def build_pipeline_from_args(args, capture_up_block=None, num_frames=None):
    """Construct the SD or AnimateDiff pipeline from the shared CLI flags
    (``univst_tpu/cli/common.py:90-118``), frame-parallel under ``--mesh``
    (``apply_mesh_arg``, :125-129)."""
    mesh = setup_mesh(args)
    kw = dict(
        pretrained_model_path=args.pretrained_model_path,
        num_frames=args.num_frames if num_frames is None else num_frames,
        dtype=parse_dtype(args.weight_dtype),
        capture_up_block=capture_up_block,
        seed=args.seed or 0,
        device=setup_device(args.platform) if mesh is None else mesh.device,
        mesh=mesh,
    )
    if args.backbone == "animatediff":
        from univst_torch.pipelines.animatediff import build_animatediff

        return build_animatediff(
            motion_module_path=getattr(args, "motion_module_path", None),
            dreambooth_path=getattr(args, "dreambooth_path", None),
            lora_path=getattr(args, "lora_path", None),
            lora_alpha=getattr(args, "lora_alpha", 0.8),
            variant="tiny" if args.variant == "tiny" else "ad",
            **kw,
        )
    from univst_torch.pipelines.sd import SDVideoPipeline

    return SDVideoPipeline.build(variant=args.variant, **kw)


def add_mesh_flag(parser):
    parser.add_argument("--mesh", type=str, default=None,
                        help="mesh over the torchrun ranks, 'data=N[,tensor=M][,hosts=H]' (or "
                             "'N'): frames over data, the SD3 MMDiT's linears over tensor")
    return parser


def generator_for(device, seed: int):
    import torch

    return torch.Generator(device=device).manual_seed(int(seed))


def singleton_style_or_fallback(pipe, style_rev, style_inv_path: str, time_steps: int):
    """The transfer CLIs' style-singleton guard (``univst_tpu/cli/
    common.py:142-166``): the fast path keeps one frame of the style
    trajectory, exact only when all its frames are identical (true for
    run_style_inversion_sd / _sd3 outputs). Another trajectory falls back to
    the exact non-singleton path (SD: capture-and-inject; SD3: the 3-branch
    batch) with a warning instead of silently dropping frames.

    Returns the (possibly replaced) pipeline and style trajectory.
    """
    import dataclasses
    import warnings

    from univst_torch.core.trajectory import style_frames_identical

    if style_frames_identical(style_inv_path, time_steps):
        return pipe, style_rev[:, :1]
    warnings.warn(f"style trajectory at {style_inv_path} has non-identical frames; "
                  "disabling the style-singleton fast path")
    return dataclasses.replace(pipe, style_singleton=False), style_rev
