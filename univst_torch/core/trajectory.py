"""Latent-trajectory store (PyTorch port of ``univst_tpu/core/trajectory.py``).

The reference persists every per-step inversion latent as
``ddim_latents_{i}.pt`` (inversion_tools/ddim_inversion.py:95-111) and the
stages hand off through those files, so the format is kept byte for byte:
torch fp16 tensors, the reference names and its ``[1, C, F, H, W]`` layout
(``[F, C, H, W]`` for SD3, which batches frames). In memory a trajectory is
one stacked ``[T+1, F, H, W, C]`` tensor.
"""

from __future__ import annotations

import os

import torch


def _to_reference_layout(x: torch.Tensor) -> torch.Tensor:
    """[F, H, W, C] -> [1, C, F, H, W] (the reference's torch layout)."""
    return x.permute(3, 0, 1, 2)[None]


def _from_reference_layout(x: torch.Tensor) -> torch.Tensor:
    """[1, C, F, H, W] (or [F, C, H, W] for SD3) -> [F, H, W, C]."""
    if x.ndim == 5:
        return x[0].permute(1, 2, 3, 0)
    if x.ndim == 4:  # SD3 stores [F, C, H, W] (frames as batch)
        return x.permute(0, 2, 3, 1)
    raise ValueError(f"unexpected latent rank {x.ndim}")


def save_trajectory(trajectory, path: str, reference_rank: int = 5) -> None:
    """Write ``ddim_latents_{i}.pt`` for every step i (reference filenames).

    ``trajectory`` is ``[T+1, F, H, W, C]`` (tensor on any device, or numpy).
    ``reference_rank`` 5 writes ``[1, C, F, H, W]`` (SD / AnimateDiff), 4
    writes ``[F, C, H, W]`` (SD3, flow_inversion.py:149-151).
    """
    if reference_rank not in (4, 5):
        raise ValueError(f"reference_rank must be 4 or 5, got {reference_rank}")
    os.makedirs(path, exist_ok=True)
    traj = torch.as_tensor(trajectory).detach().cpu()
    for i in range(traj.shape[0]):
        x = traj[i].float()
        ref = _to_reference_layout(x) if reference_rank == 5 else x.permute(0, 3, 1, 2)
        # fp32 -> fp16 on the host, as numpy's astype does in the JAX package
        ref = ref.to(torch.float16).contiguous()
        torch.save(ref, os.path.join(path, f"ddim_latents_{i}.pt"))


def load_latents_at_t(t: int, path: str) -> torch.Tensor:
    """Load one reference-format latent file -> ``[F, H, W, C]`` fp32 (CPU)."""
    fp = os.path.join(path, f"ddim_latents_{t}.pt")
    if not os.path.exists(fp):
        raise FileNotFoundError(f"Missing latents at t {t} path {fp}")
    x = torch.load(fp, weights_only=True, map_location="cpu").float()
    return _from_reference_layout(x).contiguous()


def style_frames_identical(path: str, num_steps: int) -> bool:
    """Whether every frame of the stored trajectory equals frame 0 (the
    style-singleton precondition), checked on a few sampled step files."""
    for t in sorted({0, num_steps // 2, num_steps}):
        x = load_latents_at_t(t, path)
        if x.shape[0] > 1 and not torch.allclose(x, x[:1].expand_as(x), atol=1e-6, rtol=0.0):
            return False
    return True


def load_trajectory(path: str, num_steps: int, reverse: bool = False,
                    device="cpu") -> torch.Tensor:
    """Load ``ddim_latents_{0..T}`` as one stacked ``[T+1, F, H, W, C]`` fp32
    tensor; with ``reverse`` index i holds ``ddim_latents_{T-i}`` (the order
    the stylization loop consumes, reference stable_diffusion.py:683)."""
    idxs = range(num_steps, -1, -1) if reverse else range(num_steps + 1)
    return torch.stack([load_latents_at_t(i, path) for i in idxs]).to(device)
