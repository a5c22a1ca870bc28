"""GroupNorm with optional cross-frame statistics: the plain chain and the
CUDA kernel's wrapper.

* :func:`group_norm_plain` is the eager chain (fp32 statistics and affine,
  float64 on a float64 input), the form every call the kernel does not take
  (CPU, fp32, contiguous, the sharded frame-spanning form) runs, and the
  plain version the kernel is held to.
* :func:`group_norm_cuda` launches ``univst_torch/csrc/group_norm.cu`` on a
  bf16 CUDA tensor in channels-last (the layout the UNet and the VAEs run
  in): the same function in one pass over the statistics and one over the
  output, with the SiLU that follows most norms fused before the
  single bf16 rounding. It replaces no TPU kernel (the JAX package leaves
  GroupNorm to XLA); the chain moved ~52 bytes an element, the kernel 4-6.

``group_norm_cuda.launches`` counts the calls that ran the kernel and
``group_norm_cuda.eager_cuda`` the CUDA calls of ``layers.GroupNorm`` that
took the chain (``layers.GroupNorm.forward`` dispatches).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from univst_torch.utils import profiling

_KERNEL = "group_norm"
# the kernel's blocks have 512 threads (two fit an SM); a plan aims at four
# blocks an SM (two waves) and at least four 16-byte loads a thread a slice
_THREADS, _SLICE_LOADS, _BLOCKS_PER_SM = 512, 4, 4
_fns = {}
_sms = {}


def group_norm_plain(x, weight, bias, groups: int, eps: float, frames: int = 1, shard=None):
    """GroupNorm of ``x [N, C, *spatial]``, statistics per (video, group) over
    ``frames`` consecutive frames (``N = videos x frames``), in fp32 (float64
    on a float64 input); the result in ``x``'s dtype. Under a frame ``shard``
    the frame-spanning statistics combine every rank's
    (``comm.sharded_var_mean``)."""
    n, c = x.shape[:2]
    g = groups
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    if frames > 1 or shard is not None:
        xg = xf.reshape(n // frames, frames, g, c // g, -1)
        dims = (1, 3, 4)
    else:
        xg = xf.reshape(n, g, c // g, -1)
        dims = (2, 3)
    if shard is None:
        var, mean = torch.var_mean(xg, dim=dims, unbiased=False, keepdim=True)
    else:
        from univst_torch.distributed.comm import sharded_var_mean

        var, mean = sharded_var_mean(xg, dims, shard, site="group_norm")
    xn = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.dim() - 2)
    out = xn * weight.to(xf.dtype).reshape(shape) + bias.to(xf.dtype).reshape(shape)
    return out.to(x.dtype)


class Plan(NamedTuple):
    """How the kernel covers a call: ``videos`` of ``rows`` rows each
    (``frames * H * W``), ``slices`` blocks a video of ``chunk`` rows."""

    videos: int
    rows: int
    slices: int
    chunk: int


@functools.lru_cache(maxsize=512)
def plan(n: int, c: int, hw: int, frames: int, sms: int) -> Plan:
    """The kernel's slicing of channels-last ``x [n, hw, c]`` from its shape
    and the card's SM count: each video's ``frames * hw`` rows are cut into
    enough slices for the blocks to fill ``sms`` SMs four deep, each slice
    at least four rounds of a block's rows (a multiple of 8 rows)."""
    videos, rows = n // frames, frames * hw
    least = _THREADS // (c // 8) * _SLICE_LOADS
    s = max(1, min(-(-sms * _BLOCKS_PER_SM // videos), rows // least))
    chunk = -(-(-(-rows // s)) // 8) * 8  # ceil(rows / s), rounded up to a multiple of 8
    return Plan(videos, rows, -(-rows // chunk), chunk)


@functools.lru_cache(maxsize=256)
def rows_fit(c: int, groups: int) -> bool:
    """The kernel's condition on the channels: whole 16-byte vectors a row,
    a block holding a row, at most 128 groups, and each vector of 8
    channels within two groups."""
    cg = c // groups
    return (c % 8 == 0 and c <= 8 * _THREADS and groups <= 128
            and all(v % cg + 8 <= 2 * cg for v in range(0, c, 8)))


def fits(x, groups: int) -> bool:
    """Whether :func:`group_norm_cuda` takes a bf16 CUDA ``x``: 4-d and
    channels-last (the layout the UNet and the VAEs run in), 16-byte
    aligned, with channels that :func:`rows_fit`. A contiguous
    (channels-first) input takes the eager chain."""
    return (x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last)
            and x.data_ptr() % 16 == 0 and rows_fit(x.shape[1], groups))


def _kernel_fn():
    fn = _fns.get(_KERNEL)
    if fn is None:
        from univst_torch._build import load_library

        fn = load_library(_KERNEL).univst_group_norm
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float] \
            + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[_KERNEL] = fn
    return fn


def _sm_count(device: int) -> int:
    sms = _sms.get(device)
    if sms is None:
        sms = _sms[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return sms


def group_norm_cuda(x, weight, bias, groups: int, frames: int, eps: float, silu: bool = False):
    """:func:`group_norm_plain` of a bf16 CUDA ``x [N, C, H, W]`` that the
    kernel takes (:func:`fits`; no shard), followed by ``y * sigmoid(y)``
    when ``silu``, in the kernel: statistics and affine in fp32, one rounding
    to bf16; ``y`` channels-last like ``x``. ``weight``, ``bias``: ``[C]``,
    bf16 or fp32, on ``x``'s device. Launches on the current stream; no
    gradient."""
    if not (x.dtype == torch.bfloat16 and x.is_cuda and fits(x, groups)):
        raise ValueError(f"want a bf16 CUDA tensor the kernel takes, got {x.dtype} "
                         f"{tuple(x.shape)} {x.stride()} on {x.device}")
    c = x.shape[1]
    for p in (weight, bias):
        if p.shape != (c,) or p.device != x.device or not p.is_contiguous():
            raise ValueError(f"want weight and bias [{c}] on {x.device}")
    return launch(x, weight, bias, groups, frames, eps, silu)


def launch(x, weight, bias, groups: int, frames: int, eps: float, silu: bool):
    """:func:`group_norm_cuda` without its checks of ``x``'s layout and of the
    parameters' shape and device (``layers.GroupNorm`` has made them)."""
    n, c = x.shape[0], x.shape[1]
    if c % groups or n % frames or x.numel() == 0 or weight.dtype != bias.dtype \
            or weight.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{tuple(x.shape)}: {groups} groups, {frames} frames a video, "
                         f"parameters {weight.dtype} / {bias.dtype}")
    hw = x.numel() // (n * c)
    dev = x.get_device()
    p = plan(n, c, hw, frames, _sm_count(dev))
    y = torch.empty_like(x)
    part = torch.empty(2 * p.videos * p.slices * groups, dtype=torch.float32, device=x.device)
    err = _kernel_fn()(x.data_ptr(), y.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                       part.data_ptr(), n, c, hw, groups, frames, p.slices, p.chunk,
                       float(eps), int(silu), int(weight.dtype == torch.bfloat16), dev,
                       torch._C._cuda_getCurrentRawStream(dev))  # the current stream's handle
    if err:
        raise RuntimeError(f"group_norm kernel launch failed: CUDA error {err}")
    group_norm_cuda.launches += 1
    return y


group_norm_cuda.launches = 0
group_norm_cuda.eager_cuda = 0
profiling.JOB_COUNTERS.update(group_norm_launches=lambda: group_norm_cuda.launches,
                              group_norm_eager_cuda=lambda: group_norm_cuda.eager_cuda)
