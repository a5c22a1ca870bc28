"""The yardstick's arithmetic, frozen here: the card's peaks, the work of
one video flash attention call, and the FLOPs of one clip.

``vfa_work`` follows ``univst_torch/attention/video_flash.py::work``: each
query meets the keys of its frame's distinct source frames and the frame's
valid context keys, 4 * dh tensor FLOPs a meeting; the bytes are q read and
the output written once, the K/V of every frame that is some frame's source
and the context rows, each read once. The bound of a call is the larger of
its FLOPs at the bf16 tensor peak and its bytes at the memory peak. The
exponentials are left out: how they are computed (MUFU or FMA pipe) is the
kernel's choice, and both kernels are tensor-bound at every main shape
either way.
"""

from __future__ import annotations

from typing import Sequence

# NVIDIA H100 SXM (data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def vfa_work(b: int, f: int, h: int, lq: int, l: int, dh: int, indices: Sequence,
             ctx_valid: int = 0, itemsize: int = 2):
    """``(flops, bytes)`` of one call on ``[B, F, H, Lq, dh]`` queries and
    ``[B, F, H, L, dh]`` keys and values."""
    from benchmark.reference.common import frame_sources

    sources = [src for src, _ in frame_sources(indices, f)]
    keys = l * sum(len(s) for s in sources) + ctx_valid * f
    flops = 4.0 * dh * b * h * lq * keys
    used = len(set().union(*sources))
    nbytes = itemsize * b * h * dh * (2 * f * lq + 2 * used * l + 2 * f * ctx_valid)
    return flops, float(nbytes)


def vfa_bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


def decode_indices(s: str):
    """The index set as the ops carry it: comma-separated, ints or names."""
    return tuple(x if not x.lstrip("-").isdigit() else int(x) for x in s.split(","))


class FlopCount:
    """Counts the matmul, convolution and attention FLOPs of what runs
    inside it, with PyTorch's own formulas (``flop_registry``) and without
    ``FlopCounterMode``'s per-module bookkeeping; run it on the meta device."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry

        count = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                formula = flop_registry.get(func._overloadpacket)
                if formula is not None:
                    count.total += formula(*args, **kwargs, out_val=out)
                return out

        self.total = 0
        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        return False
