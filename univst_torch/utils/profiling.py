"""Timing and tracing utilities — port of ``univst_tpu/utils/profiling.py``:
per-phase wall timers, a ``torch.profiler`` trace scope, and the split of a
trace's device time by kind of kernel.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import time
from collections import defaultdict
from typing import Dict, Optional

import torch
from torch import nn

# device-time categories of :func:`device_time_split`, in the order they are tried
CATEGORIES = ("k1", "k2", "sdpa", "conv", "gemm", "norm", "elementwise", "other")

# the video flash kernels of univst_torch/csrc/video_flash_attention.cu; the
# last template argument is the layout: false = K1 (head-major), true = K2
_VFA = re.compile(r"vfa_\w*kernel<(?:\d+, )?(true|false)>")

# the profiler range that :func:`annotate_norms` opens around each norm module
NORM_SCOPE = "univst::norm"


def _cuda_in_use() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


class PhaseTimer:
    """Accumulates wall-time per named phase; prints a one-line JSON report.
    A phase ends with ``torch.cuda.synchronize()`` once the process uses the
    card, so its time holds the device work it queued."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if _cuda_in_use():
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        return json.dumps(
            {
                k: {"total_s": round(v, 3), "calls": self.counts[k]}
                for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1])
            }
        )


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """``torch.profiler`` scope over the CPU and, where there is one, the
    card; yields the profiler (for :func:`device_time_split`) and writes its
    Chrome trace to ``log_dir/trace.json.gz``. No-op, yielding None, when
    ``log_dir`` is None."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
        if _cuda_in_use():
            torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json.gz"))


def sync(tree):
    """Wait for the card and return host copies of the tensors in ``tree``
    (nested tuples, lists and dicts)."""
    if _cuda_in_use():
        torch.cuda.synchronize()
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: sync(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(sync(v) for v in tree)
    return tree


@contextlib.contextmanager
def annotate_norms(*roots: nn.Module):
    """While active, each forward of a norm module under ``roots`` (a class
    whose name ends in ``Norm``: the port's GroupNorm and RMSNorm, PyTorch's
    LayerNorm and GroupNorm) runs inside a profiler range named
    :data:`NORM_SCOPE`, so :func:`device_time_split` can count the kernels
    those norms launch (the port's norms are fp32 elementwise and reduction
    ops, not norm kernels) as norm time."""
    from torch.profiler import record_function

    open_ranges = []

    def enter(module, args):
        rf = record_function(NORM_SCOPE)
        rf.__enter__()
        open_ranges.append(rf)

    def leave(module, args, out):
        open_ranges.pop().__exit__(None, None, None)

    hooks = []
    for root in roots:
        for m in root.modules():
            if type(m).__name__.endswith("Norm"):
                hooks += [m.register_forward_pre_hook(enter), m.register_forward_hook(leave)]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


def kernel_category(name: str) -> str:
    """The :data:`CATEGORIES` entry of a device kernel, by its name: K1 / K2
    (this repository's kernels), fused attention (cuDNN SDPA, flash, memory
    efficient), convolutions (cuDNN's implicit GEMMs and their layout
    transforms), GEMMs (cuBLAS / cuBLASLt ``nvjet`` / CUTLASS), group / layer
    norm kernels, PyTorch's elementwise and reduction kernels, anything else
    (memsets, copies). An RMS norm written as elementwise ops (the SD3.5 q/k
    norms) lands in ``elementwise``."""
    m = _VFA.search(name)
    if m:
        return "k2" if m.group(1) == "true" else "k1"
    n = name.lower()
    if any(s in n for s in ("sdpa", "flash", "fmha", "attention")):
        return "sdpa"
    if any(s in n for s in ("fprop", "dgrad", "wgrad", "conv", "nchwtonhwc", "nhwctonchw")):
        return "conv"
    if any(s in n for s in ("gemm", "nvjet", "cutlass", "cublas")):
        return "gemm"
    if any(s in n for s in ("norm", "rowwisemoments", "computefusedparams")):
        return "norm"
    if any(s in n for s in ("at::native", "elementwise", "reduce")):
        return "elementwise"
    return "other"


def _is_device(evt) -> bool:
    return str(getattr(evt, "device_type", "")).endswith("CUDA")


def _is_kernel(evt) -> bool:
    """A device event that is a kernel, memset or copy: not the device-side
    span the profiler records for a user range (:data:`NORM_SCOPE`)."""
    name = getattr(evt, "key", None) or evt.name
    return _is_device(evt) and name != NORM_SCOPE and not getattr(evt, "is_user_annotation",
                                                                   False)


def _in_scope(evt, scope: str) -> bool:
    while evt is not None:
        if evt.name == scope:
            return True
        evt = evt.cpu_parent
    return False


def device_time_split(prof) -> dict:
    """Sort a trace's device time into :data:`CATEGORIES`.

    Reads ``prof.key_averages()`` for the self device time of each kernel
    name, sorted by :func:`kernel_category`, except the kernels launched
    inside a :data:`NORM_SCOPE` range (:func:`annotate_norms`), which count
    as ``norm`` (their sum, ``norm_scoped_ms``, comes from the host ops'
    kernel lists); the device-side spans of those ranges are not kernels.
    ``top`` lists the kernels with the most time, ``top_ops`` the host ops
    whose own kernels take the most, ``vfa_calls_ms`` each K1 / K2 launch's
    time in order. ``prof.events()`` give the span of the
    trace (first event's start to last event's end, host and device:
    ``wall_ms``) and the union of the kernels' intervals (``busy_ms``);
    ``idle_share`` is ``1 - busy / wall``. A trace with no device time (a
    CPU-only trace, or a profiler that saw no CUDA activity) gives
    ``device_time_seen: False``, ``idle_share: None`` and zero sums; callers
    must not report those as measurements.
    """
    events = prof.events()
    scoped = defaultdict(float)  # kernel name -> us launched inside a norm range
    for e in events:
        if not _is_device(e) and e.kernels and _in_scope(e, NORM_SCOPE):
            for k in e.kernels:
                scoped[k.name] += k.duration
    ms = {c: 0.0 for c in CATEGORIES}
    top = []
    ops = []
    for e in prof.key_averages():
        if not _is_kernel(e):
            if not _is_device(e) and e.self_device_time_total > 0 and e.key != NORM_SCOPE:
                ops.append((e.self_device_time_total / 1e3, e.key, int(e.count)))
            continue
        us = float(e.self_device_time_total)
        in_norm = min(us, scoped.get(e.key, 0.0))
        cat = kernel_category(e.key)
        ms["norm"] += in_norm / 1e3
        ms[cat] += (us - in_norm) / 1e3
        top.append((us / 1e3, cat, e.key[:96], int(e.count)))
    spans = [(e.time_range.start, e.time_range.end) for e in events]
    kernel_events = sorted((e for e in events if _is_kernel(e)), key=lambda e: e.time_range.start)
    kernels = [(e.time_range.start, e.time_range.end) for e in kernel_events]
    vfa_calls = [[kernel_category(e.name), (e.time_range.end - e.time_range.start) / 1e3]
                 for e in kernel_events if _VFA.search(e.name)]
    busy, end = 0.0, float("-inf")
    for s, t in kernels:
        if t > end:
            busy += t - max(s, end)
            end = t
    wall = (max(t for _, t in spans) - min(s for s, _ in spans)) / 1e3 if spans else 0.0
    seen = busy > 0 and wall > 0
    out = dict(device_ms=ms, norm_scoped_ms=sum(scoped.values()) / 1e3, busy_ms=busy / 1e3,
               wall_ms=wall, kernels=len(kernels),
               idle_share=1.0 - busy / 1e3 / wall if seen else None, device_time_seen=seen,
               top=[dict(ms=t, category=c, name=n, calls=k) for t, c, n, k in
                    sorted(top, reverse=True)[:8]],
               top_ops=[dict(ms=t, op=n, calls=k) for t, n, k in sorted(ops, reverse=True)[:10]],
               vfa_calls_ms=vfa_calls)
    if not seen:
        out["note"] = "the trace holds no device time"
    return out
