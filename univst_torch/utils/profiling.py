"""Timing and tracing utilities, after ``univst_tpu/utils/profiling.py``: the
program's span recorder (:data:`SPANS`: the pipelines' stylization and
decode, its pre-pass, phases and steps), a ``torch.profiler`` trace scope
that carries those spans as ranges, and the split of a trace's device time
by kind of kernel.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import re
import time
from collections import defaultdict
from typing import List, NamedTuple, Optional

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


class Span(NamedTuple):
    """A finished span of :class:`SpanRecorder`. ``job`` is the id of the
    root span it ran under, ``parent`` the id of the span that enclosed it
    (None for a root). ``host_*_ns`` are ``time.perf_counter_ns`` at entry
    and exit. ``device_ms`` is the time on the card's stream between two
    CUDA events recorded at entry and exit: only for :data:`DEVICE_TIMED`
    spans of a job on a CUDA device, else None."""

    name: str
    id: int
    job: int
    parent: Optional[int]
    attrs: dict
    host_start_ns: int
    host_end_ns: int
    device_ms: Optional[float]


# spans that open a job (allocate its id); any other span opened outside one
# records nothing (see SpanRecorder)
ROOTS = ("stylize", "decode")
# spans that also record a CUDA event at entry and exit
DEVICE_TIMED = ("prepass", "phase1", "phase2", "step")
# the prefix of the profiler ranges the spans open in ranges mode, and the
# range of one video flash attention call (:func:`vfa_range`)
RANGE_PREFIX = "univst::"
VFA_RANGE = RANGE_PREFIX + "vfa "


class _OpenSpan:
    """One span site's span while it is open (see :meth:`SpanRecorder.span`)."""

    __slots__ = ("rec", "name", "attrs", "device", "rooted", "id", "job", "parent", "t0",
                 "events", "rf")

    def __init__(self, rec: "SpanRecorder", name: str, device, attrs: dict):
        self.rec, self.name, self.device, self.attrs = rec, name, device, attrs

    def __enter__(self):
        rec = self.rec
        stack = rec._open
        self.rooted = bool(stack) or self.name in ROOTS
        self.rf = self.events = self.t0 = None
        if rec.ranges:
            self.rf = torch.profiler.record_function(RANGE_PREFIX + self.name)
            self.rf.__enter__()
        if not self.rooted:
            return self
        root = stack[0] if stack else self
        if rec.events and (root is self or root.t0 is not None):
            self.id = next(rec._ids)
            self.job = root.id
            self.parent = stack[-1].id if stack else None
            self.device = root.device
            if self.name in DEVICE_TIMED and self.device is not None \
                    and torch.device(self.device).type == "cuda":
                self.events = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
                self.events[0].record(torch.cuda.current_stream(self.device))
            self.t0 = time.perf_counter_ns()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if self.rooted:
            rec._open.pop()
        if self.t0 is not None:
            t1 = time.perf_counter_ns()
            if self.events is not None:
                self.events[1].record(torch.cuda.current_stream(self.device))
            rec._done.append((self, t1))
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        return False


class SpanRecorder:
    """The program's span recorder, one a process (:data:`SPANS`), off by
    default; :func:`spans` turns it on for a block.

    A span site reads ``with SPANS.span(name, ...) if SPANS.on else NO_SPAN:``,
    so with the recorder off it costs one attribute check: nothing is
    allocated, no profiler range opened, no CUDA event recorded. On:

    * events: each span keeps its name, job, parent, attributes and host
      ``perf_counter_ns`` at entry and exit, and a :data:`DEVICE_TIMED` span
      of a job on a CUDA device records a CUDA event on the current stream
      at each end. :meth:`take` returns the finished spans.
    * ranges: each span also opens a ``torch.profiler.record_function``
      named ``univst::<name>``, so a profiled run holds the spans on the
      profiler's clock beside the device operations; the video flash
      attention wrappers open a range of their own per call
      (``attention/video_flash.py``).

    A root span (:data:`ROOTS`) opens a job and takes the job's ``device``.
    Outside a root a span records nothing; in ranges mode it still opens its
    range (the tools trace a pipeline's pieces, such as one step, outside
    ``stylize_latents``). No span synchronises."""

    def __init__(self):
        self.on = False  # events or ranges: the one flag a span site checks
        self.events = False
        self.ranges = False
        self._open: List[_OpenSpan] = []
        self._done: list = []
        self._ids = itertools.count()

    def span(self, name: str, device=None, **attrs) -> _OpenSpan:
        """A span named ``name`` with ``attrs`` (``device``: a root's device)."""
        return _OpenSpan(self, name, device, attrs)

    def take(self) -> List[Span]:
        """The spans finished since the last call, in the order they ended,
        and forgets them. Reads the CUDA events' times: the caller
        synchronises the card first (an event not yet reached raises)."""
        done, self._done = self._done, []
        out = []
        for s, t1 in done:
            ms = None if s.events is None else s.events[0].elapsed_time(s.events[1])
            out.append(Span(s.name, s.id, s.job, s.parent, s.attrs, s.t0, t1, ms))
        return out


SPANS = SpanRecorder()
NO_SPAN = contextlib.nullcontext()


def vfa_range(which: str, q_shape, k_shape, frame_indices, ctx_valid) -> str:
    """The profiler range of one video flash attention call in ranges mode:
    ``univst::vfa <k1|k2>|<index set>|<q shape>|<k shape>|<ctx_valid>``, each
    list comma-separated, ``ctx_valid`` 0 without context."""
    def dims(shape):
        return ",".join(str(int(d)) for d in shape)

    return VFA_RANGE + "|".join([which, ",".join(str(i) for i in frame_indices), dims(q_shape),
                                 dims(k_shape), str(int(ctx_valid or 0))])


def _is_range(name: str) -> bool:
    """A profiler range of the program's own: a norm range or a span's."""
    return name in _RANGES or name.startswith(VFA_RANGE)


_RANGES = {NORM_SCOPE} | {RANGE_PREFIX + n for n in ROOTS + DEVICE_TIMED}


@contextlib.contextmanager
def spans(events: bool = True, ranges: bool = False):
    """Turn :data:`SPANS` to ``events`` and ``ranges`` for the block, then back
    to what it was."""
    before = SPANS.events, SPANS.ranges
    SPANS.events, SPANS.ranges = events, ranges
    SPANS.on = events or ranges
    try:
        yield SPANS
    finally:
        SPANS.events, SPANS.ranges = before
        SPANS.on = any(before)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """``torch.profiler`` scope over the CPU and, where there is one, the
    card, with the span recorder's ranges on (``univst::<span>`` ranges, and
    one per video flash attention call); yields the profiler (for
    :func:`device_time_split`) and writes its Chrome trace to
    ``log_dir/trace.json.gz``. No-op, yielding None, when ``log_dir`` is
    None."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with spans(events=SPANS.events, ranges=True), profile(activities=acts) as prof:
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
    span the profiler records for a user range (the program's norm and span
    ranges)."""
    name = getattr(evt, "key", None) or evt.name
    return _is_device(evt) and not _is_range(name) and not getattr(evt, "is_user_annotation",
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
            if not _is_device(e) and e.self_device_time_total > 0 and not _is_range(e.key):
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
