"""The traced run's device trace, reduced to what the per-layer readers read.

The profiler records the host's ops and the card's kernels, copies and
sets, without input shapes (recording them costs the host more on every
op). The reduction keeps, per device operation: its name, its interval,
the host op that launched it (by the profiler's correlation ids) and
whether that launch fell inside a norm range (the program's
``annotate_norms``); plus, for each video flash attention kernel, the
index set and shapes of its call (from the range ``label_vfa_calls``
opens around the call), and the host's window ranges.

``kernel_category`` and the interval arithmetic are copies of
``univst_torch/utils/profiling.py``'s, frozen here so that a change to the
program cannot change the yardstick.
"""

from __future__ import annotations

import bisect
import contextlib
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from benchmark.roofline import decode_indices

WINDOW_SCOPE = "benchmark::clip"  # the harness's range around each traced clip
NORM_SCOPE = "univst::norm"  # the range the program's annotate_norms opens
VFA_LABEL = "benchmark::vfa "  # + the call's index set and shapes (label_vfa_calls)

# the video flash kernels; the last template argument is the layout:
# false = K1 (head-major), true = K2 (token-major)
_VFA = re.compile(r"vfa_\w*kernel<(?:\d+, )?(true|false)>")


def kernel_category(name: str) -> str:
    """k1 / k2, sdpa, conv, gemm, norm, elementwise or other, by the kernel's
    name (copied from ``univst_torch/utils/profiling.py``)."""
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


def union_length(intervals: List[Tuple[int, int]]) -> int:
    """Length of the union of ``(start, end)`` intervals."""
    busy, end = 0, None
    for s, t in sorted(intervals):
        if end is None or s > end:
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    return busy


class _Ranges:
    """Sorted, possibly nested host ranges; ``covers(t)``: is ``t`` inside one."""

    def __init__(self, ranges: List[Tuple[int, int]]):
        merged = []
        for s, t in sorted(ranges):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        self.starts = [s for s, _ in merged]
        self.ends = [t for _, t in merged]

    def covers(self, t: int) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t < self.ends[i]


class DeviceTrace:
    """One traced window, in ns on the profiler's clock.

    ``ops``: ``(name, start, end, launcher, in_norm)`` per device operation
    (kernels, copies, sets; not the device side of user ranges), sorted by
    start; ``launcher`` is the launching host op's name or None.
    ``vfa_calls``: per kernel (``"k1"``, ``"k2"``), ``(call, kernel_ns)`` of
    each labelled call that launched it, ``call`` being
    ``(q_shape, k_shape, indices, ctx_valid)``. ``window``: ``(start, end)``
    of the harness's clip ranges."""

    def __init__(self, events):
        cpu_ops: Dict[int, Tuple[str, int]] = {}
        norm, windows, labels = [], [], []
        device = []
        for e in events:
            dev = str(e.device_type()).endswith("CUDA")
            name = e.name()
            if not dev:
                if name == NORM_SCOPE:
                    norm.append((e.start_ns(), e.end_ns()))
                elif name == WINDOW_SCOPE:
                    windows.append((e.start_ns(), e.end_ns()))
                elif name.startswith(VFA_LABEL):
                    labels.append((e.start_ns(), e.end_ns(), name[len(VFA_LABEL):]))
                cpu_ops[e.correlation_id()] = (name, e.start_ns())
            elif not e.is_user_annotation() and name not in (NORM_SCOPE, WINDOW_SCOPE) \
                    and not name.startswith(VFA_LABEL):
                device.append(e)
        ranges = _Ranges(norm)
        self.window = ((min(s for s, _ in windows), max(t for _, t in windows))
                       if windows else None)
        self.ops = []
        labels.sort()
        label_starts = [s for s, _, _ in labels]
        # each video flash kernel belongs to the labelled call whose host
        # range holds its launch; a call's kernel time is summed
        per_call: Dict[int, int] = defaultdict(int)
        for e in device:
            op = cpu_ops.get(e.linked_correlation_id())
            launched = None if op is None else op[1]
            self.ops.append((e.name(), e.start_ns(), e.end_ns(), None if op is None else op[0],
                             launched is not None and ranges.covers(launched)))
            which = kernel_category(e.name())
            if launched is None or which not in ("k1", "k2"):
                continue
            i = bisect.bisect_right(label_starts, launched) - 1
            if i >= 0 and launched <= labels[i][1] and labels[i][2].startswith(which + "|"):
                per_call[i] += e.end_ns() - e.start_ns()
        self.ops.sort(key=lambda o: o[1])
        self.vfa_calls: Dict[str, list] = {"k1": [], "k2": []}
        for i, ns in sorted(per_call.items()):
            which, call = decode_label(labels[i][2])
            self.vfa_calls[which].append((call, ns))
        self.vfa_labels = len(labels)
        self.launchers_found = sum(o[3] is not None for o in self.ops)
        self.norm_ranges = len(norm)
        self._busy = None

    def in_window(self):
        if self.window is None:
            return self.ops
        a, b = self.window
        return [o for o in self.ops if o[2] > a and o[1] < b]

    def busy_ns(self) -> int:
        if self._busy is None:
            a, b = self.window if self.window else (None, None)
            iv = [(max(s, a) if a else s, min(t, b) if b else t)
                  for _, s, t, _, _ in self.in_window()]
            self._busy = union_length([x for x in iv if x[1] > x[0]])
        return self._busy

    def window_ns(self) -> Optional[int]:
        return None if self.window is None else self.window[1] - self.window[0]

    def breakdown(self) -> dict:
        """The ten device operations that took most time, by name, and the
        ten longest idle gaps, by the host op that launched the operation
        the device waited for, in seconds."""
        by_name = defaultdict(int)
        gaps = defaultdict(int)
        ops = self.in_window()
        end = self.window[0] if self.window else None
        for name, s, t, launcher, _ in ops:
            by_name[name] += t - s
            if end is not None and s > end:
                gaps[launcher or "(unknown)"] += s - end
            end = t if end is None else max(end, t)
        if self.window and end is not None and self.window[1] > end:
            gaps["(after the last operation)"] += self.window[1] - end

        def top(d):
            return [[k[:200], v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

        return {"device_ops": top(by_name), "idle_gaps": top(gaps)}


def encode_label(which: str, q_shape, k_shape, indices, ctx_valid: int) -> str:
    """A labelled call as its range's name carries it:
    ``k1|<indices>|<q shape>|<k shape>|<ctx_valid>``."""
    def dims(shape):
        return ",".join(str(int(d)) for d in shape)

    return "|".join([which, ",".join(str(i) for i in indices), dims(q_shape), dims(k_shape),
                     str(int(ctx_valid))])


def decode_label(label: str):
    """``(which, (q_shape, k_shape, indices, ctx_valid))`` of a label."""
    which, idx, q, k, ctx = label.split("|")

    def dims(s):
        return tuple(int(d) for d in s.split(","))

    return which, (dims(q), dims(k), decode_indices(idx), int(ctx))


@contextlib.contextmanager
def label_vfa_calls():
    """While active, each call of the program's video flash attention
    wrappers runs inside a profiler range whose name carries the kernel,
    the index set, the q and k shapes and the context length
    (``encode_label``), so that the trace needs no recorded shapes. Only the
    traced run uses it; the arguments and results pass through unchanged,
    and the wrappers' launch counters keep counting."""
    from torch.profiler import record_function

    import univst_torch.attention.video_flash as vf

    names = {"video_flash_attention": "k1", "video_flash_attention_tokens": "k2"}
    originals = {n: getattr(vf, n) for n in names}

    def labelled(fn, which):
        def call(q, k, v, frame_indices, *args, **kwargs):
            params = dict(zip(("sm_scale", "ctx_k", "ctx_v", "ctx_valid", "tables"), args))
            params.update(kwargs)
            ctx_k, ctx = params.get("ctx_k"), params.get("ctx_valid")
            if ctx is None:
                ctx = 0 if ctx_k is None else ctx_k.shape[3 if which == "k1" else 2]
            label = encode_label(which, q.shape, k.shape, frame_indices, ctx)
            with record_function(VFA_LABEL + label):
                return fn(q, k, v, frame_indices, *args, **kwargs)

        call.launches = fn.launches
        return call

    wrappers = {n: labelled(fn, names[n]) for n, fn in originals.items()}
    for n, w in wrappers.items():
        setattr(vf, n, w)
    try:
        yield
    finally:
        for n, fn in originals.items():
            fn.launches = wrappers[n].launches
            setattr(vf, n, fn)


def capture():
    """A ``torch.profiler.profile`` over the host and the card, without
    shapes."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def reduce(prof) -> DeviceTrace:
    return DeviceTrace(prof.profiler.kineto_results.events())
