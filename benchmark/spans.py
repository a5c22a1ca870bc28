"""The program's spans, read.

The port records spans inside the stylization when its recorder is on
(``univst_torch/utils/profiling.py``: ``spans()``, ``SPANS.take()``): a
``stylize`` root, its ``prepass``, ``phase1`` and ``phase2`` segments and
their ``step`` spans, and a ``decode`` root. Two readings come from them:

* an untraced window run in events mode gives each timed span's device ms
  (CUDA events at its two ends): :func:`step_ms`, :func:`prepass_ms`;
* a job profiled in ranges mode holds the same spans as ``univst::<name>``
  ranges on the profiler's clock, beside the device operations:
  :class:`ProgramRanges` ties each operation to the innermost range open at
  its launch, and counts launches, busy time and idle gaps by range.

The range names are frozen here, as ``benchmark/trace.py`` freezes the
kernel names, so that a change to the program cannot move the yardstick.

Run as a script, it measures one cell on the card: untraced windows with
the recorder off and in events mode, in turns (its cost when on), then jobs
traced with the program's ranges on and off, in turns (the device-trace
readers either way), and the host's cost of one span site before and after
profiling, and prints one JSON line::

    python3 benchmark/spans.py --workload sd15_stylize --seed <n> --seconds 51 --pairs 3

It exits 2 where the program has no recorder or no card is found.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import time  # noqa: E402
from collections import defaultdict  # noqa: E402
from typing import Dict, List, Optional, Tuple  # noqa: E402

PREFIX = "univst::"
SPAN_NAMES = ("stylize", "prepass", "phase1", "phase2", "step", "decode")
RANGES = {PREFIX + n: n for n in SPAN_NAMES}
VFA_RANGE = PREFIX + "vfa "  # + the call's label, as benchmark.trace.encode_label writes it
PHASES = ("phase1", "phase2")


# -- events mode: the spans the recorder returns ---------------------------------------


def _by_id(spans) -> Dict[int, object]:
    return {s.id: s for s in spans}


def step_ms(spans, phase: str) -> Optional[float]:
    """Mean device ms of the step spans inside ``phase`` spans, or None where
    there are none or they hold no device time (the CPU)."""
    ids = _by_id(spans)
    ms = [s.device_ms for s in spans if s.name == "step" and s.parent in ids
          and ids[s.parent].name == phase]
    return statistics.fmean(ms) if ms and None not in ms else None


def prepass_ms(spans) -> Optional[float]:
    """Mean device ms of the style pre-pass spans, or None."""
    ms = [s.device_ms for s in spans if s.name == "prepass"]
    return statistics.fmean(ms) if ms and None not in ms else None


def steps_per_job(spans, phase: str) -> float:
    """Step spans inside ``phase`` spans, per stylize root."""
    ids = _by_id(spans)
    n = sum(1 for s in spans if s.name == "step" and s.parent in ids
            and ids[s.parent].name == phase)
    jobs = sum(1 for s in spans if s.name == "stylize")
    return n / jobs if jobs else 0.0


# -- ranges mode: a profiled job -------------------------------------------------------


class ProgramRanges:
    """A profiled job's program ranges and device operations, in ns on the
    profiler's clock.

    ``ranges``: ``(start, end, name)`` of each ``univst::`` span range (the
    video flash calls' as ``"vfa"``), with ``parent`` the index of the
    range that encloses it. ``ops``: ``(start, end, range)`` of each device
    operation (kernels, copies, sets; not the device side of a range), with
    ``range`` the index of the innermost range open when its launching host
    op started, or None. ``window``: the harness's clip range, else the
    operations' extent."""

    def __init__(self, events, window_scope: str = "benchmark::clip"):
        host_start: Dict[int, int] = {}
        ranges, device, windows = [], [], []
        for e in events:
            name = e.name()
            if not str(e.device_type()).endswith("CUDA"):
                host_start[e.correlation_id()] = e.start_ns()
                if name in RANGES:
                    ranges.append((e.start_ns(), e.end_ns(), RANGES[name]))
                elif name.startswith(VFA_RANGE):
                    ranges.append((e.start_ns(), e.end_ns(), "vfa"))
                elif name == window_scope:
                    windows.append((e.start_ns(), e.end_ns()))
            elif not e.is_user_annotation() and not name.startswith(PREFIX) \
                    and not name.startswith("benchmark::"):
                device.append(e)
        self.ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
        self.parent = self._parents()
        launches = []
        for e in device:
            t = host_start.get(e.linked_correlation_id())
            launches.append((t, e.start_ns(), e.end_ns()))
        inner = self._innermost([t for t, _, _ in launches])
        self.ops = sorted(((s, t, r) for (_, s, t), r in zip(launches, inner)))
        if windows:
            self.window = (min(s for s, _ in windows), max(t for _, t in windows))
        else:
            self.window = (self.ops[0][0], max(t for _, t, _ in self.ops)) if self.ops else None

    def _parents(self) -> List[Optional[int]]:
        parent, stack = [], []
        for i, (s, _, _) in enumerate(self.ranges):
            while stack and self.ranges[stack[-1]][1] <= s:
                stack.pop()
            parent.append(stack[-1] if stack else None)
            stack.append(i)
        return parent

    def _innermost(self, times) -> List[Optional[int]]:
        """The innermost range holding each time (None: no time, or none)."""
        order = sorted(range(len(times)), key=lambda j: -1 if times[j] is None else times[j])
        out: List[Optional[int]] = [None] * len(times)
        stack, k = [], 0
        for j in order:
            t = times[j]
            if t is None:
                continue
            while k < len(self.ranges) and self.ranges[k][0] <= t:
                while stack and self.ranges[stack[-1]][1] <= self.ranges[k][0]:
                    stack.pop()
                stack.append(k)
                k += 1
            while stack and self.ranges[stack[-1]][1] <= t:
                stack.pop()
            out[j] = stack[-1] if stack else None
        return out

    def _enclosing(self, i: Optional[int], name: str) -> Optional[int]:
        while i is not None and self.ranges[i][2] != name:
            i = self.parent[i]
        return i

    def steps(self, phase: str) -> List[int]:
        """The step ranges nested in ``phase`` ranges."""
        return [i for i, r in enumerate(self.ranges)
                if r[2] == "step" and self._enclosing(self.parent[i], phase) is not None]

    def step_ops(self, phase: str) -> Dict[int, List[Tuple[int, int]]]:
        """Per step range in ``phase``, the intervals of the device operations
        launched inside it."""
        steps = set(self.steps(phase))
        out: Dict[int, List[Tuple[int, int]]] = {i: [] for i in steps}
        for s, t, r in self.ops:
            i = self._enclosing(r, "step")
            if i in steps:
                out[i].append((s, t))
        return out

    def launches_per_step(self, phase: str) -> Optional[float]:
        ops = self.step_ops(phase)
        return sum(len(v) for v in ops.values()) / len(ops) if ops else None

    def busy_ms_per_step(self, phase: str) -> Optional[float]:
        """Mean union length of each step's operations, in ms."""
        from benchmark.trace import union_length

        ops = self.step_ops(phase)
        if not ops:
            return None
        return sum(union_length(v) for v in ops.values()) / len(ops) / 1e6

    def label(self, i: Optional[int]) -> str:
        """Range ``i``'s name, after the phase that holds it (``phase2/step``,
        ``phase1/vfa``); ``"(none)"`` for no range."""
        if i is None:
            return "(none)"
        name = self.ranges[i][2]
        for ph in PHASES:
            if name != ph and self._enclosing(i, ph) is not None:
                return f"{ph}/{name}"
        return name

    def seconds(self, name: str) -> float:
        """Total length of the ranges named ``name``, in s."""
        return sum(t - s for s, t, n in self.ranges if n == name) / 1e9

    def idle_gaps(self) -> Dict[str, float]:
        """Seconds the device waited before an operation, totalled by the
        innermost program range open at that operation's launch
        (:meth:`label`), and after the last operation."""
        gaps: Dict[str, int] = defaultdict(int)
        if self.window is None:
            return {}
        a, b = self.window
        end = a
        for s, t, r in self.ops:
            if t <= a or s >= b:
                continue
            if s > end:
                gaps[self.label(r)] += s - end
            end = max(end, t)
        if b > end:
            gaps["(after the last operation)"] += b - end
        return {k: v / 1e9 for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])}


# -- the script ------------------------------------------------------------------------


def _window(harness, system, pool, traffic, seconds, cell, device, events: bool) -> dict:
    from univst_torch.utils import profiling

    record = harness.RunRecord(cell)
    with profiling.spans(events=True) if events else contextlib.nullcontext():
        outs = harness.run_window(system, pool, traffic, seconds, record, device)
    harness._sync(device)
    spans = profiling.SPANS.take()
    frames = sum(o[2].shape[0] for o in outs)
    out = {"events": events, "jobs": len(outs), "window_s": record.window_s,
           "frames_per_s": frames / record.window_s,
           "stylize_s": statistics.fmean(record.spans["stylize"]),
           "decode_s": statistics.fmean(record.spans["decode"])}
    if events:
        jobs = [s for s in spans if s.name == "stylize"]
        out.update(spans=len(spans), stylize_jobs=len(jobs), prepass_ms=prepass_ms(spans))
        for ph in PHASES:
            out[f"{ph}_step_ms"] = step_ms(spans, ph)
            out[f"{ph}_steps"] = steps_per_job(spans, ph)
            host = [(s.host_end_ns - s.host_start_ns) / 1e6 for s in spans if s.name == ph]
            out[f"{ph}_host_ms"] = statistics.fmean(host) if host else None
        parts = (out["prepass_ms"] or 0.0) + sum(
            out[f"{ph}_steps"] * (out[f"{ph}_step_ms"] or 0.0) for ph in PHASES)
        out["closure"] = parts / (1000 * out["stylize_s"])
    return out


def _traced(harness, system, inputs, traffic, device, cell, ranges: bool) -> dict:
    from torch.profiler import record_function

    from benchmark.trace import WINDOW_SCOPE, capture, label_vfa_calls, reduce
    from univst_torch.utils import profiling

    t0 = time.perf_counter()
    on = profiling.spans(events=False, ranges=True) if ranges else contextlib.nullcontext()
    with label_vfa_calls(), profiling.annotate_norms(*system.norm_roots()), capture() as prof:
        with on, record_function(WINDOW_SCOPE):
            lat = system.stylize(inputs, traffic)
            system.decode(lat, traffic)
        harness._sync(device)
    t_job = time.perf_counter() - t0
    record = harness.RunRecord(cell)
    record.trace = reduce(prof)
    out = {"ranges": ranges, "job_and_stop_s": t_job, "busy_s": record.trace.busy_ns() / 1e9,
           "window_s": (record.trace.window_ns() or 0) / 1e9}
    for name in ("norm_share", "elementwise_share", "idle_share", "k1_roofline", "k2_roofline"):
        out[name] = importlib.import_module("benchmark.metrics." + name).read(record)
    gaps = record.trace.breakdown()["idle_gaps"]
    out["idle_gaps_by_launcher"] = gaps
    out["univst_launchers"] = [g for g in gaps if g[0].startswith(PREFIX)]
    if ranges:
        pr = ProgramRanges(prof.profiler.kineto_results.events(), WINDOW_SCOPE)
        out["program_ranges"] = len(pr.ranges)
        out["idle_gaps_by_range"] = pr.idle_gaps()
        out["range_s"] = {n: pr.seconds(n) for n in ("prepass",) + PHASES + ("decode",)}
        for ph in PHASES:
            out[f"{ph}_steps"] = len(pr.steps(ph))
            out[f"{ph}_launches"] = pr.launches_per_step(ph)
            out[f"{ph}_busy_ms"] = pr.busy_ms_per_step(ph)
    return out


def measure(name: str, seed: int, seconds: float, pairs: int, device, log=print,
            traced_pairs: int = 2) -> dict:
    """One cell's readings (see the module's docstring)."""
    import torch

    from benchmark import run as harness
    from benchmark import traffic as traffic_mod

    cell = harness.Cell(name)
    cfg, tr, sysmod = cell.config, cell.traffic, cell.system
    torch.manual_seed(seed)
    t0 = time.perf_counter()
    system = sysmod.System(cfg, tr, device, seed)
    pool = traffic_mod.pool(tr, sysmod.latent_channels(cfg), seed, device)
    system.warmup(pool[-1], tr)
    harness._sync(device)
    out = {"cell": name, "seed": seed, "card": harness.power_limit() if device.type == "cuda"
           else "cpu", "setup_s": time.perf_counter() - t0, "windows": [],
           "span_cost_us": {"before_profiling": span_cost_us(device)}}
    for p in range(pairs):
        for events in ((False, True) if p % 2 == 0 else (True, False)):
            w = _window(harness, system, pool, tr, seconds, cell, device, events)
            log(f"{name} window events={events}: {json.dumps(w)}")
            out["windows"].append(w)
    if pairs == 0:  # one events window, for the step times alone
        out["windows"].append(_window(harness, system, pool, tr, seconds, cell, device, True))
    for p in range(traced_pairs):
        for ranges in ((True, False) if p % 2 == 0 else (False, True)):
            t = _traced(harness, system, pool[0], tr, device, cell, ranges)
            log(f"{name} traced ranges={ranges}: {json.dumps(t)}")
            out.setdefault("traced", []).append(t)
    out["span_cost_us"]["after_profiling"] = span_cost_us(device)
    ev = [w for w in out["windows"] if w["events"]]
    p2 = statistics.median(w["phase2_step_ms"] for w in ev) if ev and ev[0]["phase2_step_ms"] \
        else None
    busy = [t["phase2_busy_ms"] for t in out["traced"] if t["ranges"]]
    out["phase2_idle_share"] = (100 * (1 - statistics.fmean(busy) / p2)
                                if p2 and None not in busy else None)
    return out


def span_cost_us(device, n: int = 4000) -> dict:
    """The host's us a ``step`` span site costs, inside a root, less an empty
    loop's: off (the flag check) and in events mode (the span with its two
    CUDA events), and ``take``'s us a span once the card is synchronised."""
    from benchmark import run as harness
    from univst_torch.utils.profiling import NO_SPAN, SPANS, spans

    def loop(site: bool) -> float:
        t0 = time.perf_counter_ns()
        for i in range(n):
            if site:
                with SPANS.span("step", i=i) if SPANS.on else NO_SPAN:
                    pass
            else:
                with NO_SPAN:
                    pass
        return (time.perf_counter_ns() - t0) / n / 1e3

    bare, off = loop(False), loop(True)
    with spans(events=True), SPANS.span("stylize", device=device):
        on = loop(True)
    harness._sync(device)
    t0 = time.perf_counter_ns()
    SPANS.take()
    return {"off_us": off - bare, "events_us": on - bare,
            "take_us": (time.perf_counter_ns() - t0) / n / 1e3}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Read the program's spans in one cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--traced_pairs", type=int, default=2)
    args = ap.parse_args(argv)
    import torch

    from univst_torch.utils import profiling

    if not hasattr(profiling, "spans"):
        print("benchmark/spans.py: the program has no span recorder", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("benchmark/spans.py: no CUDA device", file=sys.stderr)
        return 2
    res = measure(args.workload, args.seed, args.seconds, args.pairs, torch.device("cuda"),
                  log=lambda m: print(m, file=sys.stderr, flush=True),
                  traced_pairs=args.traced_pairs)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
