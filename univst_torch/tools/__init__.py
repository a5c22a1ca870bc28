"""The port's counterparts of the JAX repository's tools in ``scripts/``.

Each runs as ``python -m univst_torch.tools.<name>`` (the recipes as ``bash
univst_torch/tools/<name>``), on the CUDA card unless ``--device cpu`` is
given, and keeps its JAX script's name and report rows. The timers print
their human-readable rows to stderr and end stdout with one JSON line: the
rows in ms and ``device`` (name, nvidia-smi power limit, count). Their
measuring functions take a built pipeline.

This subpackage imports ``torch`` and the port, never JAX, the JAX package
or ``scripts/``.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Callable, Optional

import torch

# tool -> its JAX counterpart
TOOLS = {
    "bench_stages": "scripts/bench_stages.py",
    "bench_anatomy": "scripts/bench_anatomy.py",
    "bench_sd3_anatomy": "scripts/bench_sd3_anatomy.py",
    "compare_outputs": "scripts/compare_outputs.py",
    "start_sd.sh": "scripts/start_sd.sh",
    "start_animatediff.sh": "scripts/start_animatediff.sh",
    "start_sd3.sh": "scripts/start_sd3.sh",
}


def log(line: str) -> None:
    """A human-readable row, on stderr."""
    print(line, file=sys.stderr, flush=True)


def err_over_tol(got, want) -> float:
    """``max |got - want| / (atol + rtol * |want|)``: a kernel's output
    against its plain version passes at <= 1.

    bf16: rtol 2**-6 is two bf16 ulps (both sides round an fp32 result to
    bf16, and the kernel packs P to bf16 for the PV product); atol is 0.02 x
    the plain output's rms, for elements near zero. With N(0, 1) inputs that
    rms is about sqrt(e / keys) (0.015 at the 64x64 level), so the bar follows
    the shape. fp32: 1e-5 absolute and relative (the same arithmetic up to
    summation order).
    """
    if want.dtype == torch.bfloat16:
        want = want.float()
        atol, rtol = 0.02 * want.pow(2).mean().sqrt().item(), 2.0**-6
    else:
        atol, rtol = 1e-5, 1e-5
    diff = (got.float() - want).abs()
    if not torch.isfinite(diff).all():
        return float("inf")
    return (diff / (atol + rtol * want.abs())).max().item()


def timed(rows: dict, name: str, fn: Callable, reps: int, device: torch.device,
          divisor: int = 1, marks: Optional[dict] = None):
    """``fn`` once untimed, then the best of ``reps`` calls on the host clock,
    each ending in ``torch.cuda.synchronize()`` on a card; ``rows[name]`` is
    that best in ms (and ``rows[name + ' per step']`` the best over
    ``divisor`` when it is not 1). With ``marks``, ``marks[name]`` is the
    best call's host ms at its return, before the synchronise (its dispatch
    time). Returns the last call's output."""
    from univst_torch.bench import _sync

    out = fn()
    _sync(device)
    best = dispatched = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        t1 = time.perf_counter()
        _sync(device)
        took = time.perf_counter() - t0
        if took < best:
            best, dispatched = took, t1 - t0
    rows[name] = best * 1e3
    if marks is not None:
        marks[name] = dispatched * 1e3
    line = f"{name:58s} {best * 1e3:9.1f} ms"
    if divisor != 1:
        rows[f"{name} per step"] = best / divisor * 1e3
        line += f"  ({best / divisor * 1e3:7.1f} ms/step)"
    log(line)
    return out


def device_splits(stages: dict, modules, device: torch.device, trace_dir: str) -> dict:
    """Each of ``stages`` (name -> ``(fn, its untraced ms)``) once under its
    own ``torch.profiler`` trace (``utils/profiling.py::device_trace``, the
    Chrome trace under ``trace_dir``), the norm modules of ``modules``
    annotated (``annotate_norms``): ``device_time_split``'s device ms by
    kind of kernel, busy and traced wall ms, idle share, and the idle share
    against the untraced ms (``idle_share_untraced``: the trace's own host
    cost stretches its span). None where the trace saw no device time."""
    from univst_torch.bench import _sync
    from univst_torch.utils.profiling import annotate_norms, device_time_split, device_trace

    out = {}
    for name, (fn, untraced_ms) in stages.items():
        with annotate_norms(*modules), device_trace(
                os.path.join(trace_dir, name.replace(" ", "_"))) as prof:
            fn()
            _sync(device)
        split = device_time_split(prof)
        out[name] = {k: split[k] for k in ("device_ms", "busy_ms", "wall_ms", "idle_share",
                                           "kernels", "device_time_seen")}
        out[name]["idle_share_untraced"] = (1.0 - split["busy_ms"] / untraced_ms
                                            if split["device_time_seen"] else None)
        log(f"  split {name:26s} " + " ".join(
            f"{k} {v:.1f}" for k, v in split["device_ms"].items() if v)
            + f"  idle {out[name]['idle_share_untraced']} (untraced)")
    return out


def resolve(device_arg: Optional[str], tool: str) -> Optional[torch.device]:
    """The tool's device (the card unless ``--device cpu``); None, with the
    reason on stderr, when the card asked for is missing."""
    from univst_torch.pipelines.sd import resolve_device

    try:
        return resolve_device(device_arg)
    except RuntimeError as e:
        log(f"univst_torch.tools.{tool}: {e}")
        return None


def emit(tool: str, device: torch.device, result: dict) -> None:
    """The tool's JSON line, last on stdout: ``result`` with the tool's name
    and ``device``."""
    from univst_torch.bench import device_info

    print(json.dumps(dict(tool=tool, **result, device=device_info(device))), flush=True)
