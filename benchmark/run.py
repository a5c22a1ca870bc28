"""Run one cell of the port's benchmark on the card and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its traffic and its metrics are looked up by
name: ``BENCHMARK.json`` at the checkout's root names them,
``benchmark/configs/<config>.json`` holds a configuration (and names the
system adapter, ``benchmark/systems/<system>.py``, with its plain
reference), ``benchmark/traffic/<traffic>.json`` a traffic mix (whose ``kind`` names
the module that draws its inputs, ``benchmark/kinds/<kind>.py``),
``benchmark/metrics/<metric>.py`` a per-layer metric's reader and
``benchmark/limits/<cell>.json`` the limits of the cell's correctness check.

A run: set-up (the program built on the card with weights drawn from the
seed, the empty prompt encoded, the pool of input sets drawn, a warm-up
over every shape: the traffic's ``warmup_steps`` and a decode), then the
window: jobs back to back, one in flight
(one user's queue on one card); another starts only while the time spent
plus the mean job time so far stays within ``--seconds``, and at least one
runs. The window closes when the last job's frames are on the host. Then
the program is freed and the plain reference recomputes one job of the
run, drawn from the seed, from the same weights and inputs; the gaps
between the two decide ``correct``.

``--trace 1`` runs the same untraced window, then one more job under the
profiler, and prints the per-layer metrics: the host-clock ones (spans,
``mfu``) from the untraced window, the device-trace ones from the traced
job. The last line of standard output is the result's JSON.
"""

from __future__ import annotations

import os
import sys
import time

_T_IMPORT = time.time()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import random  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
from collections import defaultdict  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "univst_tpu")


def process_start_time() -> float:
    """The epoch second this process started (from ``/proc``), or the time
    this module was imported where ``/proc`` cannot say."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(ln.split()[1]) for ln in f if ln.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return _T_IMPORT


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_json(*parts) -> dict:
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


class Cell:
    """A cell of ``BENCHMARK.json`` with its configuration, traffic,
    metrics and limits, read from their files."""

    def __init__(self, name: str, manifest: Optional[dict] = None):
        m = manifest if manifest is not None else load_json("BENCHMARK.json")
        cells = {w["name"]: w for w in m["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
        self.name, self.entry = name, cells[name]
        configs = {c["name"]: c for c in m["configs"]}
        self.config = load_json(configs[self.entry["config"]]["file"])
        self.traffic = load_json("benchmark", "traffic", self.entry["traffic"] + ".json")
        self.limits = load_json("benchmark", "limits", name + ".json")
        self.end_to_end = [e for e in m["end_to_end"] if name in e.get("workloads", [name])]
        self.per_layer = [e for e in m["per_layer"] if name in e.get("workloads", [name])]
        self.system = importlib.import_module("benchmark.systems." + self.config["system"])


class RunRecord:
    """What the per-layer readers read: the untraced window's spans
    (seconds a job, by name), jobs completed and length, and the reduced
    device trace of the traced job."""

    def __init__(self, cell: Cell):
        self.cell = cell
        self.spans: Dict[str, List[float]] = defaultdict(list)
        self.trace = None
        self.clips = 0
        self.window_s = 0.0
        self._flops = None

    def flops_per_clip(self) -> float:
        if self._flops is None:
            self._flops = self.cell.system.clip_flops(self.cell.config, self.cell.traffic)
        return self._flops


def launch_counts() -> tuple:
    """The program's K1 and K2 launch counters as they stand."""
    from univst_torch.attention import video_flash as vf

    return vf.video_flash_attention.launches, vf.video_flash_attention_tokens.launches


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_window(system, pool: list, traffic: dict, seconds: float, record: RunRecord,
               device) -> list:
    """The timed jobs; returns ``(input set, latents, frames)`` of each. Each
    job's stylize and decode spans go into ``record`` (the stylize span is
    synchronised at its end; the decode's copy to the host waits anyway)."""
    outs, times = [], []
    t_open = time.perf_counter()
    while not times or time.perf_counter() - t_open + statistics.fmean(times) <= seconds:
        k = len(outs) % len(pool)
        t0 = time.perf_counter()
        lat = system.stylize(pool[k], traffic)
        _sync(device)
        t1 = time.perf_counter()
        frames = system.decode(lat, traffic)
        t2 = time.perf_counter()
        record.spans["stylize"].append(t1 - t0)
        record.spans["decode"].append(t2 - t1)
        times.append(t2 - t0)
        outs.append((k, lat, frames))
    record.window_s = time.perf_counter() - t_open
    record.clips = len(outs)
    return outs


def traced_job(system, inputs: dict, traffic: dict, device):
    """One job under the profiler, inside the harness's clip range, with the
    program's norm ranges and the video flash calls labelled; returns the
    job's ``(latents, frames)`` and the reduced trace."""
    from torch.profiler import record_function

    from benchmark.trace import WINDOW_SCOPE, capture, label_vfa_calls, reduce
    from univst_torch.utils.profiling import annotate_norms

    with label_vfa_calls(), annotate_norms(*system.norm_roots()), capture() as prof:
        with record_function(WINDOW_SCOPE):
            lat = system.stylize(inputs, traffic)
            frames = system.decode(lat, traffic)
        _sync(device)
    return lat, frames, reduce(prof)


def gaps(latents, frames, ref_latents, ref_frames) -> Dict[str, float]:
    """The numbers compared: the stylized latents' RMS gap relative to the
    reference's RMS, and the frames' RMS gap in uint8 steps."""
    a, b = latents.float().cpu(), ref_latents.float().cpu()
    lat = float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())
    fr = float((frames.float().cpu() - ref_frames.float().cpu()).pow(2).mean().sqrt())
    return {"latent_gap": lat, "frames_rms": fr}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(numbers[k] == numbers[k] and numbers[k] <= limits[k] for k in limits)


def check_outputs(outs: list, traffic: dict, latent_channels: int) -> int:
    """Jobs whose outputs are malformed: frames not ``[F, H, W, 3]`` uint8, or
    latents not finite."""
    import torch

    f, size = traffic["frames"], traffic["size"]
    bad = 0
    for _, lat, frames in outs:
        if (tuple(frames.shape) != (f, size, size, 3) or frames.dtype != torch.uint8
                or lat.shape[0] != f or lat.shape[-1] != latent_channels
                or not bool(torch.isfinite(lat).all())):
            bad += 1
    return bad


def device_info(device) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def power_limit() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=False)
        return res.stdout.strip().splitlines()[0] if res.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: Optional[float] = None, log: Callable = print) -> dict:
    """A whole run of ``cell`` on ``device``; returns the result's dict, or
    raises."""
    import torch

    from benchmark import traffic as traffic_mod

    t_start = time.time() if t_start is None else t_start
    cfg, tr, sysmod = cell.config, cell.traffic, cell.system
    torch.manual_seed(seed)
    t0 = time.perf_counter()
    system = sysmod.System(cfg, tr, device, seed)
    pool = traffic_mod.pool(tr, sysmod.latent_channels(cfg), seed, device)
    _sync(device)
    t_build = time.perf_counter() - t0
    system.warmup(pool[-1], tr)
    _sync(device)
    t_warm = time.perf_counter() - t0 - t_build
    setup_s = time.time() - t_start
    launches = launch_counts()

    record = RunRecord(cell)
    outs = run_window(system, pool, tr, seconds, record, device)
    launches = [(b - a) / len(outs) for a, b in zip(launches, launch_counts())]
    jobs = ", ".join(f"{a + b:.3f}" for a, b in zip(record.spans["stylize"],
                                                    record.spans["decode"]))
    log(f"cell {cell.name} seed {seed}: set-up {setup_s:.3f} s (build {t_build:.3f}, "
        f"warm-up {t_warm:.3f}), {len(outs)} jobs in {record.window_s:.3f} s ({jobs}), "
        f"kernel launches a job {launches}")
    if trace:
        t_traced = time.perf_counter()
        k = len(outs) % len(pool)
        lat, frames, record.trace = traced_job(system, pool[k], tr, device)
        outs.append((k, lat, frames))
        log(f"traced job and its reduction in {time.perf_counter() - t_traced:.1f} s: "
            f"{len(record.trace.ops)} device ops ({record.trace.launchers_found} with a "
            f"launcher), {record.trace.norm_ranges} norm ranges, "
            f"{record.trace.vfa_labels} video flash calls, matched kernels "
            f"{ {k: len(v) for k, v in record.trace.vfa_calls.items()} }")
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package are loaded: {found}")
    dev = device_info(device) if device.type == "cuda" else {
        "platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    failed = check_outputs(outs, tr, sysmod.latent_channels(cfg))

    metrics = {}
    breakdown = None
    if trace:
        busy = record.trace.busy_ns() / 1e9
        dev.update(busy_s=busy, window_s=(record.trace.window_ns() or 0) / 1e9)
        for m in cell.per_layer:
            value = importlib.import_module("benchmark.metrics." + m["name"]).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        breakdown = record.trace.breakdown()
    else:
        frames = sum(o[2].shape[0] for o in outs)
        rate = frames / record.window_s
        # the same rate under a bound of its own in the cells the card paces
        values = {"frames_per_s": rate, "frames_per_s.card_paced": rate,
                  "peak_mem_gb": dev["memory_peak_bytes"] / 1e9, "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    # the check: one job of the run, drawn from the seed, against the
    # reference, once the program is freed
    from benchmark.weights import sub_seed

    attempted = len(outs)
    pick = random.Random(sub_seed(seed, "sample")).randrange(attempted)
    k, lat, frames = outs[pick]
    lat, frames, inputs = lat.cpu(), frames.cpu(), pool[k]
    del system, outs, pool
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref_lat, ref_frames = sysmod.reference_clip(cfg, tr, inputs, seed, device)
    numbers = gaps(lat, frames, ref_lat, ref_frames)
    correct = failed == 0 and judge(numbers, cell.limits)
    log(f"reference of job {pick} in {time.perf_counter() - t_ref:.1f} s")
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["check"] = {n: {"value": numbers[n], "limit": lim} for n, lim in cell.limits.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = process_start_time()
    os.environ.setdefault("USE_FLAX", "0")
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")

    import torch

    cell = Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.entry["chips"]:
        print(f"benchmark: the cell needs {cell.entry['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    log(f"card: {power_limit()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda"),
                      t_start, log)
    found = forbidden_modules()
    if found:
        log(f"benchmark: modules of JAX or the JAX package are loaded: {found}")
        return 3
    for name, c in result["check"].items():
        log(f"{name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
