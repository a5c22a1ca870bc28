"""Readings that set a cell's correctness limits, on the card at the cell's
own size: for each seed, the gaps of the program's job from the reference
(the lower reading) and the gaps of each control from the reference (the
upper reading). A control is the reference computed below the
configuration's precision (``reference.common.CONTROLS``): ``fp8``, its
products through float8; ``bf16_stats``, its norms, AdaIN and schedulers
in bfloat16.

    python3 benchmark/control.py --workload sd15_stylize --seeds 11,12,13 --controls fp8,bf16_stats

Each seed builds the program with that seed's weights, runs one job of the
cell's traffic (its first input set), frees the program and runs the
reference, then each control (``--program 0`` skips the program). One
JSON line a seed on standard output.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(cell, seed: int, device, controls=(), program: bool = True) -> dict:
    import torch

    from benchmark import traffic as traffic_mod
    from benchmark.run import gaps

    cfg, tr, sysmod = cell.config, cell.traffic, cell.system
    out, seconds = {"seed": seed}, {}
    inputs = traffic_mod.input_set(tr, sysmod.latent_channels(cfg), seed, 0, device)
    if program:
        t0 = time.perf_counter()
        system = sysmod.System(cfg, tr, device, seed)
        lat = system.stylize(inputs, tr)
        frames = system.decode(lat, tr)
        lat = lat.cpu()
        del system
        gc.collect()
        torch.cuda.empty_cache()
        seconds["program"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref_lat, ref_frames = sysmod.reference_clip(cfg, tr, inputs, seed, device)
    seconds["reference"] = time.perf_counter() - t0
    if program:
        out["program"] = gaps(lat, frames, ref_lat, ref_frames)
    for name in controls:
        t0 = time.perf_counter()
        c_lat, c_frames = sysmod.reference_clip(cfg, tr, inputs, seed, device, control=name)
        out[name] = gaps(c_lat, c_frames, ref_lat, ref_frames)
        seconds[name] = time.perf_counter() - t0
    out["seconds"] = seconds
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--controls", default="fp8", help="comma-separated, or empty")
    ap.add_argument("--program", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)

    import torch

    from benchmark.run import Cell

    if not torch.cuda.is_available():
        print("benchmark.control: needs a CUDA device", file=sys.stderr)
        return 2
    cell = Cell(args.workload)
    controls = [c for c in args.controls.split(",") if c]
    for s in args.seeds.split(","):
        print(json.dumps(readings(cell, int(s), torch.device("cuda"), controls,
                                  bool(args.program))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
