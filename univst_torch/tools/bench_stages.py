"""Stage-level timing of the bench workload — port of ``scripts/bench_stages.py``.

    python -m univst_torch.tools.bench_stages [--reps 2] [--seed 0] [--trace_dir DIR]
    python -m univst_torch.tools.bench_stages --device cpu    # CPU smoke size

The workload is ``univst_torch/bench.py``'s: SD-1.5 at full width (seed-0
weights, bf16), 16 frames at 512 px, 50 DDIM steps, the synthetic
trajectories of ``bench.synthetic_inputs`` drawn from ``--seed``. On the CPU
it is the bench's smoke size (tiny variant, fp32, 4 frames at 64 px, 10
steps).

The stylization is cut as ``SDVideoPipeline.stylize_latents`` cuts it, into
the style pre-pass (``_style_prepass``), the phase-1 and phase-2 segments of
``pipelines/segments.phase_segments`` (``_stylize_chunk_singleton``,
``_stylize_chunk_solo``) and the uint8 decode, and each piece is a call of
the pipeline's own method with the arguments ``stylize_latents`` passes it:
run in order, the pieces give ``stylize_latents``' output bit for bit.

Rows (stderr, then the JSON line's ``rows``, in ms): each stage warm (one
untimed call, then the best of ``--reps``, each ending in
``torch.cuda.synchronize()``): ``prepass``, ``phase1 seg`` and ``phase2 seg``
(with ``per step``), ``decode (sync'd, no transfer)`` (the whole clip,
``decode_latents_uint8``), ``uint8 pixel transfer`` (its copy to the host),
``chunked decode + transfer`` (8 frames a chunk, as the bench),
``full stylize+decode+transfer`` (the bench's timed run) and ``closure``:
prepass + phase 1 + phase 2 + chunked decode + transfer, beside its ratio
to the full row (``closure_ratio``).

``marks``: in each stage's best timed call, the host clock at the call's
return, before its synchronise (the JAX script's dispatch anatomy, its
lines 128-148, taken in the timed rep rather than in a run of its own). The
port runs eagerly: where a mark is near its stage's synchronised row, the
host sets the pace; where it is far below, the card does.

``device_split``: one further rep, never a timed one, each stage under its
own ``torch.profiler`` trace (``utils/profiling.py::device_trace``; the
phases as one step each, a segment of one step at the phase's middle; the
UNet's and the VAE's norm modules annotated, ``annotate_norms``, so their
kernels count as norm time): device ms by kind of kernel, busy and traced
wall ms, idle share
(``device_time_split``), and the idle share against the stage's untraced
row (``idle_share_untraced``: the trace's host cost stretches its span).
On the CPU the trace holds no device time and the split says so.

``launches``: K1's and K2's launches in one full run (K1 10 a 16-frame
forward: 500 at 50 steps).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Optional

import numpy as np
import torch

from univst_torch.tools import device_splits, emit, log, resolve, timed


@dataclasses.dataclass
class Workload:
    """``bench.py``'s stylization workload on a built SD pipeline, in the
    pieces ``stylize_latents`` runs (style-singleton path, no smoother)."""

    pipe: object
    content: torch.Tensor
    style: torch.Tensor
    init: torch.Tensor
    mask: torch.Tensor
    context3: torch.Tensor
    cfg: object
    ts: np.ndarray
    phase1: list
    phase2: list
    k1: int

    @classmethod
    def build(cls, pipe, steps: int, size: int, seed: int = 0) -> "Workload":
        from univst_torch.bench import synthetic_inputs
        from univst_torch.core.config import StyleTransferConfig
        from univst_torch.pipelines.segments import phase_segments

        if not pipe.style_singleton or pipe.mesh is not None:
            raise ValueError("the bench workload runs one process on the style-singleton path")
        content, style, init, mask = synthetic_inputs(pipe.device, steps, pipe.num_frames, size,
                                                      seed)
        context3 = torch.cat([pipe.encode_text("")] * 3)
        cfg = StyleTransferConfig(num_steps=steps)
        phase1, phase2 = phase_segments(steps, pipe.style_shift_cfg.window_end())
        return cls(pipe, content, style, init, mask, context3, cfg,
                   pipe.schedule.timesteps(steps), phase1, phase2,
                   phase2[0][0] if phase2 else steps)

    def stylize(self):
        """The public call the pieces reproduce."""
        return self.pipe.stylize_latents(self.content, self.style, self.init, self.context3,
                                         mask=self.mask, cfg=self.cfg)

    @torch.inference_mode()
    def prepass(self):
        return self.pipe._style_prepass(self.style[:, :1], self.ts[:self.k1], self.context3,
                                        self.k1)

    @torch.inference_mode()
    def phase1_chunk(self, kv, latents, s0: int, c: int):
        return self.pipe._stylize_chunk_singleton(
            self.content, self.style[:, :1], kv, latents, self.ts, s0, self.context3, self.mask,
            self.cfg, self.pipe.style_shift_cfg, c, None)

    @torch.inference_mode()
    def phase2_chunk(self, latents, s0: int, c: int):
        return self.pipe._stylize_chunk_solo(self.content, self.style[:, :1], latents, self.ts,
                                             s0, self.context3, self.mask, self.cfg, c)

    def pieces(self):
        """The pre-pass, then every segment in order: the stylized latents."""
        kv = self.prepass() if self.phase1 else None
        latents = self.init.float()
        for s0, c in self.phase1:
            latents = self.phase1_chunk(kv, latents, s0, c)
        for s0, c in self.phase2:
            latents = self.phase2_chunk(latents, s0, c)
        return latents

    def decode_chunks(self, latents):
        return self.pipe.decode_latents_uint8_chunks(latents, chunk=8)

    def run(self):
        """The bench's timed run: stylize, chunked uint8 decode, to the host."""
        return torch.cat([c.cpu() for c in self.decode_chunks(self.stylize())])


def device_split(w: Workload, kv, latents, rows: dict, trace_dir: str) -> dict:
    """Each stage once under its own trace, the phases a one-step segment at
    their middle step (:func:`univst_torch.tools.device_splits`), beside
    its row in ``rows``."""
    def mid(seg):
        return seg[0][0] + seg[0][1] // 2

    stages = {"prepass": (w.prepass, rows.get("prepass"))}
    if w.phase1:
        stages["phase1 step"] = (lambda: w.phase1_chunk(kv, latents, mid(w.phase1), 1),
                                 rows["phase1 seg per step"])
    if w.phase2:
        stages["phase2 step"] = (lambda: w.phase2_chunk(latents, mid(w.phase2), 1),
                                 rows["phase2 seg per step"])
    stages["chunked decode + transfer"] = (
        lambda: [x.cpu() for x in w.decode_chunks(latents)], rows["chunked decode + transfer"])
    return device_splits(stages, (w.pipe.unet, w.pipe.vae), w.pipe.device, trace_dir)


def measure(pipe, steps: int = 50, size: int = 512, seed: int = 0, reps: int = 2,
            trace_dir: Optional[str] = None) -> dict:
    """The stage rows, dispatch marks, device split and launches of the bench
    workload on ``pipe`` (see the module docstring). ``trace_dir``: where
    the split's Chrome traces go (None: no split)."""
    from univst_torch.bench import _launch_counts, _launches_since

    device = pipe.device
    w = Workload.build(pipe, steps, size, seed)
    log(f"device={device} frames={pipe.num_frames} size={size} steps={steps} "
        f"phase1={w.phase1} phase2={w.phase2}")
    rows, marks = {}, {}
    kv = timed(rows, "prepass", w.prepass, reps, device, marks=marks) if w.phase1 else None
    lat = w.init.float()
    for (s0, c), name, fn in ([(seg, "phase1 seg", lambda s=seg: w.phase1_chunk(kv, lat, *s))
                               for seg in w.phase1]
                              + [(seg, "phase2 seg", lambda s=seg: w.phase2_chunk(lat, *s))
                                 for seg in w.phase2]):
        timed(rows, name, fn, reps, device, divisor=c, marks=marks)
    px = timed(rows, "decode (sync'd, no transfer)",
               lambda: w.pipe.decode_latents_uint8(lat + 0.0), reps, device, marks=marks)
    timed(rows, "uint8 pixel transfer", px.cpu, reps, device)
    log(f"  ({px.numel() / 1e6:.1f} MB of uint8 pixels)")
    timed(rows, "chunked decode + transfer",
          lambda: torch.cat([c.cpu() for c in w.decode_chunks(lat + 0.0)]), reps, device)
    before = _launch_counts()
    timed(rows, "full stylize+decode+transfer", w.run, reps, device)
    k1, k2 = (n // (reps + 1) for n in _launches_since(before))
    closure = (rows.get("prepass", 0.0) + rows.get("phase1 seg", 0.0)
               + rows.get("phase2 seg", 0.0) + rows["chunked decode + transfer"])
    rows["closure"] = closure
    ratio = closure / rows["full stylize+decode+transfer"]
    log(f"{'closure (prepass + phases + chunked decode)':58s} {closure:9.1f} ms  "
        f"(x{ratio:.3f} of the full row)")

    for name, ms in marks.items():
        log(f"  mark {name:30s} +{ms:9.1f} ms at return, {rows[name]:9.1f} ms synchronised")
    split = device_split(w, kv, lat, rows, trace_dir) if trace_dir else None
    return dict(frames=pipe.num_frames, size=size, steps=steps, seed=seed, reps=reps,
                phase1=w.phase1, phase2=w.phase2, rows=rows, closure_ratio=ratio, marks=marks,
                device_split=split, launches={"k1": k1, "k2": k2})


def build_pipe(device: torch.device):
    """The bench's pipeline: SD-1.5 full width, bf16, on a card; the tiny
    variant in fp32 on the CPU. Returns it with the workload's size and
    steps."""
    from univst_torch.pipelines.sd import SDVideoPipeline

    on_card = device.type == "cuda"
    frames, size, steps = (16, 512, 50) if on_card else (4, 64, 10)
    pipe = SDVideoPipeline.build(variant="sd15" if on_card else "tiny", num_frames=frames,
                                 dtype=torch.bfloat16 if on_card else torch.float32, seed=0,
                                 device=device)
    return pipe, size, steps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cpu for the smoke size; default: the card")
    ap.add_argument("--seed", type=int, default=0, help="seed of the synthetic trajectories")
    ap.add_argument("--reps", type=int, default=2, help="timed calls a stage (best counts)")
    ap.add_argument("--trace_dir", default=os.path.join("results", "stages"),
                    help="where the device split's traces go")
    args = ap.parse_args(argv)
    device = resolve(args.device, "bench_stages")
    if device is None:
        return 2
    pipe, size, steps = build_pipe(device)
    emit("bench_stages", device, measure(pipe, steps, size, args.seed, args.reps,
                                         args.trace_dir))
    return 0


if __name__ == "__main__":
    sys.exit(main())
