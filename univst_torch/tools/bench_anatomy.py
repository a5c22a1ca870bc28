"""Step-time anatomy of the bench workload — port of ``scripts/bench_anatomy.py``.

    python -m univst_torch.tools.bench_anatomy [--reps 3] [--seed 0]
    python -m univst_torch.tools.bench_anatomy --device cpu    # CPU smoke size

Times the pieces of an SD-1.5 stylization step on the bench workload
(``bench_stages``' workload: SD-1.5 at full width, bf16, 16 frames at 512
px, 50 steps; on the CPU the tiny variant, fp32, 4 frames at 64 px, 10
steps), each warm, the best of ``--reps``, ending in a synchronise:

  * the style pre-pass, the phase-1 chunk (the injected 2-branch batch, 2F
    rows) and the phase-2 solo chunk (F rows), per step (given a
    ``bench_stages.measure`` result on the same pipeline and workload,
    ``measure`` takes these rows from it: they time the same calls);
  * one-call UNet forwards at t = 301: batch 2F with the pre-pass's K/V
    injected, batch F on the stylized-only path;
  * ``attention/ops.py::video_mha`` alone at b = 2F and F rows, with the
    PnP and the base index sets, at the 64x64, 32x32 and 16x16 levels
    (8 heads of 40, 80 and 160). The dispatch gate (``video_mha``: L >=
    1024 and L % 128 == 0) sends the first two levels to K1 and the 16x16
    one to PyTorch's fused attention; each row's path is read from K1's
    launch counter (``attn_paths``), not assumed;
  * the VAE decode to uint8 of the whole clip.

The JSON line's ``rows`` hold each row in ms.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import torch

from univst_torch.tools import emit, log, resolve, timed


def attention_rows(rows: dict, device, dtype, frames: int, size: int, reps: int,
                   seed: int = 0) -> dict:
    """``video_mha`` on random ``[b, L, d]`` q = k = v at the UNet's three
    attention levels, b in (2F, F), both SD index sets. Returns each row's
    K1 launches per call."""
    from univst_torch.attention.ops import video_mha
    from univst_torch.bench import _launch_counts, _launches_since
    from univst_torch.core.config import SD_BASE_FRAME_INDICES, SD_PNP_FRAME_INDICES

    gen = torch.Generator(device=device).manual_seed(seed)
    h8, heads = size // 8, 8
    paths = {}
    for b in (2 * frames, frames):
        for idx_name, idx in (("pnp 2-src", SD_PNP_FRAME_INDICES),
                              ("base 3-src", SD_BASE_FRAME_INDICES)):
            for hw, d in ((h8, 320), (h8 // 2, 640), (h8 // 4, 1280)):
                q = torch.randn((b, hw * hw, d), generator=gen, device=device).to(dtype)
                name = f"video attn b={b} L={hw * hw} d={d} ({idx_name})"
                before = _launch_counts()
                with torch.inference_mode():
                    timed(rows, name, lambda: video_mha(q, q, q, heads, frames, idx), reps,
                          device)
                k1 = _launches_since(before)[0] // (reps + 1)
                paths[name] = {"k1_launches": k1, "level": f"{hw}x{hw}"}
                log(f"{'':58s} -> {'K1' if k1 else 'no K1 launch'}")
    return paths


def measure(pipe, steps: int = 50, size: int = 512, seed: int = 0, reps: int = 3,
            stages: Optional[dict] = None) -> dict:
    """The anatomy rows on a built SD pipeline (see the module docstring).
    ``stages``: ``bench_stages.measure``'s result on ``pipe`` at the same
    steps, size and seed, whose pre-pass and segment rows stand for the
    chunk rows (the same calls on the same inputs) instead of timing them
    again."""
    from univst_torch.tools.bench_stages import Workload

    device, frames = pipe.device, pipe.num_frames
    w = Workload.build(pipe, steps, size, seed)
    log(f"device={device} frames={frames} size={size} phase1={w.phase1} phase2={w.phase2}")
    rows = {}
    lat = w.init.float()
    (s0, c1), = w.phase1
    chunks = [("style pre-pass (batch k1 single-frame fwd)", "prepass", w.prepass, 1),
              (f"phase1 chunk ({c1} steps, batch {2 * frames})", "phase1 seg",
               lambda: w.phase1_chunk(kv, lat, s0, c1), c1)]
    if w.phase2:
        (s2, c2), = w.phase2
        chunks.append((f"phase2 solo chunk ({c2} steps, batch {frames})", "phase2 seg",
                       lambda: w.phase2_chunk(lat, s2, c2), c2))
    if stages is None:
        kv = timed(rows, chunks[0][0], w.prepass, reps, device)
        for name, _, fn, c in chunks[1:]:
            timed(rows, name, fn, reps, device, divisor=c)
    else:
        got = {k: stages[k] for k in ("frames", "size", "steps", "seed")}
        if got != dict(frames=frames, size=size, steps=steps, seed=seed):
            raise ValueError(f"the stage rows are of another workload: {got}")
        kv = w.prepass()
        for name, key, _, c in chunks:
            rows[name] = stages["rows"][key]
            line = f"{name:58s} {rows[name]:9.1f} ms"
            if c != 1:
                rows[f"{name} per step"] = stages["rows"][f"{key} per step"]
                line += f"  ({rows[f'{name} per step']:7.1f} ms/step)"
            log(line + "  (bench_stages' row)")

    # one-call UNet forwards at t = 301
    ctx2 = torch.cat([w.context3[:1], w.context3[2:3]])
    two = pipe._denoise_fn(ctx2, pipe.pnp_frame_indices, pipe.style_shift_cfg)
    kv0 = tuple((k[:1], v[:1]) for k, v in kv)
    x2 = torch.cat([w.init, w.init])
    solo = pipe._denoise_fn(w.context3[2:3], pipe.pnp_frame_indices, None, pnp_plain=True)
    with torch.inference_mode():
        timed(rows, f"UNet fwd batch {2 * frames} (2-branch, injected KV)",
              lambda: two(x2, 301, 1, style_kv=kv0)[0], reps, device)
        timed(rows, f"UNet fwd batch {frames} (solo)", lambda: solo(w.init, 301, 40)[0], reps,
              device)
    paths = attention_rows(rows, device, pipe.dtype, frames, size, reps, seed)
    timed(rows, f"VAE decode -> uint8 ({frames} frames @{size})",
          lambda: pipe.decode_latents_uint8(w.init), reps, device)
    return dict(frames=frames, size=size, steps=steps, reps=reps, phase1=w.phase1,
                phase2=w.phase2, chunk_rows="bench_stages" if stages else "timed", rows=rows,
                attn_paths=paths)


def main(argv=None) -> int:
    from univst_torch.tools.bench_stages import build_pipe

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cpu for the smoke size; default: the card")
    ap.add_argument("--seed", type=int, default=0, help="seed of the synthetic inputs")
    ap.add_argument("--reps", type=int, default=3, help="timed calls a row (best counts)")
    args = ap.parse_args(argv)
    device = resolve(args.device, "bench_anatomy")
    if device is None:
        return 2
    pipe, size, steps = build_pipe(device)
    emit("bench_anatomy", device, measure(pipe, steps, size, args.seed, args.reps))
    return 0


if __name__ == "__main__":
    sys.exit(main())
