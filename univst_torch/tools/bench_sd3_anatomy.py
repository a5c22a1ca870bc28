"""SD3 step-time anatomy — port of ``scripts/bench_sd3_anatomy.py``.

    python -m univst_torch.tools.bench_sd3_anatomy --probe segments|attn|matmul [--reps 3]
    python -m univst_torch.tools.bench_sd3_anatomy --probe ... --device cpu   # CPU smoke size

Each probe runs in a process of its own, as the JAX script's do (the
segments probe holds SD3-medium with its text encoders until the prompt is
encoded). SD3-medium at 1024 px, 16 frames, bf16, built as
``univst_torch.bench.measure_family('sd3')`` builds it (seed-0 weights, the
prompt encoded, then the text encoders freed); trajectories of 50 steps
from ``bench.synthetic_inputs``. On the CPU: the tiny variant in fp32, 4
frames at 64 px.

  * ``segments``: ``SD3VideoPipeline._stylize2_segment`` (the style
    capture and the injected 2-branch forward, in the shift window) and
    ``_stylize1_segment`` (stylized-only, past it), each over
    ``--segment_steps`` steps from the start of its phase, per step; each
    called with the arguments ``stylize_latents`` passes it, so the
    segments run over the whole trajectory in order give
    ``stylize_latents``' output bit for bit; K2's launches per step and
    each segment's output (shape, all finite: ``outputs``); one step of
    each kind under a ``torch.profiler`` trace (``--trace_dir``): device
    ms by kind of kernel, idle share (``device_split``). Then one-call
    MMDiT forwards at batch 2F, F and 1 (t = 500, no shift), with K2's
    launches per call.
  * ``attn``: K2 (``attention/video_flash.py::video_flash_attention_tokens``)
    alone at the real shape ``[B, F, 24, L + 333, L, 64]``, L = (px / 16)^2,
    ctx 333, B = 2 and 1, against its plain version
    (``univst_torch.tools.err_over_tol``, the bar of ``chip_smoke.py``'s
    kernel checks), beside its bound (the larger of ``video_flash.work``'s
    tensor FLOPs at the card's bf16 peak and its bytes at 3.35 TB/s) and
    PyTorch's fused attention on K/V expanded beforehand. The JAX probe's
    block-size sweep has no counterpart: K2's tiling is fixed in its CUDA
    source.
  * ``matmul``: the projection and MLP GEMMs at the real token count (2F
    frames of L + 333 tokens, width 1536), in TFLOP/s and as a share of
    the card's bf16 peak: the ceiling of the step's share that is not
    attention.

The JSON line's ``rows`` hold each row in ms.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Optional

import torch

from univst_torch.tools import device_splits, emit, err_over_tol, log, resolve, timed

HEADS, HEAD_DIM, CTX = 24, 64, 333  # SD3-medium; 77 CLIP + 256 T5 context tokens
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s


def _peak(device) -> Optional[float]:
    """The card's dense bf16 TFLOP/s (None on the CPU)."""
    from univst_torch.bench import device_info, peak_tflops

    return peak_tflops(device_info(device)["name"]) if device.type == "cuda" else None


@dataclasses.dataclass
class SD3Workload:
    """The SD3 family's stylization inputs on a built pipeline, with the
    segment arguments ``stylize_latents`` builds (style-singleton path)."""

    pipe: object
    content: torch.Tensor
    style: torch.Tensor
    init: torch.Tensor
    mask: torch.Tensor
    context3: torch.Tensor
    pooled3: torch.Tensor
    cfg: object
    seg: dict
    phase1: list
    phase2: list

    @classmethod
    def build(cls, pipe, steps: int, size: int, context, pooled, seed: int = 0):
        from univst_torch.bench import synthetic_inputs
        from univst_torch.core.config import SD3_STYLE_SHIFT, StyleTransferConfig
        from univst_torch.core.scheduler import generate_eta_values, scale_eta_window
        from univst_torch.pipelines.segments import phase_segments

        if not pipe.style_singleton or pipe.mesh is not None:
            raise ValueError("the SD3 segments probe runs one process on the style-singleton "
                             "path")
        content, style, init, mask = synthetic_inputs(pipe.device, steps, pipe.num_frames, size,
                                                      seed, channels=pipe.vae.cfg.latent_channels)
        cfg = StyleTransferConfig(num_steps=steps)
        # stylize_latents' own set-up (pipelines/sd3.py), without a mesh
        mu = pipe._mu(*init.shape[1:3])
        e_start, e_end = scale_eta_window(cfg.eta_start_step, cfg.eta_end_step, steps)
        etas = generate_eta_values(pipe.schedule.timesteps(steps, mu=mu), e_start, e_end,
                                   cfg.eta_base, cfg.eta_trend)
        seg = dict(content=content, style=style[:, :1], sigmas=pipe.schedule.sigmas(steps, mu=mu),
                   etas=etas, img=content[0].float(), mask=mask, cfg=cfg)
        phase1, phase2 = phase_segments(steps, SD3_STYLE_SHIFT.window_end())
        return cls(pipe, content, style, init, mask, torch.cat([context] * 3),
                   torch.cat([pooled] * 3), cfg, seg, phase1, phase2)

    def stylize(self):
        """The public call the segments reproduce."""
        return self.pipe.stylize_latents(self.content, self.style, self.init, self.content[0],
                                         self.context3, self.pooled3, mask=self.mask,
                                         cfg=self.cfg)

    @torch.inference_mode()
    def segment2(self, latents, s0: int, c: int):
        from univst_torch.core.config import SD3_STYLE_SHIFT

        return self.pipe._stylize2_segment(latents, s0, c, self.context3, self.pooled3,
                                           SD3_STYLE_SHIFT, **self.seg)

    @torch.inference_mode()
    def segment1(self, latents, s0: int, c: int):
        return self.pipe._stylize1_segment(latents, s0, c, self.context3, self.pooled3,
                                           **self.seg)

    def pieces(self, chunk: int):
        """Every step through segments of at most ``chunk`` steps, in order."""
        latents = self.init.float()
        for phase, fn in ((self.phase1, self.segment2), (self.phase2, self.segment1)):
            for s0, c in phase:
                for t0 in range(s0, s0 + c, chunk):
                    latents = fn(latents, t0, min(chunk, s0 + c - t0))
        return latents


def probe_segments(pipe, context, pooled, size: int, reps: int = 3, segment_steps: int = 2,
                   steps: int = 50, seed: int = 0, trace_dir: Optional[str] = None) -> dict:
    """Per-step times of the two segment kinds and the MMDiT forwards at
    batch 2F, F and 1 on a built SD3 pipeline (``context`` / ``pooled``:
    the empty prompt's, encoded before the text encoders were freed); with
    ``trace_dir``, one step of each segment kind (at its phase's middle)
    under a trace: device ms by kind of kernel and idle share
    (:func:`univst_torch.tools.device_splits`)."""
    from univst_torch.bench import _launch_counts, _launches_since
    from univst_torch.models.layers import VideoCtx

    device, frames = pipe.device, pipe.num_frames
    w = SD3Workload.build(pipe, steps, size, context, pooled, seed)
    log(f"device={device} frames={frames} size={size} phase1={w.phase1} phase2={w.phase2}")
    rows, launches, outputs, traced = {}, {}, {}, {}
    lat = w.init.float()
    for phase, fn, name in ((w.phase1, w.segment2, "phase1 capture+inject segment ({} steps, "
                             f"batch 1+{2 * frames})"),
                            (w.phase2, w.segment1, f"phase2 solo segment ({{}} steps, "
                             f"batch {frames})")):
        if not phase:
            continue
        (s0, c), = phase
        n = min(segment_steps, c)
        row = name.format(n)
        before = _launch_counts()
        out = timed(rows, row, lambda: fn(lat, s0, n), reps, device, divisor=n)
        launches[row] = {"k2 a step": _launches_since(before)[1] // ((reps + 1) * n)}
        outputs[row] = {"shape": list(out.shape), "finite": bool(torch.isfinite(out).all())}
        traced[name.split()[0] + " step"] = (lambda fn=fn, t=s0 + c // 2: fn(lat, t, 1),
                                             rows[row] / n)

    ctx2, pl2 = w.context3[0::2], w.pooled3[0::2]
    x2 = torch.cat([w.init, w.init])
    one = VideoCtx(num_frames=1, frame_indices=())
    dt = pipe.dtype
    fwd = {
        f"MMDiT fwd batch {2 * frames} (no shift gate)":
            lambda d=pipe._denoise_fn(ctx2, pl2, None): d(x2, 500.0, 45)[0],
        f"MMDiT fwd batch {frames}":
            lambda d=pipe._denoise_fn(ctx2[:1], pl2[:1], None): d(w.init, 500.0, 45)[0],
        "MMDiT fwd batch 1 (style capture cost)":
            lambda: pipe.mmdit(w.init[:1].to(dt), 500.0, ctx2[:1].to(dt), pl2[:1].to(dt), one)[0],
    }
    for name, fn in fwd.items():
        before = _launch_counts()
        with torch.inference_mode():
            timed(rows, name, fn, reps, device)
        launches[name] = {"k2": _launches_since(before)[1] // (reps + 1)}
    split = device_splits(traced, (pipe.mmdit,), device, trace_dir) if trace_dir else None
    return dict(probe="segments", frames=frames, size=size, steps=steps, reps=reps,
                segment_steps=segment_steps, phase1=w.phase1, phase2=w.phase2, rows=rows,
                launches=launches, outputs=outputs, device_split=split)


def probe_attn(device, frames: int, size: int, reps: int = 3, dtype=torch.bfloat16,
               seed: int = 0) -> dict:
    """K2 at the SD3 joint attention's shape, B = 2 and 1: its time, its
    error against the plain version, its bound and SDPA's time on the
    expanded K/V."""
    import torch.nn.functional as F

    from univst_torch.attention.ops import cross_frame_kv_heads
    from univst_torch.attention.video_flash import (
        video_flash_attention_tokens, video_flash_attention_tokens_plain, work,
    )
    from univst_torch.bench import _launch_counts, _launches_since
    from univst_torch.core.config import SD3_FRAME_INDICES

    idx, h, dh, lc = SD3_FRAME_INDICES, HEADS, HEAD_DIM, CTX
    l = (size // 16) ** 2
    lq = l + lc
    peak = _peak(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    rows, cases = {}, {}
    for b in (2, 1):
        def r(*s):
            return torch.randn(s, generator=gen, device=device).to(dtype)

        q, k, v = r(b, frames, lq, h, dh), r(b, frames, l, h, dh), r(b, frames, l, h, dh)
        kw = dict(ctx_k=r(b, frames, lc, h, dh), ctx_v=r(b, frames, lc, h, dh), ctx_valid=lc)
        name = f"K2 B={b} F={frames} H={h} Lq={lq} L={l} dh={dh} ctx {lc}"
        before = _launch_counts()
        got = timed(rows, name, lambda: video_flash_attention_tokens(q, k, v, idx, **kw), reps,
                    device)
        launches = _launches_since(before)[1] // (reps + 1)
        want = video_flash_attention_tokens_plain(q, k, v, idx, **kw)
        ratio = err_over_tol(got, want)
        err = (got.float() - want.float()).abs().max().item()
        del got, want

        def heads(x):
            return x.reshape(b * frames, x.shape[2], h, dh).transpose(1, 2).contiguous()

        qh = heads(q)
        ke = torch.cat([cross_frame_kv_heads(heads(k), frames, idx), heads(kw["ctx_k"])], dim=2)
        ve = torch.cat([cross_frame_kv_heads(heads(v), frames, idx), heads(kw["ctx_v"])], dim=2)
        timed(rows, f"SDPA on expanded K/V, B={b}",
              lambda: F.scaled_dot_product_attention(qh, ke, ve), reps, device)
        del qh, ke, ve
        wk = work([b, frames, h, lq, l, dh], idx, lc, itemsize=torch.finfo(dtype).bits // 8)
        bound = {"tensor": wk.flops / (peak * 1e12) * 1e3 if peak else None,
                 "bytes": wk.bytes / PEAK_BYTES * 1e3 if device.type == "cuda" else None}
        ms = rows[name]
        case = dict(shape=[b, frames, h, lq, l, dh], ctx=lc, k2_launches=launches,
                    max_abs_err=err, err_over_tol=ratio, flops=wk.flops,
                    effective_tflops=wk.flops / ms / 1e9,
                    bound_ms=max(bound.values()) if peak else None, bound_terms_ms=bound)
        cases[f"B={b}"] = case
        log(f"{'':58s} -> {case['effective_tflops']:8.1f} TFLOP/s effective, err/tol "
            f"{ratio:.3f}, bound {case['bound_ms']} ms, K2 launches {launches}")
    return dict(probe="attn", frames=frames, size=size, reps=reps, rows=rows, cases=cases,
                peak_tflops=peak)


def probe_matmul(device, frames: int, size: int, reps: int = 3, d: int = HEADS * HEAD_DIM,
                 dtype=torch.bfloat16, seed: int = 0) -> dict:
    """The MLP GEMM pair and the qkv GEMM at 2F frames of L + 333 tokens."""
    import torch.nn.functional as F

    tokens = 2 * frames * ((size // 16) ** 2 + CTX)
    peak = _peak(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def r(*s):
        return (torch.randn(s, generator=gen, device=device) / s[0] ** 0.5).to(dtype)

    x, w1, w2, wq = r(tokens, d), r(d, 4 * d), r(4 * d, d), r(d, 3 * d)
    rows, tflops = {}, {}
    for name, fn, flops in (
            (f"MLP GEMM pair [{tokens},{d}]x[{d},{4 * d}]x[{4 * d},{d}]",
             lambda: F.gelu(x @ w1) @ w2, 2 * tokens * d * 4 * d * 2),
            (f"qkv GEMM [{tokens},{d}]x[{d},{3 * d}]", lambda: x @ wq, 2 * tokens * d * 3 * d)):
        with torch.inference_mode():
            timed(rows, name, fn, reps, device)
        tflops[name] = flops / rows[name] / 1e9
        log(f"{'':58s} -> {tflops[name]:8.1f} TFLOP/s effective"
            + (f" ({tflops[name] / peak:.1%} of {peak:.0f})" if peak else ""))
    return dict(probe="matmul", frames=frames, size=size, reps=reps, tokens=tokens, width=d,
                rows=rows, tflops=tflops, peak_tflops=peak)


def build_pipe(device: torch.device):
    """SD3-medium as the bench's SD3 family builds it (the tiny variant in
    fp32 on the CPU), its prompt encoded and its text encoders freed.
    Returns the pipeline, the context, the pooled embedding and the size."""
    from univst_torch.pipelines.sd3 import SD3VideoPipeline

    on_card = device.type == "cuda"
    frames, size = (16, 1024) if on_card else (4, 64)
    pipe = SD3VideoPipeline.build(variant="sd3" if on_card else "tiny", num_frames=frames,
                                  dtype=torch.bfloat16 if on_card else torch.float32, seed=0,
                                  device=device)
    context, pooled = pipe.encode_prompt("")
    pipe.free_text_encoders()
    return pipe, context, pooled, size


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--probe", default="segments", choices=("segments", "attn", "matmul"))
    ap.add_argument("--device", default=None, help="cpu for the smoke size; default: the card")
    ap.add_argument("--seed", type=int, default=0, help="seed of the synthetic inputs")
    ap.add_argument("--reps", type=int, default=3, help="timed calls a row (best counts)")
    ap.add_argument("--segment_steps", type=int, default=2,
                    help="steps of each timed segment (segments probe)")
    ap.add_argument("--trace_dir", default=os.path.join("results", "sd3_anatomy"),
                    help="where the segments probe's device split traces go")
    args = ap.parse_args(argv)
    device = resolve(args.device, "bench_sd3_anatomy")
    if device is None:
        return 2
    on_card = device.type == "cuda"
    frames, size = (16, 1024) if on_card else (4, 64)
    dtype = torch.bfloat16 if on_card else torch.float32
    if args.probe == "segments":
        pipe, context, pooled, size = build_pipe(device)
        out = probe_segments(pipe, context, pooled, size, args.reps, args.segment_steps,
                             seed=args.seed, trace_dir=args.trace_dir)
    elif args.probe == "attn":
        out = probe_attn(device, frames, size, args.reps, dtype, args.seed)
    else:
        from univst_torch.models.mmdit import MMDiTConfig

        d = MMDiTConfig.sd3_medium().hidden if on_card else MMDiTConfig.tiny().hidden
        out = probe_matmul(device, frames, size, args.reps, d, dtype, args.seed)
    emit("bench_sd3_anatomy", device, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
