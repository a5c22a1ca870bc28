#!/usr/bin/env python3
"""Drive the PyTorch port's SD-1.5 (with and without the pixel smoother),
SD-2.1, AnimateDiff-v2, SD3-medium, SD3.5-medium and SD3.5-large workflows
on one NVIDIA GPU, profile three of its forwards, run its tools
(``univst_torch/tools``), and run the SD-1.5 and AnimateDiff workflows
frame-parallel, and SD3 on a ``data x tensor`` mesh, as ranks that share
the card.

    python3 chip_smoke.py [--steps N] [--ad_steps N] [--sd3_steps N] [--sd35l_steps N]

Run from the root of a checkout, on a machine with a CUDA card. Phases, each
ending in ``torch.cuda.synchronize()`` so a fault surfaces where it happens;
none catches its own failure:

1. Device: the card's name and power limit (nvidia-smi), torch/CUDA versions.
2. Build: compiles every kernel source of ``univst_torch/csrc`` with nvcc
   (sm_90a), one nvcc per source, all started together.
3. Kernels against their plain PyTorch versions, in bf16 at the shapes the
   main paths give them (and small ragged bf16 and fp32 cases each):
   the error against a tolerance that follows the output's scale
   (``univst_torch.tools.err_over_tol``), a planted fault per kernel that
   the same check must reject, kernel / plain / library times (CUDA
   events) and the card's least time for the work (bound: the largest of
   tensor-core FLOPs, the exponentials on the MUFU and the FMA pipe
   together, and bytes, from ``univst_torch.attention.video_flash.work``;
   each term on a ``[bound]`` line). K1 is the head-major video flash attention of the SD UNet (SD-1.5:
   8 heads of 40 and 80; SD-2.1: 5 and 10 heads of 64, each row with its
   planted fault), K2 the token-major one of the SD3 MMDiT (24 heads; 38
   for SD3.5-large, and a ``tensor=4`` rank's 10 or 9 of them). Then
   the host's cost of one wrapper call against the bare launch
   (``[dispatch]``).
4. SD-1.5 path: ``SDVideoPipeline`` (SD-1.5 widths, 512 px, 16 frames,
   bf16, seeded random weights) through content inversion with feature
   capture, single-frame style inversion, mask propagation, stylization
   (style pre-pass, injected 2-branch phase, stylized-only phase) and the
   chunked temporal-VAE decode, plus the inversion -> reconstruction round
   trip. K1 must launch 10 times per 16-frame UNet forward, K2 never.
   Then ``[bench]``: the headline bench's own summary
   (``univst_torch.bench.summarize``, ``headline``) of that run: its
   stylize + decode and inversion seconds, its round trip's latent PSNR and
   one more stylization of its inputs under the FLOP counter; its JSON line
   (``bench.py``'s keys and the card's) on a ``[bench]`` line, every number
   finite, 0 < MFU <= 1.05, K1 10 x steps a stylization, K2 never. After
   the profile (10.), ``[sd21]``: the same path and gates with SD-2.1
   (``variant='sd21'``: heads of 64 at every level, linear ``proj_in`` /
   ``proj_out``, the 1024-wide OpenCLIP-H context; K1 at H = 5 and 10,
   dh = 64), its stage seconds and its own peak memory.
5. SD-1.5 fallback: the same pipeline and trajectories, stylized once off
   the style-singleton path (capture-and-inject, what the transfer CLI
   falls back to on a style trajectory whose frames differ), with the
   content trajectory as the style. Per phase-1 step a 16-frame capture
   forward and the injected 2-branch forward, per phase-2 step one
   forward: K1 must launch 10 x (2 k1 + (n - k1)) times (k1 = the shift
   window's end, 26 of 30 steps: 560), K2 never; the latents finite.
   Then the SD round trip once with AnimateDiff's linear betas (its PSNR),
   and an on-card Lucas-Kanade check (a smooth 512x512 image shifted by 2
   px: the flow recovers the shift).
6. SD-1.5 with the pixel smoother: the same pipeline, trajectories and
   masks, ``smoother='pixel'``, LK flow, smoothing steps [20, 25), radius
   2. Phase 1 is the style-singleton path (one single-frame style pre-pass,
   then the injected 2-branch step) for max(26, 25) = 26 steps, then 4
   stylized-only steps: K1 must launch 10 x n = 300 times, K2 never; each
   smoothing step decodes x0, runs 2 x 58 LK flows, warp-averages and
   re-encodes. The stylization's seconds are split into the pre-pass, the
   2-branch and solo forwards, decode, flow, warp-average and encode; the
   latents must be finite and differ from the unsmoothed stylization.
7. RAFT-large (random weights from seed 0, fp32) on the 116 flows of one
   smoothing step's decoded frames in one batch, and on one pair: ms per
   call, peak memory, every flow finite, one pair against the CPU.
8. AnimateDiff-v2 path: ``build_animatediff`` at full width (the SD-1.5 2D
   UNet, 21 motion modules of 8 heads with a 24-frame position table, SVD
   VAE, CLIP-L; bf16, seeded random weights, every motion module's
   ``proj_out`` filled from seed 1 so the temporal path reaches the
   result), 512 px, 16 frames: content inversion with EasyInv and the
   feature captured, 16-frame style inversion, mask propagation,
   capture-and-inject stylization from the raw content noise, chunked
   decode, inversion -> reconstruction round trip. This backbone builds no
   cross-frame K/V: K1 and K2 must launch 0 times. After the timed path,
   with every ``proj_out`` back at zero (the reference's init: the motion
   modules are identities), the round-trip PSNR on the same latents and
   prompt along a ladder that turns the AD UNet into the SD path's UNet one
   difference at a time (``[ad_psnr]``, ``AD_PSNR_STEPS`` = 10 steps).
9. SD3 paths: ``SD3VideoPipeline`` at full width (bf16, seeded random
   weights, T5-XXL, CLIP-L and CLIP-G, the 16-channel VAE), 1024 px, 16
   frames: prompt encoding (then the text encoders are freed), VAE encode,
   RF-Solver content inversion with the block-20 feature captured at step
   5, single-frame style inversion, mask propagation on that feature,
   stylization (style-singleton 2-branch phase, then the stylized-only
   phase), decode and the controlled-velocity reconstruction; the peak
   device memory of each stage. Per step, four forwards run video attention
   (inversion's two, the reconstruction, one stylization forward;
   single-frame forwards run none), each one K2 launch per attention: K2
   must launch 4 x (blocks + dual-attention blocks) x steps times, K1
   never. ``[sd3]``: SD3-medium (24 blocks, 24 heads of 64; 96 a step) at
   ``--sd3_steps``, both stylization phases. ``[recipe]`` (10b.) runs
   beside it. ``[sd35m]``: SD3.5-medium (24 blocks, 24 heads of 64, q/k RMS
   norms, dual attention, without context, in blocks 0-12; 148 a step) at
   ``SD35M_STEPS``, the 2-branch phase only.
   ``[sd35l]``: SD3.5-large (38 blocks, 38 heads of 64, q/k RMS norms; 152
   a step) at ``--sd35l_steps``.
10. Profile (``[profile]``): one 16-frame SD-1.5 UNet forward at 512 px
   with B = 1 (inversion's), the injected 2-branch stylization forward (B =
   2), and one SD3.5-medium forward at 1024 px (B = 1), on the pipelines
   the SD and SD3.5-medium phases built. Each after an untraced warm-up:
   its time (CUDA events), one ``torch.profiler`` trace
   (``univst_torch.utils.profiling``: device time by kind of kernel, idle
   share; the Chrome trace under ``results/profile/``) with the K1 / K2
   launches in it checked, and its matmul / conv / attention FLOPs
   (``univst_torch.utils.flops``: effective TFLOP/s and MFU against 989
   TFLOP/s).
10b. The tools (``univst_torch/tools``), after the SD-1.5 profile, on
   ``[main]``'s pipeline: ``[stages]`` (``bench_stages.measure``: the
   bench workload, 50 steps, cut into the style pre-pass, the phase-1 and
   phase-2 segments and the decode, each warm; dispatch marks; each
   stage's device split; gated: every row finite and positive, the
   closure within 0.85-1.15 of the full run, K1 500 launches a run, device
   time in every split), ``[anatomy]`` (``bench_anatomy.measure``: the
   chunks, the one-call forwards, ``video_mha`` at the three levels, the
   decode; gated: the 64x64 and 32x32 rows launched K1, the 16x16 ones did
   not), ``[compare]`` (``compare_outputs`` on ``[main]``'s frames against
   themselves, every gate passing, LPIPS on the card with seed-0 AlexNet
   weights; with one frame inverted ``--psnr-min 40`` exits 1) and
   ``[recipe]`` (``tools/start_sd.sh`` as a subprocess on the card, full
   width, ``PRETRAINED`` at ``[weights_day]``'s SD-1.5 directory, on
   ``demo-fly-tiny``'s 4 frames at 64 px and the CLIs' 50 steps, beside
   ``[sd3]``; gated: the three model stages loaded the directory, both
   trajectories, {0, 255} masks, stylized frames). After ``[sd3]``, on
   its pipeline,
   ``[sd3_anatomy]`` (``bench_sd3_anatomy``'s three probes: the segments
   over ``SD3_SEGMENT_STEPS`` steps, one step of each traced, and the
   MMDiT forwards at 2F, F and 1 frame; gated: each segment's output
   finite and of the latents' shape, K2 24 launches a segment step and a
   video forward, none for the single frame; K2 alone at
   ``[B,16,24,4429,4096,64]``, ctx 333, B = 2 and 1, within
   ``err_over_tol`` <= 1 of its plain version; the GEMMs). The tools' rows
   are timed at ``TOOL_REPS`` = 1; ``[anatomy]`` takes its chunk rows from
   ``[stages]`` (the same calls on the same inputs).
10c. Weights day (``[weights_day]``, after ``[compare]``):
   ``tools/make_synthetic_checkpoints`` writes the SD-1.5 and
   AnimateDiff-v2 checkpoint directories at full width (seed 0, fp32,
   10.46 GB) under ``results/``, with the port's own safetensors writer;
   ``SDVideoPipeline.build`` and ``build_animatediff`` load them in bf16
   (warm reads). Gated: both loaded pipelines hold the seed-0 builds'
   parameters and buffers bit for bit (SD-1.5: ``[main]``'s own); one
   16-frame 512 px B = 1 UNet forward of the loaded SD-1.5 equals the
   seeded one's bit for bit, 10 K1 launches; a renamed key and a missing
   shard are refused. Printed: GB and seconds of the write and of each
   load, host RSS, the card. The directory is removed after ``[recipe]``.
11. Frame parallelism (``[mesh]``, ``univst_torch.distributed``): K1's
   shard form (q of a rank's frames, K/V of its frames and the halo frames
   its index set reads, explicit slot tables; rank 1 of 2 at
   ``[2,8,8,4096,40]``, both index sets, rank 2 of 4 at ``[2,4,...]``,
   the 32x32 level) against its plain version and against the unsharded
   16-frame call's rows, a slot table shifted by one frame that the check
   must reject, and K2's shard form (also at a tensor rank's share of the
   heads, 12 of 24 and 19 of 38, with a planted slot-table shift). Then
   jobs of 2 or 4 ranks (``torch.multiprocessing`` spawn, gloo over a file
   store, every rank on ``cuda:0``, a process-group timeout of 300 s):
   SD-1.5 bf16 at 512 px / 16 frames / 6 steps over 2 ranks; SD-1.5 fp32
   at 256 px / 8 frames / 6 steps over 2 and 4 ranks; AnimateDiff-v2 bf16
   at 512 px / 16 frames / 6 steps over 2 ranks; each against a
   one-process run at its steps (``MESH_JOBS``), which this process runs
   while the job's ranks build and run their workflow (the ranks wait for
   its inputs before the checks that read them; the gloo ranks take the
   host's time, the one-card runs the card's). Each rank prints its stage
   seconds, its collective census per stage and per inversion forward, the
   host milliseconds in collectives, its peak memory and its launches (K1:
   10 per SD forward at 512 px, 5 at 256 px). Gated: the workflow finite,
   its masks equal on >= 99.5% of the pixels, and two forwards on the
   reference's inputs (``_forward_pair``): with the UNet in fp32 within
   rtol 2e-4 / atol 2e-5, and, for the bf16 jobs, in bf16 no further from
   the reference's fp32 forward than the reference's own bf16 forward is,
   up to ``MESH_BF16_RATIO``. Each bf16 job also has its floor: the same
   workflow in fp32 on one card from the same inputs. Then every stage
   (encode, content and style inversion, mask propagation, stylization,
   decode, reconstruction) runs once more on the ranks, fed the one-card
   run's own inputs to that stage (the fp32 reference's, or the bf16 job's
   fp32 floor's), and is gated (``_stage_gates``): fp32 within the same
   bar, bf16 within ``MESH_BF16_RATIO`` of the one-card bf16 pipeline fed
   the same inputs. Reported: the workflow bars (``_compare``), the
   workflow against its floor (``_workflow_floor``) and, for the fp32
   jobs, what the encode's batch shape alone does on one card
   (``_encode_batch_floor``). ``[mesh] smooth``: the SD bf16 job's ranks
   and its one-card fp32 floor and bf16 runs also stylize with the pixel
   smoother (LK, smoothing steps [4, 6), radius 2) from the same
   trajectories, masks and context, and run one smoothing step alone with
   the VAE in fp32 on the floor's inputs to it, with LK and with
   RAFT-large (``_mesh_smooth``, ``_check_mesh_smooth``): each rank decodes
   its own frames, fetches the +/-2 decoded frames its keys read in one
   ``smooth_halo`` all-to-all (6.29 MB) and runs its own 58 of the 116
   flows; gated stage by stage in fp32 and in bf16 against the floor, K1
   100 launches a rank.
12. SD3 on a ``data x tensor`` mesh (``[mesh]``, ``SD3_MESH_JOBS``):
   SD3-medium bf16 at 512 px / 16 frames / 2 steps over ``data=2`` and
   SD3.5-medium bf16 at 512 px / 8 frames / 1 step over ``data=2,
   tensor=2`` (4 gloo ranks that build one at a time, each freeing its
   text encoders, then ``with_mesh`` splits the MMDiT over the tensor
   axis), each against its one-card bf16 run and fp32 floor, gated as
   above (``_forward_pair_sd3``: the inversion forward and the injected
   2-branch forward with its single-frame capture); K2 launches 4 x
   (blocks + dual blocks) x steps a rank; the census per forward (halo
   all-to-alls, all-reduces and their MB). Then ``[mesh_sd3 tp]``
   (``SD3_TP_FORWARD``): the forward pair of SD3.5-large's MMDiT alone
   (38 heads of 64, depth cut to 4 of its 38 blocks), 512 px, 4 frames, on
   ``data=1,tensor=4`` (10, 10, 9 and 9 heads a rank) against one card,
   gated the same way.

Each path's launch counters are zeroed just before it and read just after;
a kernel's ``launches`` in the JSON line is the sum over its paths, each
path's own count under ``launches_by_path`` (K1: the SD, SD-2.1, bench,
SD-fallback, weights_day, smoother, profile, stages, anatomy, mesh and
mesh_smooth paths; K2: SD3-medium, its anatomy's segments and forwards,
SD3.5-medium, SD3.5-large, profile, mesh, mesh_sd3 and mesh_sd3_tp). The
last line is ``{"ok": true, "device": {...}}``; the lines before it hold
the per-kernel JSON and the card's name and power limit. Any failed check
exits non-zero. ``--steps``
(SD-1.5) and ``--ad_steps`` default to 30: the fewest that run both
stylization phases (the shift windows of the 50-step constants close after
step 25 (SD) and 24 (AD)); 50 is the full workload. ``--sd3_steps``
(SD3-medium) defaults to 32, the fewest that run both phases through the
workflow (SD3's shift window closes after step 30). ``--sd35l_steps`` and
``SD35M_STEPS`` are 4, cut to keep the script within its time limit on
slower hosts: the SD3.5 models run the 2-branch stylization phase only, at
the widths whose stylized-only phase SD3-medium runs. ``[recipe]`` runs
beside ``[sd3]`` (started just before it, waited for just after it: the
recipe's host-bound CLIs overlap a device-bound path). Each phase's
seconds and the script's so far print on a ``[clock]`` line.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16 = 989e12   # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_FP32 = 67e12    # H100 SXM fp32 (non-tensor) FLOP/s
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
MUFU_EXP_PER_CLOCK = 16  # MUFU.EX2 results per clock per SM (Hopper)
FMA_PER_CLOCK = 128  # fp32 FMA-pipe operations per clock per SM
FMA_OPS_PER_EXP = 6  # the kernel's cubic 2^x (ex2_fma): 3 adds to round, 3 FMAs
TPU_KERNEL = "univst_tpu/attention/pallas_attention.py:193"
TPU_KERNEL_FOLDED = "univst_tpu/attention/pallas_attention.py:546"
SOURCE = "univst_torch/csrc/video_flash_attention.cu"


def _sync():
    import torch

    torch.cuda.synchronize()


def _time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _nvidia_smi(query: str = "name,power.limit") -> str:
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


@functools.lru_cache(maxsize=1)
def _sm_clocks() -> float:
    """SM clocks per second summed over the card: SM count x the maximum
    SM clock."""
    import torch

    mhz = float(_nvidia_smi("clocks.max.sm").split()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count * mhz * 1e6


def _exp_rate() -> float:
    """Exponentials per second on both units that can make them: the MUFU at
    16 per clock per SM, and the FMA pipe at 128 operations per clock per SM
    over the cubic's 6 (37.3 per clock per SM in all)."""
    return (MUFU_EXP_PER_CLOCK + FMA_PER_CLOCK / FMA_OPS_PER_EXP) * _sm_clocks()


def phase_device():
    import torch

    smi = _nvidia_smi()
    print(f"[device] {smi}")
    print(f"[device] exponentials: {_exp_rate():.4g}/s on MUFU + FMA pipe, "
          f"{MUFU_EXP_PER_CLOCK * _sm_clocks():.4g}/s on MUFU alone "
          f"({_nvidia_smi('clocks.max.sm')})")
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    return smi


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from univst_torch import _build

    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.time()
    with ThreadPoolExecutor(len(names)) as pool:
        paths = list(pool.map(_build.build, names))
    for path in paths:
        print(f"[build] {os.path.relpath(path, REPO)} in {time.time() - t0:.2f}s", flush=True)


def _vfa_case(b, f, h, l, dh, idx, dtype, lq=None, lc=None, ctx_valid=None, reps=5,
              plant=False):
    """Kernel vs plain (and SDPA on the expanded K/V) on one shape. With
    ``plant``, also run the kernel with the scale of the next 16-deep MMA
    step above ``dh`` (a plausible fault: 48 at dh = 40, 80 at dh = 64) and
    require the same check to reject it."""
    import torch
    import torch.nn.functional as F

    from univst_torch.attention.ops import cross_frame_kv
    from univst_torch.attention.video_flash import (
        video_flash_attention, video_flash_attention_plain,
    )
    from univst_torch.tools import err_over_tol

    lq = l if lq is None else lq
    gen = torch.Generator(device="cuda").manual_seed(l * dh + len(idx))

    def r(*s):
        return torch.randn(s, generator=gen, device="cuda").to(dtype)

    q, k, v = r(b, f, h, lq, dh), r(b, f, h, l, dh), r(b, f, h, l, dh)
    kw = {}
    if lc:
        kw = dict(ctx_k=r(b, f, h, lc, dh), ctx_v=r(b, f, h, lc, dh), ctx_valid=ctx_valid)
    got = video_flash_attention(q, k, v, idx, **kw)
    _sync()
    want = video_flash_attention_plain(q, k, v, idx, **kw)
    _sync()
    err = (got.float() - want.float()).abs().max().item()
    ratio = err_over_tol(got, want)
    if not ratio <= 1.0:
        raise AssertionError(f"video_flash_attention {tuple(q.shape)} {idx} {dtype}: "
                             f"kernel vs plain at {ratio:.3g}x the tolerance "
                             f"(max abs err {err})")
    planted = None
    if plant:
        pad = (dh // 16 + 1) * 16  # the next MMA depth above dh
        wrong = video_flash_attention(q, k, v, idx, sm_scale=pad**-0.5, **kw)
        planted = err_over_tol(wrong, want)
        if not planted > 1.0:
            raise AssertionError(f"the check passed a kernel scaled by 1/sqrt({pad}) "
                                 f"instead of 1/sqrt({dh}) ({planted:.3g}x the tolerance)")
        print(f"[kernel] planted fault (scale 1/sqrt({pad})) rejected at "
              f"{planted:.3g}x the tolerance", flush=True)
    ms = _time_ms(lambda: video_flash_attention(q, k, v, idx, **kw), reps)
    plain_ms = _time_ms(lambda: video_flash_attention_plain(q, k, v, idx, **kw), 1)
    # yardstick: PyTorch's fused attention on the expanded K/V, the frame's
    # valid context rows appended
    def heads(x):
        return x.reshape(b * f, h, x.shape[3], dh)

    def expand(x):
        xt = x.permute(0, 1, 3, 2, 4).reshape(b * f, l, h * dh)
        xe = cross_frame_kv(xt, f, idx)
        return xe.reshape(b * f, -1, h, dh).transpose(1, 2).contiguous()

    qh, ke, ve = heads(q), expand(k), expand(v)
    if lc:
        ke = torch.cat([ke, heads(kw["ctx_k"])[:, :, :ctx_valid]], dim=2)
        ve = torch.cat([ve, heads(kw["ctx_v"])[:, :, :ctx_valid]], dim=2)
    library_ms = _time_ms(lambda: F.scaled_dot_product_attention(qh, ke, ve), reps)
    del qh, ke, ve
    case = dict(shape=[b, f, h, lq, l, dh], indices=list(idx), dtype=str(dtype).split(".")[-1],
                ctx=[lc, ctx_valid] if lc else None, max_abs_err=err, err_over_tol=ratio,
                planted_err_over_tol=planted, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                **_bound([b, f, h, lq, l, dh], idx, ctx_valid or 0, dtype))
    print(f"[kernel] {json.dumps(case)}", flush=True)
    return case


def _bound(shape, idx, ctx_valid: int, dtype, tables=None) -> dict:
    """The card's least time for one call: the largest of its tensor FLOPs at
    the peak rate of ``dtype``, its exponentials on the MUFU and the FMA pipe
    together (``_exp_rate``), and its bytes at the memory rate. ``bound_by``
    is ``operations`` when either operation term wins (``bound_unit`` says
    which: ``tensor`` or ``exp``) and ``bytes`` otherwise. The terms, and
    the exponentials' time on the MUFU alone, go on a ``[bound]`` line: they
    are computed from shapes (and a shard form's slot ``tables``), not
    measured."""
    import torch

    from univst_torch.attention.video_flash import work

    w = work(shape, idx, ctx_valid, itemsize=torch.finfo(dtype).bits // 8, tables=tables)
    terms = {"tensor": w.flops / (PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32) * 1e3,
             "exp": w.exps / _exp_rate() * 1e3, "bytes": w.bytes / PEAK_BYTES * 1e3}
    unit = max(terms, key=terms.get)
    print("[bound] " + json.dumps(dict(
        shape=list(shape), indices=list(idx), ctx_valid=ctx_valid, tensor_ms=terms["tensor"],
        exp_ms=terms["exp"], mufu_exp_ms=w.exps / (MUFU_EXP_PER_CLOCK * _sm_clocks()) * 1e3,
        bytes_ms=terms["bytes"])), flush=True)
    return dict(bound_ms=terms[unit], bound_by="bytes" if unit == "bytes" else "operations",
                bound_unit=unit)


def _vfa_tokens_case(b, f, h, lq, l, dh, idx, dtype, lc=None, reps=3, plant=False):
    """K2 against its plain version (and SDPA on the expanded
    ``[img*slots | ctx]`` K/V) on one token-major shape. The context, when
    given, is ``lc`` rows, all valid (the SD3 merged q stream). With
    ``plant``, also run the kernel on k/v rolled by one head along the head
    axis (what an off-by-one head offset would read) and require the same
    check to reject it."""
    import torch
    import torch.nn.functional as F

    from univst_torch.attention.ops import cross_frame_kv_heads
    from univst_torch.attention.video_flash import (
        video_flash_attention_tokens, video_flash_attention_tokens_plain,
    )
    from univst_torch.tools import err_over_tol

    gen = torch.Generator(device="cuda").manual_seed(lq * dh + len(idx))

    def r(*s):
        return torch.randn(s, generator=gen, device="cuda").to(dtype)

    q, k, v = r(b, f, lq, h, dh), r(b, f, l, h, dh), r(b, f, l, h, dh)
    kw = dict(ctx_k=r(b, f, lc, h, dh), ctx_v=r(b, f, lc, h, dh), ctx_valid=lc) if lc else {}
    got = video_flash_attention_tokens(q, k, v, idx, **kw)
    _sync()
    want = video_flash_attention_tokens_plain(q, k, v, idx, **kw)
    _sync()
    err = (got.float() - want.float()).abs().max().item()
    ratio = err_over_tol(got, want)
    if not ratio <= 1.0:
        raise AssertionError(f"video_flash_attention_tokens {tuple(q.shape)} {idx} {dtype}: "
                             f"kernel vs plain at {ratio:.3g}x the tolerance (max abs err {err})")
    planted = None
    if plant:
        wrong = video_flash_attention_tokens(q, torch.roll(k, 1, dims=3),
                                             torch.roll(v, 1, dims=3), idx, **kw)
        planted = err_over_tol(wrong, want)
        if not planted > 1.0:
            raise AssertionError(f"the check passed a kernel fed k/v rolled by one head "
                                 f"({planted:.3g}x the tolerance)")
        print(f"[kernel] planted fault (k/v one head off) rejected at {planted:.3g}x the "
              f"tolerance", flush=True)
        del wrong
    del want
    ms = _time_ms(lambda: video_flash_attention_tokens(q, k, v, idx, **kw), reps)
    plain_ms = _time_ms(lambda: video_flash_attention_tokens_plain(q, k, v, idx, **kw), 1)

    # yardstick: PyTorch's fused attention on the expanded [img*slots | ctx] K/V
    def heads(x):
        return x.reshape(b * f, x.shape[2], h, dh).transpose(1, 2).contiguous()

    qh = heads(q)
    ke, ve = (cross_frame_kv_heads(heads(x), f, idx) for x in (k, v))
    if lc:
        ke = torch.cat([ke, heads(kw["ctx_k"])], dim=2)
        ve = torch.cat([ve, heads(kw["ctx_v"])], dim=2)
    library_ms = _time_ms(lambda: F.scaled_dot_product_attention(qh, ke, ve), reps)
    del qh, ke, ve
    case = dict(shape=[b, f, h, lq, l, dh], indices=list(idx), dtype=str(dtype).split(".")[-1],
                ctx=[lc, lc] if lc else None, max_abs_err=err, err_over_tol=ratio,
                planted_err_over_tol=planted, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                **_bound([b, f, h, lq, l, dh], idx, lc or 0, dtype))
    print(f"[kernel] {json.dumps(case)}", flush=True)
    return case


def phase_kernels():
    import torch

    bf = torch.bfloat16
    cases = [
        _vfa_case(2, 16, 8, 4096, 40, (-1, 0, "first"), bf, plant=True),  # 64x64, base set, B=2
        _vfa_case(2, 16, 8, 4096, 40, (-1, "first"), bf),      # 64x64 level, PnP set, B=2
        _vfa_case(1, 16, 8, 4096, 40, (-1, 0, "first"), bf),   # 64x64 level, inversion
        _vfa_case(1, 16, 8, 1024, 80, (-1, 0, "first"), bf),   # 32x32 level, inversion
        _vfa_case(2, 16, 8, 1024, 80, (-1, "first"), bf),      # 32x32 level, PnP set, B=2
        # SD-2.1: heads of 64 (one MMA atom, no pad), 5 at 64x64, 10 at 32x32
        _vfa_case(2, 16, 5, 4096, 64, (-1, 0, "first"), bf, plant=True),
        _vfa_case(2, 16, 5, 4096, 64, (-1, "first"), bf, plant=True),
        _vfa_case(1, 16, 5, 4096, 64, (-1, 0, "first"), bf, plant=True),
        _vfa_case(1, 16, 10, 1024, 64, (-1, 0, "first"), bf, plant=True),
        _vfa_case(2, 16, 10, 1024, 64, (-1, "first"), bf, plant=True),
        _vfa_case(1, 4, 2, 256, 40, ("first", -1, 0), bf, lq=300, lc=200, ctx_valid=77),
        # ragged: Lq 129, L 200 (not whole 64-key tiles at dh=80), 5 valid ctx rows
        _vfa_case(1, 3, 2, 200, 80, ("first", -1, 0), bf, lq=129, lc=20, ctx_valid=5),
        _vfa_case(1, 4, 2, 256, 64, ("first", -1, 0), torch.float32, lq=200, lc=90,
                  ctx_valid=77),
    ]
    _sync()
    idx = ("first", -1, 0)
    # SD3-medium at 1024 px: 4096 image tokens, 333 context rows (77 + 77 + 256)
    tokens = [
        _vfa_tokens_case(2, 16, 24, 4429, 4096, 64, idx, bf, lc=333, plant=True),  # 2-branch
        _vfa_tokens_case(1, 16, 24, 4429, 4096, 64, idx, bf, lc=333),  # inversion, solo phase
        _vfa_tokens_case(2, 16, 24, 4096, 4096, 64, idx, bf),  # SD3.5-M dual attention
        # SD3.5-large: 38 heads, the 2-branch and the B = 1 forwards
        _vfa_tokens_case(2, 16, 38, 4429, 4096, 64, idx, bf, lc=333, plant=True),
        _vfa_tokens_case(1, 16, 38, 4429, 4096, 64, idx, bf, lc=333, plant=True),
        # SD3.5-large on tensor=4: a rank's 10 or 9 of the 38 heads
        _vfa_tokens_case(1, 16, 10, 4429, 4096, 64, idx, bf, lc=333, plant=True),
        _vfa_tokens_case(1, 16, 9, 4429, 4096, 64, idx, bf, lc=333, plant=True),
        _vfa_tokens_case(1, 3, 2, 333, 200, 64, idx, bf, lc=20),  # ragged Lq, L and ctx
        _vfa_tokens_case(1, 4, 3, 300, 256, 64, idx, torch.float32, lc=77),  # ragged Lq, fp32
    ]
    _sync()
    _dispatch_us()
    return cases, tokens


def _dispatch_us(calls: int = 2000) -> dict:
    """Host microseconds per call, on a tiny K1 shape where the host sets
    the pace: the wrapper (checks, the ``univst::video_flash_attention``
    custom op, launch) against the bare launch it ends in."""
    import torch

    from univst_torch.attention import video_flash as vf

    q = torch.randn(1, 2, 1, 64, 64, device="cuda", dtype=torch.bfloat16)
    idx = ("first", -1)

    def per_call(fn):
        fn()
        _sync()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        _sync()
        return (time.perf_counter() - t) / calls * 1e6

    out = dict(shape=list(q.shape), calls=calls,
               wrapper_us=per_call(lambda: vf.video_flash_attention(q, q, q, idx)),
               launch_us=per_call(lambda: vf._launch("univst_video_flash_attention", q, q, q,
                                                     idx, None, None, None, None, h=1, lq=64,
                                                     l=64, lc=0)))
    print("[dispatch] " + json.dumps(out), flush=True)
    return out


def _zero_counters():
    from univst_torch.attention.video_flash import (
        video_flash_attention, video_flash_attention_tokens,
    )

    counters = {"video_flash_attention": video_flash_attention,
                "video_flash_attention_tokens": video_flash_attention_tokens}
    for fn in counters.values():
        fn.launches = 0
    return counters


def _propagate(feat, mask0, device):
    """Mask propagation on a captured ``[F, h, w, C]`` feature; returns
    ``[F, H, W]`` uint8 {0, 255} masks, frame 0 the input mask."""
    import numpy as np
    import torch

    from univst_torch.methods.mask_propagation import (
        propagate_masks, to_one_hot, upsample_and_binarize,
    )

    nf, fh, fw = feat.shape[:3]
    small = torch.nn.functional.interpolate(
        torch.tensor(mask0, device=device)[None, None].float(), size=(fh, fw),
        mode="nearest")[0, 0]
    seg0 = to_one_hot((small > 0).long(), 2)
    segs = propagate_masks(feat.float().reshape(nf, fh * fw, -1), seg0,
                           generator=torch.Generator(device=device).manual_seed(0))
    rest = upsample_and_binarize(segs, (fh, fw), mask0.shape[:2])
    first = torch.as_tensor(np.where(mask0 > 0, 255, 0).astype(np.uint8), device=device)
    return torch.cat([first[None], rest])


def _check_outputs(tensors, masks, video, nf, px, z0, rec):
    """Finite tensors, {0, 255} masks, non-constant uint8 frames of the
    expected shape; returns the reconstruction latent PSNR (finite)."""
    import numpy as np
    import torch

    for name, x in tensors.items():
        if not torch.isfinite(x.float()).all():
            raise AssertionError(f"{name} has non-finite values")
    vals = set(torch.unique(masks).tolist())
    if not vals <= {0, 255}:
        raise AssertionError(f"masks hold values {sorted(vals)}, want {{0, 255}}")
    if tuple(video.shape) != (nf, px, px, 3) or video.dtype != torch.uint8:
        raise AssertionError(f"frames {tuple(video.shape)} {video.dtype}")
    if not video.float().std().item() > 0:
        raise AssertionError("stylized frames are constant")
    psnr = _latent_psnr(z0, rec)
    if not np.isfinite(psnr):
        raise AssertionError(f"reconstruction latent PSNR {psnr}")
    return psnr


def _latent_psnr(z0, rec) -> float:
    """PSNR of ``rec`` against ``z0`` over ``z0``'s value range, in dB."""
    import numpy as np

    z0 = z0.double()
    mse = ((rec.double() - z0) ** 2).mean().item()
    return 10 * np.log10((z0.max() - z0.min()).item() ** 2 / mse) if mse > 0 else float("inf")


def _check_launches(launches, want):
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, want {want}")


def _load_inputs(num_frames: int, px: int, style_frames: int = 1):
    """The committed demo corpus: 16 content frames, the style image
    (repeated to ``style_frames``), the first-frame mask."""
    import numpy as np
    from PIL import Image

    from univst_torch.utils.io import load_style_image, load_video

    ex = os.path.join(REPO, "examples")
    frames = load_video(os.path.join(ex, "contents", "demo-fly"), num_frames, (px, px))
    style = load_style_image(os.path.join(ex, "styles", "00033.png"), style_frames, (px, px))
    mask0 = np.asarray(Image.open(os.path.join(ex, "masks", "demo-fly.png"))
                       .resize((px, px), Image.NEAREST))
    return frames, style, mask0


def _workflow(pipe, backbone: str, steps: int, nf: int, px: int, tag: str) -> dict:
    """The workflow as a user drives it, on the committed demo corpus:
    encode, content inversion with EasyInv and the up-block-2 feature
    captured, style inversion (SD: one frame; AnimateDiff: all ``nf``),
    mask propagation, stylization (SD: from the AdaIN-shifted content
    noise, the singleton style; AnimateDiff: from the raw content noise),
    the chunked temporal-VAE decode (8 frames a chunk) and the inversion ->
    reconstruction round trip. Each stage's seconds (host clock around work
    that ends in a synchronise) and, under a mesh, its collectives
    (``distributed.census``) are kept."""
    import torch

    from univst_torch.distributed.census import collect_collectives, summarize

    device = pipe.device
    frames, style, mask0 = _load_inputs(nf, px, style_frames=1 if backbone == "sd" else nf)
    ts = pipe.schedule.timesteps(steps)
    cap_t = 301 if 301 in ts else int(ts[len(ts) // 2])
    gen = torch.Generator(device=device).manual_seed(0)
    stage, census = {}, {}

    def run(name, fn):
        t = time.time()
        with collect_collectives() as recs:
            out = fn()
            _sync()
        stage[name] = time.time() - t
        census[name] = summarize(recs, by_site=True)
        print(f"[{tag}] {name}: {stage[name]:.2f}s", flush=True)
        return out

    t_main = time.time()
    latents, ctx = run("encode", lambda: (pipe.encode_frames(frames, gen), pipe.encode_text("")))
    traj, feat = run("content_inversion", lambda: pipe.invert(
        latents, ctx, num_steps=steps, is_opt=True, capture_timestep=cap_t))
    # SD: one frame (every frame of the repeated style image evolves alike);
    # AnimateDiff: all frames (the motion modules tell them apart)
    spipe = _style_pipe(pipe, backbone)

    def style_inversion():
        slat = spipe.encode_frames(style, gen)
        return slat, spipe.invert(slat, ctx, num_steps=steps, is_opt=False)[0]

    slatents, straj = run("style_inversion", style_inversion)
    masks = run("mask_propagation", lambda: _propagate(feat, mask0, device))
    out = run("stylize", lambda: _stylize(pipe, backbone, traj, straj, ctx, masks, steps))
    chunks = run("decode", lambda: pipe.decode_latents_uint8_chunks(out, 8))
    rec = run("reconstruction", lambda: pipe.reconstruct_latents(traj[-1], ctx, num_steps=steps))
    return dict(latents=latents, slatents=slatents, ctx=ctx, traj=traj, feat=feat, straj=straj,
                masks=masks, out=out, video=torch.cat(chunks), rec=rec, stage=stage,
                census=census, main_s=time.time() - t_main)


def _style_pipe(pipe, backbone: str):
    return pipe.with_frames(1) if backbone == "sd" else pipe


def _stylize(pipe, backbone: str, traj, straj, ctx, masks, steps: int, **smoother):
    """The workflow's stylization: SD from the AdaIN-shifted content noise
    and the singleton style; AnimateDiff (its runner) from the raw content
    noise and every style frame. ``smoother``: ``StyleTransferConfig``'s
    smoother fields (``MESH_SMOOTH``)."""
    import torch

    from univst_torch.core.adain import latent_adain
    from univst_torch.core.config import StyleTransferConfig

    content_rev = torch.flip(traj, dims=[0])
    style_rev = torch.flip(straj, dims=[0])
    if backbone == "sd":
        style_rev = style_rev[:, :1]
        init = latent_adain(content_rev[0], style_rev[0])
    else:
        init = content_rev[0]
    return pipe.stylize_latents(content_rev, style_rev, init, torch.cat([ctx] * 3),
                                mask=masks.float() / 255.0,
                                cfg=StyleTransferConfig(num_steps=steps, **smoother))


def _decode_float(pipe, out, chunk: int = 8):
    """The workflow's chunked decode in [0, 1], before its uint8 rounding."""
    import torch

    if chunk >= out.shape[0]:
        return pipe.decode_latents(out)
    return torch.cat([pipe._decode(out[s:s + chunk], chunk)
                      for s in range(0, out.shape[0], chunk)])


def phase_main_path(steps: int, variant: str = "sd15", tag: str = "main"):
    """SD-1.5 (``variant='sd21'``: SD-2.1) at 512 px, 16 frames, bf16, on
    the card; the peak memory is the path's own, from its build on."""
    import torch

    from univst_torch.pipelines.sd import SDVideoPipeline

    nf, px, device = 16, 512, "cuda"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    pipe = SDVideoPipeline.build(variant=variant, num_frames=nf, dtype=torch.bfloat16,
                                 capture_up_block=2, seed=0, device=device)
    _sync()
    print(f"[{tag}] built {variant} (random weights, seed 0) in {time.time() - t0:.1f}s",
          flush=True)

    counters = _zero_counters()
    w = _workflow(pipe, "sd", steps, nf, px, tag)
    launches = {name: fn.launches for name, fn in counters.items()}

    traj, straj, masks, out, rec, stage = (w[k] for k in ("traj", "straj", "masks", "out", "rec",
                                                          "stage"))
    psnr = _check_outputs({"trajectory": traj, "feature": w["feat"], "style trajectory": straj,
                           "stylized latents": out, "reconstruction": rec},
                          masks, w["video"], nf, px, traj[0], rec)
    # one 16-frame UNet forward per step of the content inversion, the
    # reconstruction and the stylization (the style branch runs single-frame),
    # each with the sparse-causal attentions at L >= 1024: 5 at 64x64, 5 at 32x32
    _check_launches(launches, {"video_flash_attention": 10 * 3 * steps,
                               "video_flash_attention_tokens": 0})
    summary = dict(variant=variant, steps=steps, frames=nf, size=px, stage_s=stage,
                   main_path_s=w["main_s"], workflow_frames_per_s=nf / w["main_s"],
                   stylize_frames_per_s=nf / (stage["stylize"] + stage["decode"]),
                   recon_latent_psnr_db=psnr, launches=launches,
                   masks_foreground=float((masks > 0).float().mean().item()),
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"[{tag}] {json.dumps(summary)}", flush=True)
    return (launches, (pipe, traj, straj, w["ctx"], masks, out),
            dict(stage=stage, psnr=psnr, video=w["video"]))


def _finite_numbers(tree, path="") -> list:
    """The paths of the numbers in a JSON tree that are missing or not
    finite (None counts as missing)."""
    import math

    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _finite_numbers(v, f"{path}.{k}")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in _finite_numbers(v, f"{path}[{i}]")]
    if tree is None or (isinstance(tree, float) and not math.isfinite(tree)):
        return [path]
    return []


def phase_bench(sd_state, main: dict, steps: int):
    """The headline bench's own code (``univst_torch.bench``) on ``[main]``'s
    run: its stylize + decode and content-inversion seconds (first calls,
    so cold) and its round trip's latent PSNR, with one more stylization of
    its inputs under the FLOP counter, the one run this phase adds. Gated:
    every key present and finite, 0 < MFU <= 1.05, K1 10 launches a step of
    the counted stylization and K2 none."""
    from univst_torch import bench

    pipe, traj, straj, ctx, masks, _ = sd_state
    stage = main["stage"]
    counters = _zero_counters()
    info = bench.device_info(pipe.device)
    m = bench.summarize(lambda: _stylize(pipe, "sd", traj, straj, ctx, masks, steps),
                        pipe.num_frames, steps, [stage["stylize"] + stage["decode"]],
                        stage["content_inversion"], main["psnr"],
                        bench.peak_tflops(info["name"]), pipe.device)
    launches = {name: fn.launches for name, fn in counters.items()}
    line = bench.headline(m, steps, 512, info, on_card=True)
    print("[bench] " + json.dumps(line), flush=True)
    missing = _finite_numbers(line)
    if missing:
        raise AssertionError(f"bench: missing or non-finite {missing}")
    if not 0 < line["extra"]["mfu"] <= 1.05:
        raise AssertionError(f"bench: MFU {line['extra']['mfu']}")
    if (m["k1_launches"], m["k2_launches"]) != (10 * steps, 0):
        raise AssertionError(f"bench: K1 / K2 launches a stylization {m['k1_launches']} / "
                             f"{m['k2_launches']}, want {10 * steps} / 0")
    _check_launches(launches, {"video_flash_attention": 10 * steps,
                               "video_flash_attention_tokens": 0})
    return launches


def phase_sd_fallback(sd_state, steps: int):
    """The SD pipeline off the style-singleton path, on the card: the main
    path's pipeline and content trajectory, which serves as the style (its
    frames differ)."""
    import torch

    from univst_torch.core.adain import latent_adain
    from univst_torch.core.config import StyleTransferConfig

    pipe, traj, _, ctx, masks, _ = sd_state
    pipe = dataclasses.replace(pipe, style_singleton=False)
    content_rev = torch.flip(traj, dims=[0])
    counters = _zero_counters()
    t0 = time.time()
    out = pipe.stylize_latents(content_rev, content_rev,
                               latent_adain(content_rev[0], content_rev[0]),
                               torch.cat([ctx] * 3), mask=masks.float() / 255.0,
                               cfg=StyleTransferConfig(num_steps=steps))
    _sync()
    stylize_s = time.time() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    if not torch.isfinite(out).all():
        raise AssertionError("fallback stylized latents have non-finite values")
    # phase 1: a 16-frame capture forward and the 2-branch forward a step;
    # phase 2: one forward; 10 K1 launches each (5 at 64x64, 5 at 32x32)
    k1 = min(steps, pipe.style_shift_cfg.window_end())
    _check_launches(launches, {"video_flash_attention": 10 * (2 * k1 + (steps - k1)),
                               "video_flash_attention_tokens": 0})
    print("[sd_fallback] " + json.dumps(dict(
        steps=steps, frames=pipe.num_frames, phase1_steps=k1, stage_s={"stylize": stylize_s},
        stylize_frames_per_s=pipe.num_frames / stylize_s, launches=launches)), flush=True)
    return launches


def phase_lk_shift(device: str = "cuda"):
    """The built-in Lucas-Kanade flow on the card recovers a known shift: a
    smooth 512x512 image against itself rolled by 2 px along x (the
    interior's mean x flow within 0.5 px of -2, the bar of
    ``tests/test_flow.py``), and the warp by that flow closes the loop."""
    import torch

    from univst_torch.methods.flow import lucas_kanade_flow, warp_image_with_flow

    px, shift = 512, 2
    gen = torch.Generator(device=device).manual_seed(0)
    small = torch.randn((1, 3, px // 8, px // 8), generator=gen, device=device)
    img = torch.nn.functional.interpolate(small, size=(px, px), mode="bicubic",
                                          align_corners=False)[0].permute(1, 2, 0)
    img = (img - img.min()) / (img.max() - img.min())
    img2 = torch.roll(img, -shift, dims=1)  # img2(x) = img(x + shift)
    flow = lucas_kanade_flow(img, img2)
    _sync()
    mean_dx = flow[128:-128, 128:-128, 0].mean().item()
    mean_dy = flow[128:-128, 128:-128, 1].mean().item()
    loop = (warp_image_with_flow(img2, flow) - img)[16:-16, 16:-16].abs().mean().item()
    print("[lk] " + json.dumps(dict(size=px, shift_px=shift, interior_mean_flow=[mean_dx, mean_dy],
                                    warp_loop_mean_abs=loop)), flush=True)
    if not (abs(mean_dx + shift) < 0.5 and abs(mean_dy) < 0.5 and loop < 0.03):
        raise AssertionError(f"LK on the card: mean flow ({mean_dx}, {mean_dy}) for a shift of "
                             f"(-{shift}, 0), warp loop error {loop}")


def _timed(fn, acc: dict, key: str):
    """``fn`` with its synchronised wall time added to ``acc[key]``."""
    def wrapper(*a, **kw):
        _sync()
        t = time.time()
        out = fn(*a, **kw)
        _sync()
        acc[key] = acc.get(key, 0.0) + time.time() - t
        return out
    return wrapper


def phase_smooth(sd_state, steps: int):
    """The pixel smoother on the card: the SD phase's pipeline, content and
    style trajectories and propagated masks, stylized with
    ``smoother='pixel'``, LK flow, smoothing steps [20, 25), radius 2. Phase
    1 (the style pre-pass, then the injected 2-branch step) runs up to
    max(the shift window's end, 25); each smoothing step decodes x0 (16
    frames), runs 2 x 58 LK flows in one batch, warp-averages and
    re-encodes. The split
    of the stylization's seconds comes from synchronised wrappers around
    the UNet forward, the decode, the flow, the smoother and the encode.
    Returns the K1/K2 launches and the frames of the first smoothing step
    (for the RAFT phase)."""
    import torch

    import univst_torch.methods.flow as flow_mod
    from univst_torch.core.adain import latent_adain
    from univst_torch.core.config import StyleTransferConfig

    pipe, traj, straj, ctx, masks, plain_out = sd_state
    acc, first = {}, {}
    pipe = dataclasses.replace(pipe, flow_fn=_timed(flow_mod.lucas_kanade_flow, acc, "flow"))
    pipe._decode_local = _timed(pipe._decode_local, acc, "decode")
    vae, unet = pipe.vae, pipe.unet
    vae.encode = _timed(vae.encode, acc, "encode")
    smooth_fn = flow_mod.sliding_window_smooth

    def smooth(frames, *a, **kw):
        first.setdefault("frames", frames.detach().clone())
        return smooth_fn(frames, *a, **kw)

    flow_mod.sliding_window_smooth = _timed(smooth, acc, "smooth")

    def pre(_, args):
        _sync()
        acc["_t"] = time.time()

    def post(_, args, out):
        _sync()
        rows = args[0].shape[0]
        key = {2 * pipe.num_frames: "forward_2branch",
               pipe.num_frames: "forward_solo"}.get(rows, "style_prepass")
        acc[key] = acc.get(key, 0.0) + time.time() - acc.pop("_t")
        acc["n_" + key] = acc.get("n_" + key, 0) + 1

    hooks = [unet.register_forward_pre_hook(pre), unet.register_forward_hook(post)]
    cfg = StyleTransferConfig(num_steps=steps, smoother="pixel", smoother_steps=(20, 25),
                              smoother_radius=2)
    content_rev = torch.flip(traj, dims=[0])
    style_rev = torch.flip(straj, dims=[0])[:, :1]
    try:
        counters = _zero_counters()
        t0 = time.time()
        init = latent_adain(content_rev[0], style_rev[0])
        out = pipe.stylize_latents(content_rev, style_rev, init, torch.cat([ctx] * 3),
                                   mask=masks.float() / 255.0, cfg=cfg)
        _sync()
        stylize_s = time.time() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
    finally:
        for h in hooks:
            h.remove()
        del vae.encode
        flow_mod.sliding_window_smooth = smooth_fn
    if not torch.isfinite(out).all():
        raise AssertionError("smoothed stylized latents have non-finite values")
    diff = (out - plain_out).abs().max().item()
    if not diff > 1e-2:
        raise AssertionError(f"the smoother left the stylization unchanged (max diff {diff})")
    # one 16-frame forward a step (2-branch in phase 1, stylized-only after),
    # 10 K1 each; the single-frame style pre-pass runs no video attention
    k1 = min(steps, max(pipe.style_shift_cfg.window_end(), cfg.smoother_steps[1]))
    n_smooth = len(range(*cfg.smoother_steps))
    _check_launches(launches, {"video_flash_attention": 10 * steps,
                               "video_flash_attention_tokens": 0})
    got = tuple(acc.get("n_" + k, 0) for k in ("style_prepass", "forward_2branch",
                                               "forward_solo"))
    if got != (1, k1, steps - k1):
        raise AssertionError(f"forwards {acc}, want 1 pre-pass, {k1} 2-branch and "
                             f"{steps - k1} solo")
    split = {k: acc.get(k, 0.0) for k in ("style_prepass", "forward_2branch", "forward_solo",
                                          "decode", "flow", "encode")}
    split["warp_average"] = acc["smooth"] - acc["flow"]
    split["other"] = stylize_s - sum(split.values())
    print("[smooth] " + json.dumps(dict(
        steps=steps, frames=pipe.num_frames, phase1_steps=k1, smoothing_steps=n_smooth,
        radius=cfg.smoother_radius, flow="lk", flows_per_smoothing_step=2 * _window_pairs(
            pipe.num_frames, cfg.smoother_radius), stylize_s=stylize_s, split_s=split,
        stylize_frames_per_s=pipe.num_frames / stylize_s, max_abs_diff_vs_unsmoothed=diff,
        launches=launches, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)), flush=True)
    return launches, first["frames"]


def _window_pairs(f: int, radius: int) -> int:
    """Directed (key, neighbor) frame pairs of a +/-radius window over f frames."""
    return sum(1 for k in range(f) for b in range(-radius, radius + 1) if b and 0 <= k + b < f)


def phase_raft(frames, radius: int = 2):
    """RAFT-large (``RAFTConfig()``: 12 iterations, 4 correlation levels of
    radius 4; fp32, TF32 off, weights from seed 0) on the flows of one
    smoothing step: the decoded 16 frames of 512 px, every directed pair of
    a +/-radius window in both directions (2 x 58 = 116 flows), in one
    batched call as ``sliding_window_smooth`` makes it, and one pair alone.
    Every flow must be finite; one pair's flow on the card is held against
    the same module on the CPU."""
    import torch

    from univst_torch.models.raft import RAFT, RAFTConfig, make_raft_flow

    torch.manual_seed(0)
    cpu_model = RAFT(RAFTConfig()).eval()
    model = RAFT(RAFTConfig()).eval().to(frames.device)
    model.load_state_dict(cpu_model.state_dict())
    flow_fn = make_raft_flow(model)
    f = frames.shape[0]
    pairs = [(k, k + b) for b in range(-radius, radius + 1) if b for k in range(f)
             if 0 <= k + b < f]
    keys = torch.tensor([k for k, _ in pairs], device=frames.device)
    nows = torch.tensor([j for _, j in pairs], device=frames.device)
    a = torch.cat([frames[keys], frames[nows]])
    b = torch.cat([frames[nows], frames[keys]])
    torch.cuda.reset_peak_memory_stats()
    flows = flow_fn(a, b)
    _sync()
    batch_ms = _time_ms(lambda: flow_fn(a, b), 1)
    peak_batch = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    one_ms = _time_ms(lambda: flow_fn(a[:1], b[:1]), 3)
    peak_one = torch.cuda.max_memory_allocated() / 1e9
    if not torch.isfinite(flows).all():
        raise AssertionError("RAFT flows have non-finite values")
    want = make_raft_flow(cpu_model)(a[:1].cpu(), b[:1].cpu())
    err = (flows[:1].cpu() - want).abs().max().item()
    scale = max(1.0, want.abs().max().item())
    print("[raft] " + json.dumps(dict(
        size=list(frames.shape[1:3]), pairs=len(pairs), flows=len(a), iters=model.cfg.iters,
        batch_ms=batch_ms, ms_per_flow_in_batch=batch_ms / len(a), ms_one_pair=one_ms,
        peak_mem_gb_batch=peak_batch, peak_mem_gb_one_pair=peak_one,
        max_abs_flow=flows.abs().max().item(), card_vs_cpu_max_abs_err=err,
        card_vs_cpu_bar=1e-2 * scale)), flush=True)
    if not err <= 1e-2 * scale:
        raise AssertionError(f"RAFT on the card vs the CPU: max abs err {err} px")


def _round_trip_psnr(pipe, z0, ctx, steps: int) -> float:
    """DDIM inversion (EasyInv) of ``z0`` and the reconstruction back: the
    latent PSNR."""
    traj, _ = pipe.invert(z0, ctx, num_steps=steps, is_opt=True)
    return _latent_psnr(traj[0], pipe.reconstruct_latents(traj[-1], ctx, num_steps=steps))


def phase_sd_linear_betas(sd_state, steps: int):
    """The SD path's inversion -> reconstruction round trip once more with
    AnimateDiff's linear beta schedule in place of SD's scaled-linear one
    (same pipeline, encoded latents and prompt): how much of the AD path's
    lower PSNR the schedule alone accounts for."""
    from univst_torch.core.scheduler import DDIMConfig, DDIMSchedule

    pipe, traj, _, ctx, _, _ = sd_state
    t0 = time.time()
    linear = dataclasses.replace(pipe, schedule=DDIMSchedule(DDIMConfig(beta_schedule="linear")))
    psnr = _round_trip_psnr(linear, traj[0], ctx, steps)
    _sync()
    print("[sd_linear_betas] " + json.dumps(dict(
        steps=steps, recon_latent_psnr_db=psnr, **_latent_stats(traj[0]),
        seconds=time.time() - t0)), flush=True)


def _latent_stats(z0) -> dict:
    """The value range and std of a start latent (the PSNR's scale)."""
    z = z0.double()
    return dict(z0_range=(z.max() - z.min()).item(), z0_std=z.std().item())


def _fill_motion_proj_out(unet, seed: int) -> int:
    """Every motion module's ``proj_out`` (zero at init) from a generator
    seeded with ``seed``, at the random init's lecun scale; returns the
    module count."""
    import torch

    mods = unet.motion_modules()
    gen = torch.Generator(device=mods[0].temporal_transformer.proj_out.weight.device)
    gen.manual_seed(seed)
    with torch.no_grad():
        for mm in mods:
            w = mm.temporal_transformer.proj_out.weight
            w.copy_(torch.randn(w.shape, generator=gen, device=w.device) / w.shape[1] ** 0.5)
    return len(mods)


def _build_ad(dtype, seed_proj_out: int = 1):
    """AnimateDiff-v2 at full width (seed 0), every motion module's
    ``proj_out`` filled from ``seed_proj_out``; returns (pipe, modules)."""
    from univst_torch.pipelines.animatediff import build_animatediff

    pipe = build_animatediff(variant="ad", num_frames=16, dtype=dtype, capture_up_block=2,
                             seed=0, device="cuda")
    return pipe, _fill_motion_proj_out(pipe.unet, seed=seed_proj_out)


def phase_ad(steps: int):
    """AnimateDiff-v2 at 512 px, 16 frames, bf16, on the card."""
    import torch

    nf, px = 16, 512
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    pipe, n_mm = _build_ad(torch.bfloat16)
    _sync()
    build_s = time.time() - t0
    w_max = max(mm.temporal_transformer.proj_out.weight.abs().max().item()
                for mm in pipe.unet.motion_modules())
    print(f"[ad] built AnimateDiff-v2 (SD-1.5 2D UNet + {n_mm} motion modules, SVD VAE, "
          f"CLIP-L; random weights, seed 0) in {build_s:.1f}s; proj_out of all "
          f"{n_mm} motion modules filled from seed 1 (max |w| {w_max:.4g})", flush=True)

    counters = _zero_counters()
    w = _workflow(pipe, "ad", steps, nf, px, "ad")
    launches = {name: fn.launches for name, fn in counters.items()}

    traj, masks, rec, stage = w["traj"], w["masks"], w["rec"], w["stage"]
    psnr = _check_outputs({"trajectory": traj, "feature": w["feat"],
                           "style trajectory": w["straj"], "stylized latents": w["out"],
                           "reconstruction": rec}, masks, w["video"], nf, px, traj[0], rec)
    _check_launches(launches, {"video_flash_attention": 0, "video_flash_attention_tokens": 0})
    summary = dict(steps=steps, frames=nf, size=px, stage_s=stage, main_path_s=w["main_s"],
                   workflow_frames_per_s=nf / w["main_s"],
                   stylize_frames_per_s=nf / (stage["stylize"] + stage["decode"]),
                   recon_latent_psnr_db=psnr, launches=launches,
                   masks_foreground=float((masks > 0).float().mean().item()),
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"[ad] {json.dumps(summary)}", flush=True)
    _ad_psnr_ladder(pipe, w["latents"], w["ctx"], AD_PSNR_STEPS)
    return launches


# [ad_psnr]'s round trips: cut from the AD path's 30 steps (six round trips,
# ~57 s on the card) to keep the script within its time limit once [sd21]
# and [mesh_sd3 tp] joined it; the ladder compares its rungs at equal steps
AD_PSNR_STEPS = 10


def _ad_psnr_ladder(pipe, z0, ctx, steps: int):
    """Where the AD round trip's PSNR departs from the SD path's: with
    every motion module's ``proj_out`` back at zero, the AD UNet is the
    SD-1.5 UNet with per-frame GroupNorm and no cross-frame attention
    (equal on the CPU to the last bit). The inversion -> reconstruction
    round trip of the same start latent and prompt, with AD's linear betas
    and in bf16, through: (a) the AD UNet (and in fp32); (b) the SD UNet
    holding AD's 2D weights, per-frame GroupNorm, no cross-frame K/V (the
    one-call eps gap to (a) stated); (c) its GroupNorms spanning the
    frames, as the SD UNet's resnets have them; (d) plus the sparse-causal
    frame set of the SD path; (e) the SD UNet with its own draw (seed 0,
    the SD phase's weights)."""
    import torch

    from univst_torch.core.config import SD_BASE_FRAME_INDICES
    from univst_torch.models.layers import GroupNorm, VideoCtx
    from univst_torch.models.unet_sd import UNetPseudo3D, UNetSDConfig
    from univst_torch.pipelines.sd import random_init_

    t0 = time.time()
    with torch.no_grad():
        for mm in pipe.unet.motion_modules():
            mm.temporal_transformer.proj_out.weight.zero_()
    psnr = {"a_ad_unet": _round_trip_psnr(pipe, z0, ctx, steps)}
    pipe.unet.float()
    psnr["a_ad_unet_fp32"] = _round_trip_psnr(dataclasses.replace(pipe, dtype=torch.float32), z0,
                                              ctx.float(), steps)
    pipe.unet.to(torch.bfloat16)
    # the SD UNet at the AD UNet's 2D widths (SD-1.5's for ``ad_v2``)
    acfg = pipe.unet.cfg
    scfg = UNetSDConfig(**{f.name: getattr(acfg, f.name) for f in dataclasses.fields(UNetSDConfig)
                           if hasattr(acfg, f.name) and f.name != "capture_up_block"})
    with torch.device(pipe.device):
        sd_unet = UNetPseudo3D(scfg)
    random_init_(sd_unet, torch.Generator(device=pipe.device).manual_seed(0))
    sd_unet.to(torch.bfloat16).eval().requires_grad_(False)
    sd_pipe = dataclasses.replace(pipe, unet=sd_unet)
    psnr["e_sd_unet_own_weights"] = _round_trip_psnr(
        dataclasses.replace(sd_pipe, base_frame_indices=SD_BASE_FRAME_INDICES), z0, ctx, steps)
    ad_sd = pipe.unet.state_dict()
    sd_unet.load_state_dict({k: ad_sd[k] for k in sd_unet.state_dict()}, strict=True)
    psnr["d_sd_unet_video_gn_sparse_causal"] = _round_trip_psnr(
        dataclasses.replace(sd_pipe, base_frame_indices=SD_BASE_FRAME_INDICES), z0, ctx, steps)
    psnr["c_sd_unet_video_gn"] = _round_trip_psnr(sd_pipe, z0, ctx, steps)
    gns = [m for m in sd_unet.modules() if isinstance(m, GroupNorm) and m.across_frames]
    for m in gns:
        m.across_frames = False
    psnr["b_sd_unet_frame_gn"] = _round_trip_psnr(sd_pipe, z0, ctx, steps)
    vctx = VideoCtx(num_frames=pipe.num_frames, frame_indices=())
    t = int(pipe.schedule.timesteps(steps)[0])
    with torch.inference_mode():
        e_ad = pipe.unet(z0.to(torch.bfloat16), t, ctx, vctx)[0].float()
        e_sd = sd_unet(z0.to(torch.bfloat16), t, ctx, vctx)[0].float()
    _sync()
    print("[ad_psnr] " + json.dumps(dict(
        steps=steps, recon_latent_psnr_db=psnr, video_gn_layers=len(gns),
        eps_b_vs_a_max_abs=(e_sd - e_ad).abs().max().item(), eps_a_max_abs=e_ad.abs().max().item(),
        **_latent_stats(z0), seconds=time.time() - t0)), flush=True)
    del sd_unet, sd_pipe


SD3_VARIANTS = {  # tag: (pipeline variant, what is built)
    "sd3": ("sd3", "sd3-medium"),
    "sd35m": ("sd35m", "sd3.5-medium"),
    "sd35l": ("sd35", "sd3.5-large"),
}
# SD3.5-medium's steps: the 2-branch stylization phase only (32 run both
# phases, +118 s on the card, which the script's time limit does not hold;
# SD3-medium runs the stylized-only phase at the same widths)
SD35M_STEPS = 4


def phase_sd3(tag: str, steps: int, nf: int = 16, px: int = 1024):
    """One SD3-family model (``SD3_VARIANTS[tag]``) at full width, ``px`` px,
    ``nf`` frames, bf16, on the card, through ``_workflow_sd3``; returns the
    K2 / K1 launches and, for the profile, ``(pipe, the content
    trajectory's middle latents, ctx, pooled)``."""
    import torch

    variant, label = SD3_VARIANTS[tag]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    pipe = _build_sd3_pipe(variant, "bf16", nf)
    _sync()
    mcfg = pipe.mmdit.cfg
    print(f"[{tag}] built {label} ({mcfg.num_layers} blocks, {mcfg.num_heads} heads of "
          f"{mcfg.head_dim}, {len(mcfg.dual_attention_layers)} dual-attention blocks) + T5-XXL "
          f"+ CLIP-L/G (random weights, seed 0) in {time.time() - t0:.1f}s; "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    counters = _zero_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    prompt = _sd3_prompt(pipe)
    _sync()
    stage = {"encode_prompt": time.time() - t0}
    peak = {"encode_prompt": torch.cuda.max_memory_allocated() / 1e9}
    print(f"[{tag}] encode_prompt: {stage['encode_prompt']:.2f}s, "
          f"peak {peak['encode_prompt']:.2f} GB", flush=True)
    w = _workflow_sd3(pipe, steps, nf, px, tag, prompt)
    launches = {name: fn.launches for name, fn in counters.items()}
    stage.update(w["stage"])
    peak.update(w["peak"])
    main_s = stage["encode_prompt"] + w["main_s"]

    traj, masks, rec = w["traj"], w["masks"], w["rec"]
    p = mcfg.patch_size
    lat = w["latents"]
    if tuple(w["feat"].shape) != (nf, lat.shape[1] // p, lat.shape[2] // p, mcfg.hidden):
        raise AssertionError(f"captured feature {tuple(w['feat'].shape)}")
    psnr = _check_outputs({"context": w["ctx"], "pooled": w["pooled"], "trajectory": traj,
                           "feature": w["feat"], "style trajectory": w["straj"],
                           "stylized latents": w["out"], "reconstruction": rec},
                          masks, w["video"], nf, px, traj[0], rec)
    # one K2 launch per joint and per dual attention of each of the step's
    # four video forwards (two RF-Solver forwards, one reconstruction
    # forward, one 2x16- or 16-frame stylization forward)
    per_forward = mcfg.num_layers + len(mcfg.dual_attention_layers)
    _check_launches(launches, {"video_flash_attention": 0,
                               "video_flash_attention_tokens": per_forward * 4 * steps})
    summary = dict(model=label, blocks=mcfg.num_layers, heads=mcfg.num_heads,
                   dual_attention_blocks=len(mcfg.dual_attention_layers), steps=steps,
                   frames=nf, size=px, stage_s=stage, main_path_s=main_s,
                   workflow_frames_per_s=nf / main_s,
                   stylize_frames_per_s=nf / (stage["stylize"] + stage["decode"]),
                   recon_latent_psnr_db=psnr, launches=launches,
                   k2_launches_per_forward=per_forward,
                   masks_foreground=float((masks > 0).float().mean().item()),
                   peak_mem_gb_by_stage=peak, peak_mem_gb=max(peak.values()))
    print(f"[{tag}] {json.dumps(summary)}", flush=True)
    return launches, (pipe, traj[steps // 2], w["ctx"], w["pooled"])


def _profile_forward(name: str, model, fn, want_launches: dict) -> dict:
    """One forward ``fn`` of ``model``: its time over two untraced calls
    after a warm-up (CUDA events), one ``torch.profiler`` trace split by
    kind of kernel (the norms' kernels found by annotating ``model``'s norm
    modules) with the launches in it checked against ``want_launches``, and
    its matmul / conv / attention FLOPs from one more call under the
    counter. Returns the launches in the trace. The trace's own host cost
    stretches its span, so the idle share is also given against the
    untraced time (``idle_share_untraced``: 1 - busy / forward_ms)."""
    import torch

    from univst_torch.utils.flops import count_matmul_flops
    from univst_torch.utils.profiling import annotate_norms, device_time_split, device_trace

    with torch.inference_mode():
        ms = _time_ms(fn, 2)
        counters = _zero_counters()
        with annotate_norms(model), device_trace(
                os.path.join(REPO, "results", "profile", name)) as prof:
            fn()
        launches = {k: f.launches for k, f in counters.items()}
        flops = count_matmul_flops(fn)
        _sync()
    split = device_time_split(prof)
    if not split["device_time_seen"]:
        raise AssertionError(f"profile {name}: {split['note']}")
    _check_launches(launches, want_launches)
    print("[profile] " + json.dumps(dict(
        forward=name, forward_ms=ms, launches_in_trace=launches, flops=flops,
        effective_tflops=flops / ms / 1e9, mfu=flops / (ms * 1e-3) / PEAK_BF16,
        idle_share_untraced=1.0 - split["busy_ms"] / ms, **split)), flush=True)
    return launches


def phase_profile_sd(sd_state, steps: int) -> dict:
    """The SD-1.5 forwards of the profile: 16 frames at 512 px, B = 1 (the
    inversion's and reconstruction's forward, 10 K1 launches) and the
    injected 2-branch stylization forward (B = 2, the style branch's K/V
    captured by a single-frame forward beforehand; 10 K1 launches)."""
    import torch

    from univst_torch.core.config import SD_BASE_FRAME_INDICES
    from univst_torch.models.layers import StyleCtx, VideoCtx
    from univst_torch.models.unet_sd import extract_pnp_kv

    pipe, traj, straj, ctx, _, _ = sd_state
    i = steps // 2
    t = int(pipe.schedule.timesteps(steps)[i])
    z = traj[i]
    one = pipe._denoise_fn(ctx, SD_BASE_FRAME_INDICES, None)
    with torch.inference_mode():
        cap = StyleCtx(step_idx=0, cfg=pipe.style_shift_cfg, capture=True)
        pipe.unet(straj[i, :1].to(pipe.dtype), t, ctx, VideoCtx(num_frames=1, frame_indices=()),
                  cap)
        kv = extract_pnp_kv(cap.captured)
    two = pipe._denoise_fn(torch.cat([ctx, ctx]), pipe.pnp_frame_indices, pipe.style_shift_cfg)
    z2 = torch.cat([z, z])
    k1 = {"video_flash_attention": 10, "video_flash_attention_tokens": 0}
    got = [_profile_forward("sd15_b1", pipe.unet, lambda: one(z, t, i), k1),
           _profile_forward("sd15_b2", pipe.unet, lambda: two(z2, t, 5, style_kv=kv), k1)]
    return {k: sum(g[k] for g in got) for k in k1}


def phase_profile_sd35m(state) -> dict:
    """The SD3.5-medium forward of the profile: 16 frames at 1024 px, B = 1
    (37 K2 launches: 24 joint attentions with context, 13 dual without)."""
    pipe, z, ctx, pooled = state
    cfg = pipe.mmdit.cfg
    ts = pipe.schedule.timesteps(SD35M_STEPS, mu=pipe._mu(*z.shape[1:3]))
    t = float(ts[SD35M_STEPS // 2])  # the step of z = traj[SD35M_STEPS // 2]
    one = pipe._denoise_fn(ctx, pooled, None)
    return _profile_forward("sd35m_b1", pipe.mmdit, lambda: one(z, t, 0), {
        "video_flash_attention": 0,
        "video_flash_attention_tokens": cfg.num_layers + len(cfg.dual_attention_layers)})


# ---------------------------------------------------------------------------
# [stages], [anatomy], [sd3_anatomy], [compare], [recipe]: the tools
# ---------------------------------------------------------------------------

# --reps of the tools' rows in this script (the tools default to 2 and 3) and
# the SD3 segments' steps (default 2): cut to keep the script within its limit
TOOL_REPS = 1
SD3_SEGMENT_STEPS = 1


def _bad_rows(rows: dict) -> list:
    """The rows that are not finite and positive."""
    import math

    return [k for k, v in rows.items() if not (isinstance(v, float) and math.isfinite(v)
                                               and v > 0)]


def phase_stages(sd_state) -> dict:
    """``univst_torch.tools.bench_stages`` on ``[main]``'s pipeline: the bench
    workload (50 steps, 512 px, 16 frames, synthetic trajectories from seed
    0) cut into its stages, each warm; dispatch marks; each stage's device
    split. Gated: every row finite and positive, the closure within 0.85 -
    1.15 of the full run, K1 500 launches a run (10 a forward, 50 steps) and
    K2 none, device time in every split."""
    from univst_torch.tools import bench_stages

    counters = _zero_counters()
    m = bench_stages.measure(sd_state[0], steps=50, size=512, seed=0, reps=TOOL_REPS,
                             trace_dir=os.path.join(REPO, "results", "stages"))
    launches = {name: fn.launches for name, fn in counters.items()}
    print("[stages] " + json.dumps(m), flush=True)
    unseen = [k for k, v in m["device_split"].items() if not v["device_time_seen"]]
    if unseen:
        raise AssertionError(f"stages: no device time in the trace of {unseen}")
    for name, split in m["device_split"].items():
        print(f"[stages] split {name}: busy {split['busy_ms']:.2f} of {split['wall_ms']:.2f} "
              f"ms traced, idle {split['idle_share']:.4f} (untraced "
              f"{split['idle_share_untraced']:.4f}), " + json.dumps(split["device_ms"]),
              flush=True)
    bad = _bad_rows(m["rows"]) + _bad_rows(m["marks"])
    if bad:
        raise AssertionError(f"stages: rows not finite and positive: {bad}")
    if not 0.85 <= m["closure_ratio"] <= 1.15:
        raise AssertionError(f"stages: closure {m['closure_ratio']:.3f} of the full run")
    if m["launches"] != {"k1": 500, "k2": 0}:
        raise AssertionError(f"stages: launches a run {m['launches']}, want K1 500, K2 0")
    return launches, m


def phase_anatomy(sd_state, stages: dict) -> dict:
    """``univst_torch.tools.bench_anatomy`` on ``[main]``'s pipeline, its
    chunk rows taken from ``[stages]``' result ``stages`` (the same calls on
    the same inputs). Gated: every row finite and positive; the 64x64 and
    32x32 attention rows launched K1 (one launch a call), the 16x16 rows
    did not."""
    from univst_torch.tools import bench_anatomy

    counters = _zero_counters()
    m = bench_anatomy.measure(sd_state[0], steps=50, size=512, seed=0, reps=TOOL_REPS,
                              stages=stages)
    launches = {name: fn.launches for name, fn in counters.items()}
    print("[anatomy] " + json.dumps(m), flush=True)
    bad = _bad_rows(m["rows"])
    if bad:
        raise AssertionError(f"anatomy: rows not finite and positive: {bad}")
    wrong = {row: p for row, p in m["attn_paths"].items()
             if p["k1_launches"] != (0 if p["level"] == "16x16" else 1)}
    if len(m["attn_paths"]) != 12 or wrong:
        raise AssertionError(f"anatomy: attention rows off their path: {wrong}")
    return launches


def phase_sd3_anatomy(state) -> dict:
    """``univst_torch.tools.bench_sd3_anatomy``'s three probes on
    ``[sd3]``'s pipeline (SD3-medium, 1024 px, 16 frames): the segments
    (``SD3_SEGMENT_STEPS`` a segment, one step of each traced) and the
    MMDiT forwards, K2 alone at the real shape against its plain version,
    the GEMMs. Gated: every row finite and positive, device time in each
    segment's trace; each segment's output finite and of the latents'
    shape; K2 24 launches a segment step and a 2F- and an F-frame forward,
    none for the single frame; K2 launched at ``[B,16,24,4429,4096,64]``
    (B = 2, 1) within ``err_over_tol`` <= 1. Returns the segments probe's
    launches (the attn probe's compare the kernel with its plain version)."""
    import torch

    from univst_torch.tools import bench_sd3_anatomy as sa

    pipe, _, ctx, pooled = state
    counters = _zero_counters()
    seg = sa.probe_segments(pipe, ctx, pooled, 1024, TOOL_REPS, SD3_SEGMENT_STEPS,
                            trace_dir=os.path.join(REPO, "results", "sd3_anatomy"))
    launches = {name: fn.launches for name, fn in counters.items()}
    attn = sa.probe_attn(pipe.device, pipe.num_frames, 1024, TOOL_REPS)
    mm = sa.probe_matmul(pipe.device, pipe.num_frames, 1024, TOOL_REPS)
    for m in (seg, attn, mm):
        print(f"[sd3_anatomy] {m['probe']} " + json.dumps(m), flush=True)
        bad = _bad_rows(m["rows"])
        if bad:
            raise AssertionError(f"sd3_anatomy {m['probe']}: rows not finite and positive: {bad}")
    for name, split in seg["device_split"].items():
        if not split["device_time_seen"]:
            raise AssertionError(f"sd3_anatomy: no device time in the trace of {name}")
        print(f"[sd3_anatomy] split {name}: busy {split['busy_ms']:.2f} ms, idle untraced "
              f"{split['idle_share_untraced']:.4f}, " + json.dumps(split["device_ms"]),
              flush=True)
    per_forward = pipe.mmdit.cfg.num_layers + len(pipe.mmdit.cfg.dual_attention_layers)
    got = [v.get("k2 a step", v.get("k2")) for v in seg["launches"].values()]
    want = [per_forward] * 4 + [0]
    if got != want:
        raise AssertionError(f"sd3_anatomy: K2 launches a segment step and a forward {got}, "
                             f"want {want}")
    shape = [pipe.num_frames, 1024 // 8, 1024 // 8, pipe.vae.cfg.latent_channels]
    bad = {k: v for k, v in seg["outputs"].items() if not v["finite"] or v["shape"] != shape}
    if len(seg["outputs"]) != 2 or bad:
        raise AssertionError(f"sd3_anatomy: segment outputs {seg['outputs']}, want finite "
                             f"{shape}")
    for name, case in attn["cases"].items():
        if case["shape"][1:] != [16, 24, 4429, 4096, 64] or case["k2_launches"] != 1:
            raise AssertionError(f"sd3_anatomy attn {name}: {case}")
        if not case["err_over_tol"] <= 1.0:
            raise AssertionError(f"sd3_anatomy attn {name}: K2 vs plain at "
                                 f"{case['err_over_tol']:.3g}x the tolerance")
    del pipe, state
    torch.cuda.empty_cache()
    return launches


def _run_compare_outputs(argv) -> tuple:
    """``compare_outputs.main(argv)``: its exit code and its stdout."""
    import contextlib
    import io

    from univst_torch.tools import compare_outputs

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = compare_outputs.main(argv)
    return code, buf.getvalue().strip()


def phase_compare(main_run) -> dict:
    """``univst_torch.tools.compare_outputs`` on ``[main]``'s stylized
    frames written as PNGs: against themselves every gate passes (PSNR,
    SSIM and LPIPS, AlexNet trunk with random weights from seed 0, on the
    card); against a copy with one frame inverted ``--psnr-min 40`` exits 1."""
    import numpy as np
    import torch
    from PIL import Image

    from univst_torch.utils.lpips import random_lpips_params

    root = os.path.join(REPO, "results", "compare")
    video = main_run["video"].cpu().numpy()
    for name, frames in (("a", video), ("b", video.copy())):
        if name == "b":
            frames[3] = 255 - frames[3]
        os.makedirs(os.path.join(root, name), exist_ok=True)
        for i, frame in enumerate(frames):
            Image.fromarray(frame).save(os.path.join(root, name, f"{i:05d}.png"))
    sd = random_lpips_params(0).state_dict()
    alex, lin = os.path.join(root, "alex.pth"), os.path.join(root, "lin.pth")
    torch.save({k: v for k, v in sd.items() if k.startswith("features.")}, alex)
    torch.save({k: v for k, v in sd.items() if k.startswith("lin")}, lin)
    a, b = os.path.join(root, "a"), os.path.join(root, "b")
    same, same_out = _run_compare_outputs(
        [a, a, "--json", "--psnr-min", "40", "--ssim-min", "0.99", "--lpips-alexnet", alex,
         "--lpips-lin", lin, "--lpips-max", "0.01"])
    print(f"[compare] itself: exit {same} " + same_out, flush=True)
    changed, changed_out = _run_compare_outputs([a, b, "--json", "--psnr-min", "40"])
    print(f"[compare] one frame inverted: exit {changed} " + changed_out, flush=True)
    res = json.loads(changed_out)
    if same != 0 or json.loads(same_out)["lpips_mean"] != 0.0:
        raise AssertionError(f"compare: the frames against themselves exit {same}")
    if changed != 1 or not np.isfinite(res["psnr_min"]) or res["psnr_min"] >= 40:
        raise AssertionError(f"compare: one frame inverted exit {changed}, psnr_min "
                             f"{res['psnr_min']}")
    return dict(same=same, changed=changed, psnr_min=res["psnr_min"])


RECIPE_DIR = os.path.join(REPO, "results", "recipe")
RECIPE_MASK = os.path.join(REPO, "examples", "masks", "demo-fly-tiny.png")


def start_recipe(pretrained: str):
    """Start ``univst_torch/tools/start_sd.sh`` as a subprocess on the card,
    in ``RECIPE_DIR``: the four CLIs of the SD workflow at full width, the
    three model stages loading the checkpoint directory ``pretrained``
    (``PRETRAINED``; ``[weights_day]``'s SD-1.5 one), on the committed
    ``demo-fly-tiny`` clip (4 frames, 64 px), its mask and the ``00033``
    style, at the CLIs' 50 steps. It runs beside ``[sd3]``, a path whose
    time is the card's (its stage seconds then hold the recipe's share of
    the card); its output goes to ``RECIPE_DIR/log.txt``. Returns
    ``(process, start time)``."""
    ex = os.path.join(REPO, "examples")
    shutil.rmtree(RECIPE_DIR, ignore_errors=True)
    os.makedirs(RECIPE_DIR)
    env = dict(os.environ, PYTHON=sys.executable, PRETRAINED=pretrained,
               CONTENT=os.path.join(ex, "contents", "demo-fly-tiny"), MASK=RECIPE_MASK,
               STYLE=os.path.join(ex, "styles", "00033.png"),
               ARGS="--num_frames 4 --height 64 --width 64")
    script = os.path.join(REPO, "univst_torch", "tools", "start_sd.sh")
    with open(os.path.join(RECIPE_DIR, "log.txt"), "w") as log:
        proc = subprocess.Popen(
            ["bash", "-c", 'SECONDS=0; bash "$0"; rc=$?; echo "recipe seconds $SECONDS"; exit $rc',
             script], cwd=RECIPE_DIR, env=env, stdout=log, stderr=subprocess.STDOUT)
    print(f"[recipe] start_sd.sh started (pid {proc.pid})", flush=True)
    return proc, time.time()


def phase_recipe(started) -> dict:
    """Wait for :func:`start_recipe`'s run and check its tree. Gated: the
    recipe exits 0; its three model stages each loaded the checkpoint
    directory (their ``loaded checkpoint directory`` lines); the tree holds
    both trajectories (51 files each), the input mask as frame 0 and {0,
    255} masks for the propagated frames, and 4 stylized non-constant 64 px
    frames."""
    import numpy as np
    from PIL import Image

    proc, t0 = started
    code = proc.wait(timeout=900)
    took = time.time() - t0
    with open(os.path.join(RECIPE_DIR, "log.txt")) as log:
        text = log.read()
    if code != 0:
        raise AssertionError(f"recipe: start_sd.sh exited {code}:\n" + text[-6000:])
    own = [int(ln.split()[-1]) for ln in text.splitlines() if ln.startswith("recipe seconds ")]
    out = os.path.join(RECIPE_DIR, "results")
    trajs = {k: len([f for f in os.listdir(os.path.join(out, d)) if f.endswith(".pt")])
             for k, d in (("content", "contents-inv/sd/demo-fly-tiny/inversion"),
                          ("style", "styles-inv/sd/00033/inversion"))}
    mask_dir = os.path.join(out, "masks", "sd", "demo-fly-tiny")
    masks = [np.asarray(Image.open(os.path.join(mask_dir, f"{i:05d}.png"))) for i in range(4)]
    first = np.asarray(Image.open(RECIPE_MASK))
    frame_dir = os.path.join(out, "stylizations", "sd", "demo-fly-tiny_00033")
    frames = [np.asarray(Image.open(os.path.join(frame_dir, f"{i:05d}.png"))) for i in range(4)]
    loaded = text.count("loaded checkpoint directory ")
    summary = dict(seconds=own[-1] if own else None, seconds_since_start=took,
                   trajectory_files=trajs, clis_that_loaded_the_directory=loaded,
                   first_mask_is_the_input=bool(np.array_equal(masks[0], first)),
                   mask_values=sorted({int(v) for m in masks[1:] for v in np.unique(m)}),
                   frames=[list(f.shape) for f in frames],
                   frame_std=[float(f.std()) for f in frames])
    print("[recipe] " + json.dumps(summary), flush=True)
    if trajs != {"content": 51, "style": 51}:
        raise AssertionError(f"recipe: trajectory files {trajs}")
    if loaded != 3:
        raise AssertionError(f"recipe: {loaded} of the 3 model stages loaded the checkpoint "
                             "directory")
    if not summary["first_mask_is_the_input"] or not set(summary["mask_values"]) <= {0, 255}:
        raise AssertionError(f"recipe: masks {summary}")
    if any(s != [64, 64, 3] for s in summary["frames"]) or not min(summary["frame_std"]) > 0:
        raise AssertionError(f"recipe: stylized frames {summary}")
    return summary


# ---------------------------------------------------------------------------
# [weights_day]: checkpoint directories written and loaded at full width
# ---------------------------------------------------------------------------

# the tool's SD-1.5 and AnimateDiff-v2 directories in fp32 (4.32 + 6.13 GB),
# the text encoder's copy for a planted fault (0.49 GB), and room to spare
WEIGHTS_DAY_FREE_BYTES = 16e9


def _rss_gb() -> dict:
    """The host process's resident memory now and its peak so far, in GB."""
    import resource

    with open("/proc/self/statm") as f:
        now = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024  # KiB on Linux
    return dict(now=now / 1e9, peak=peak / 1e9)


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(base, f))
               for base, _, files in os.walk(path) for f in files)


def _state_diff(got, want) -> list:
    """The names of ``want``'s parameters and buffers that ``got`` lacks or
    holds with another dtype or other bits, and the names it has beyond."""
    import torch

    a = dict(got.named_parameters()) | dict(got.named_buffers())
    b = dict(want.named_parameters()) | dict(want.named_buffers())
    return sorted(set(a) ^ set(b)) + [k for k in b if k in a and (
        a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k]))]


def _planted_faults(root: str, sd_dir: str) -> dict:
    """Two broken copies of the SD-1.5 text encoder's folder, each of which
    the strict load must refuse: one key renamed (the error names the key),
    and a shard index naming a second shard that is not there (the first is
    a link to the real file). Returns each error's first line."""
    import json as _json
    import warnings

    import torch

    from univst_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from univst_torch.models.convert import load_pretrained
    from univst_torch.utils.safetensors import load_file, save_file

    good = os.path.join(sd_dir, "text_encoder", "model.safetensors")
    sd = load_file(good)
    key = "text_model.final_layer_norm.weight"
    renamed = os.path.join(root, "fault_key")
    os.makedirs(os.path.join(renamed, "text_encoder"))
    save_file({(k + "_renamed" if k == key else k): v for k, v in sd.items()},
              os.path.join(renamed, "text_encoder", "model.safetensors"))
    shards = os.path.join(root, "fault_shard")
    os.makedirs(os.path.join(shards, "text_encoder"))
    first, second = "model-00001-of-00002.safetensors", "model-00002-of-00002.safetensors"
    os.symlink(good, os.path.join(shards, "text_encoder", first))
    keys = sorted(sd)
    with open(os.path.join(shards, "text_encoder", "model.safetensors.index.json"), "w") as f:
        _json.dump({"weight_map": {k: first if i % 2 else second for i, k in enumerate(keys)}},
                   f)
    del sd
    with torch.device("meta"):  # the key checks need no storage
        text = CLIPTextModel(CLIPTextConfig.sd15())
    out = {}
    for name, path, errors, needle in (("renamed_key", renamed, RuntimeError, key),
                                       ("missing_shard", shards, FileNotFoundError, second)):
        try:
            with warnings.catch_warnings():  # copies into meta tensors are no-ops
                warnings.simplefilter("ignore")
                load_pretrained(path, text_encoder=text)
        except errors as e:
            if needle not in str(e):
                raise AssertionError(f"weights_day: the {name} fault's error does not name "
                                     f"{needle}: {e}") from e
            out[name] = str(e).splitlines()[0][:240]
        else:
            raise AssertionError(f"weights_day: the planted {name} fault loaded")
    return out


def phase_weights_day(sd_state, steps: int):
    """Write the SD-1.5 and AnimateDiff-v2 checkpoint directories at full
    width with ``univst_torch.tools.make_synthetic_checkpoints`` (seed 0,
    fp32, on the card) under ``results/``, then load them as a user's run
    does. Gated: ``SDVideoPipeline.build(pretrained_model_path=...)`` in
    bf16 holds every parameter and buffer of ``[main]``'s seed-0 pipeline
    bit for bit; one 16-frame 512 px B = 1 UNet forward of it (inversion's,
    at step ``steps // 2``) equals the seeded pipeline's bit for bit, with 10
    K1 launches; the AnimateDiff pipeline loaded from its directory and
    ``mm.ckpt`` equals a fresh seed-0 ``build_animatediff`` (bf16) bit for
    bit; both planted faults (:func:`_planted_faults`) are refused. Both
    loaded builds draw their own init from seed 1 first, so a key that did
    not load would show. The reads are warm: the files were just written.
    Returns ``(launches, the directory)``; the caller removes it once
    ``[recipe]`` has run the SD CLIs from its ``sd`` folder."""
    import tempfile

    import torch

    from univst_torch.core.config import SD_BASE_FRAME_INDICES
    from univst_torch.pipelines.animatediff import build_animatediff
    from univst_torch.pipelines.sd import SDVideoPipeline
    from univst_torch.tools import make_synthetic_checkpoints as msc

    base = os.path.join(REPO, "results")
    os.makedirs(base, exist_ok=True)
    free = shutil.disk_usage(base).free
    if free < WEIGHTS_DAY_FREE_BYTES:
        raise AssertionError(f"weights_day: {free / 1e9:.1f} GB free under {base}, "
                             f"{WEIGHTS_DAY_FREE_BYTES / 1e9:.0f} GB needed")
    root = tempfile.mkdtemp(prefix="weights_day_", dir=base)
    sd_dir, ad_dir = os.path.join(root, "sd"), os.path.join(root, "ad")
    rss = {"before": _rss_gb()}
    kw = dict(num_frames=16, dtype=torch.bfloat16, capture_up_block=2, device="cuda")
    try:
        t0 = time.time()
        written = msc.main(["--root", root, "--families", "sd,ad", "--variant", "sd15",
                            "--frames", "16"])
        tool_s = time.time() - t0
        torch.cuda.empty_cache()
        rss["written"] = _rss_gb()

        t0 = time.time()
        loaded = SDVideoPipeline.build(pretrained_model_path=sd_dir, variant="sd15", seed=1, **kw)
        _sync()
        sd_load_s = time.time() - t0
        rss["sd_loaded"] = _rss_gb()
        pipe, traj, _, ctx, _, _ = sd_state
        diff = [(n, _state_diff(getattr(loaded, n), getattr(pipe, n)))
                for n in ("unet", "vae", "text_encoder")]
        if any(d for _, d in diff):
            raise AssertionError(f"weights_day: SD-1.5 loaded != [main]'s seed-0 build: "
                                 f"{[(n, d[:5]) for n, d in diff if d]}")
        i = steps // 2
        t = int(pipe.schedule.timesteps(steps)[i])
        with torch.inference_mode():
            want = pipe._denoise_fn(ctx, SD_BASE_FRAME_INDICES, None)(traj[i], t, i)
            counters = _zero_counters()
            got = loaded._denoise_fn(ctx, SD_BASE_FRAME_INDICES, None)(traj[i], t, i)
            _sync()
            launches = {k: f.launches for k, f in counters.items()}
        same = [torch.equal(g, w) if w is not None else g is None for g, w in zip(got, want)]
        _check_launches(launches, {"video_flash_attention": 10,
                                   "video_flash_attention_tokens": 0})
        if not all(same):
            raise AssertionError(f"weights_day: the loaded UNet's forward differs from the "
                                 f"seeded one's (eps, feature equal: {same})")
        del loaded, got, want
        torch.cuda.empty_cache()

        t0 = time.time()
        ad = build_animatediff(pretrained_model_path=ad_dir,
                               motion_module_path=os.path.join(ad_dir, "mm.ckpt"), variant="ad",
                               seed=1, **kw)
        _sync()
        ad_load_s = time.time() - t0
        rss["ad_loaded"] = _rss_gb()
        seeded = build_animatediff(variant="ad", seed=0, **kw)
        diff = [(n, _state_diff(getattr(ad, n), getattr(seeded, n)))
                for n in ("unet", "vae", "text_encoder")]
        if any(d for _, d in diff):
            raise AssertionError(f"weights_day: AnimateDiff loaded != a seed-0 build: "
                                 f"{[(n, d[:5]) for n, d in diff if d]}")
        del ad, seeded
        torch.cuda.empty_cache()
        faults = _planted_faults(root, sd_dir)
    except BaseException:
        shutil.rmtree(root, ignore_errors=True)
        raise
    rss["after"] = _rss_gb()
    sd_gb, ad_gb = _dir_bytes(sd_dir) / 1e9, _dir_bytes(ad_dir) / 1e9
    summary = dict(
        written_gb=written["bytes"] / 1e9, files=written["files"], write_s=written["write_s"],
        write_gb_per_s=written["bytes"] / 1e9 / written["write_s"], tool_s=tool_s,
        sd_read_gb=sd_gb, sd_load_s=sd_load_s, sd_load_gb_per_s=sd_gb / sd_load_s,
        ad_read_gb=ad_gb, ad_load_s=ad_load_s, ad_load_gb_per_s=ad_gb / ad_load_s,
        reads="warm (page cache: the files were just written)",
        host_rss_gb=rss, loaded_equal_seeded={"sd": True, "ad": True, "forward": True},
        launches=launches, faults_refused=faults, device=_nvidia_smi())
    print("[weights_day] " + json.dumps(summary), flush=True)
    return launches, root


# ---------------------------------------------------------------------------
# [mesh]: frame parallelism over gloo ranks that share the one card
# ---------------------------------------------------------------------------

MESH_PG_TIMEOUT_S = 300  # a hung collective raises after this
# a sharded bf16 forward's relative RMS distance from the reference's fp32
# forward, over the one-process bf16 forward's distance, at most this
MESH_BF16_RATIO = 1.25
MESH_JOBS = {
    # name: backbone, dtype, px, frames, ranks, steps (each job against a
    # one-card run at its steps; the bf16 jobs' steps cut from 30 (SD) and
    # 10 (AD) to keep the script within its time limit: with its fp32 floor
    # and stage-fed rerun, the AD job takes 175 s at 10 steps on the card;
    # the SD job's 10 then to 6, which still hold [mesh] smooth's smoothing
    # steps [4, 6), when the script with [bench] took 1218 s; at 3 steps the
    # fp32 4-rank job's stage-fed reconstruction read err / tol 1.12, 0.93
    # at 6)
    "sd_bf16_2": ("sd", "bf16", 512, 16, 2, 6),
    "sd_fp32_2": ("sd", "fp32", 256, 8, 2, 6),
    "sd_fp32_4": ("sd", "fp32", 256, 8, 4, 6),
    "ad_bf16_2": ("ad", "bf16", 512, 16, 2, 6),
}
SD3_MESH_JOBS = {
    # name: variant, dtype, px (1024 tokens a frame: K2 runs), frames,
    # data ranks, tensor ranks, steps (cut from 8 and 4 to keep the script
    # within its time limit: gloo moves each all-reduce through the host)
    "sd3m_bf16_dp2": ("sd3", "bf16", 512, 16, 2, 1, 2),
    "sd35m_bf16_dp2tp2": ("sd35m", "bf16", 512, 8, 2, 2, 1),
}
# the SD3 forward pair on a tensor axis that does not divide the heads:
# SD3.5-large's MMDiT alone (38 heads of 64, hidden 2432; depth cut from 38
# blocks to ``layers``), 512 px, ``nf`` frames, on ``data x tensor`` gloo
# ranks (10, 10, 9 and 9 heads a rank), the probe at step ``steps // 2``
SD3_TP_FORWARD = dict(variant="sd35", layers=4, px=512, nf=4, data=1, tensor=4, steps=8)
# [mesh] smooth: the job whose ranks and one-card runs also stylize with
# the pixel smoother (LK, two smoothing steps inside phase 1, radius 2;
# ``_mesh_smooth``), from the same trajectories, masks and context
MESH_SMOOTH_JOB = "sd_bf16_2"
MESH_SMOOTH = dict(smoother="pixel", smoother_steps=(4, 6), smoother_radius=2)
SD3_CAPTURE = (20, 5)  # the feature's block and inversion step (phase_sd3's)
# a workflow's tensors that a [mesh] comparison reads; the stage inputs a
# stage-fed run takes from another run; the outputs of each stage
WF_KEYS = ("latents", "slatents", "ctx", "traj", "feat", "straj", "masks", "out", "video", "rec")
FED_INPUTS = ("latents", "slatents", "ctx", "traj", "feat", "straj", "masks", "out")
STAGE_OUTPUTS = {"encode": ("latents", "slatents"), "content_inversion": ("traj", "feat"),
                 "style_inversion": ("straj",), "mask_propagation": ("masks",),
                 "stylize": ("out",), "decode": ("frames",), "reconstruction": ("rec",)}


def _vfa_shard_case(b, nf, n, rank, h, l, dh, idx, dtype, reps=5, plant=False):
    """K1's shard form on rank ``rank`` of ``n`` (global ``nf`` frames): q of
    the rank's F = nf / n frames, k/v of its Fk = F + halo frames (its own,
    then the halo frames its index set reads), the slot tables explicit.
    Against its plain version (``err_over_tol``), against the unsharded
    ``nf``-frame call's rows of the same frames (bitwise equal or not), and,
    with ``plant``, a slot table shifted by one frame, which the check must
    reject. Times and the bound count the shard form's own work."""
    import torch
    import torch.nn.functional as F

    from univst_torch.attention.ops import shard_kv_tables
    from univst_torch.attention.video_flash import (
        video_flash_attention, video_flash_attention_plain,
    )
    from univst_torch.tools import err_over_tol

    f = nf // n
    off = rank * f
    halo, srcs, mult = shard_kv_tables(tuple(idx), nf, off, f)
    fk = f + len(halo)
    gen = torch.Generator(device="cuda").manual_seed(l * dh + len(idx) + rank)

    def r(*s):
        return torch.randn(s, generator=gen, device="cuda").to(dtype)

    qg, kg, vg = r(b, nf, h, l, dh), r(b, nf, h, l, dh), r(b, nf, h, l, dh)
    rows = list(range(off, off + f)) + list(halo)
    q = qg[:, off:off + f].contiguous()
    k, v = kg[:, rows].contiguous(), vg[:, rows].contiguous()
    tables = (srcs, mult)
    got = video_flash_attention(q, k, v, idx, tables=tables)
    whole = video_flash_attention(qg, kg, vg, idx)[:, off:off + f]
    _sync()
    want = video_flash_attention_plain(q, k, v, idx, tables=tables)
    _sync()
    err = (got.float() - want.float()).abs().max().item()
    ratio = err_over_tol(got, want)
    if not ratio <= 1.0:
        raise AssertionError(f"video_flash_attention shard form {tuple(q.shape)} Fk={fk} {idx}: "
                             f"kernel vs plain at {ratio:.3g}x the tolerance (max abs err {err})")
    planted = None
    if plant:
        wrong = video_flash_attention(q, k, v, idx, tables=((srcs + 1) % fk, mult))
        planted = err_over_tol(wrong, want)
        if not planted > 1.0:
            raise AssertionError(f"the check passed a slot table shifted by one frame "
                                 f"({planted:.3g}x the tolerance)")
        print(f"[kernel] planted fault (slot table one frame off) rejected at {planted:.3g}x "
              f"the tolerance", flush=True)
    ms = _time_ms(lambda: video_flash_attention(q, k, v, idx, tables=tables), reps)
    plain_ms = _time_ms(lambda: video_flash_attention_plain(q, k, v, idx, tables=tables), 1)
    ixs = torch.as_tensor(srcs, dtype=torch.long, device="cuda")

    def expand(x):  # [b, Fk, h, l, dh] -> each target frame's slots: [b*f, h, S*l, dh]
        return x[:, ixs].permute(0, 1, 3, 2, 4, 5).reshape(b * f, h, -1, dh).contiguous()

    qh, ke, ve = q.reshape(b * f, h, l, dh), expand(k), expand(v)
    library_ms = _time_ms(lambda: F.scaled_dot_product_attention(qh, ke, ve), reps)
    case = dict(shape=[b, f, h, l, l, dh], indices=list(idx), dtype=str(dtype).split(".")[-1],
                ctx=None, shard=dict(frames=nf, ranks=n, rank=rank, fk=fk, halo=list(halo)),
                max_abs_err=err, err_over_tol=ratio, planted_err_over_tol=planted,
                rows_bitwise_equal_unsharded=bool(torch.equal(got, whole)),
                rows_max_abs_diff_unsharded=(got.float() - whole.float()).abs().max().item(),
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                **_bound([b, f, h, l, l, dh], idx, 0, dtype, tables=tables))
    print(f"[kernel] {json.dumps(case)}", flush=True)
    return case


def _vfa_tokens_shard_case(b, nf, n, rank, h, lq, l, dh, idx, dtype, lc, reps=3, plant=False):
    """K2's shard form (token-major, the context per q frame) against its
    plain version: q of the rank's frames, k/v with the halo frames; with
    ``plant``, a slot table shifted by one frame, which the check must
    reject. SDPA runs on the rank's own expanded ``[img*slots | ctx]``
    K/V. At ``h`` = a tensor rank's share of the heads, the shape a
    ``data x tensor`` rank gives K2."""
    import torch
    import torch.nn.functional as F

    from univst_torch.attention.ops import shard_kv_tables
    from univst_torch.attention.video_flash import (
        video_flash_attention_tokens, video_flash_attention_tokens_plain,
    )
    from univst_torch.tools import err_over_tol

    f = nf // n
    halo, srcs, mult = shard_kv_tables(tuple(idx), nf, rank * f, f)
    fk = f + len(halo)
    gen = torch.Generator(device="cuda").manual_seed(lq * dh + rank)

    def r(*s):
        return torch.randn(s, generator=gen, device="cuda").to(dtype)

    q, k, v = r(b, f, lq, h, dh), r(b, fk, l, h, dh), r(b, fk, l, h, dh)
    kw = dict(ctx_k=r(b, f, lc, h, dh), ctx_v=r(b, f, lc, h, dh), ctx_valid=lc,
              tables=(srcs, mult))
    got = video_flash_attention_tokens(q, k, v, idx, **kw)
    _sync()
    want = video_flash_attention_tokens_plain(q, k, v, idx, **kw)
    _sync()
    err = (got.float() - want.float()).abs().max().item()
    ratio = err_over_tol(got, want)
    if not ratio <= 1.0:
        raise AssertionError(f"video_flash_attention_tokens shard form {tuple(q.shape)} "
                             f"Fk={fk}: kernel vs plain at {ratio:.3g}x the tolerance")
    planted = None
    if plant:
        wrong = video_flash_attention_tokens(q, k, v, idx, **dict(kw, tables=((srcs + 1) % fk,
                                                                             mult)))
        planted = err_over_tol(wrong, want)
        if not planted > 1.0:
            raise AssertionError(f"the check passed a slot table shifted by one frame "
                                 f"({planted:.3g}x the tolerance)")
        print(f"[kernel] planted fault (K2 slot table one frame off) rejected at "
              f"{planted:.3g}x the tolerance", flush=True)
        del wrong
    del want
    ms = _time_ms(lambda: video_flash_attention_tokens(q, k, v, idx, **kw), reps)
    plain_ms = _time_ms(lambda: video_flash_attention_tokens_plain(q, k, v, idx, **kw), 1)
    ixs = torch.as_tensor(srcs, dtype=torch.long, device="cuda")

    def expand(x):  # [b, Fk, L, h, dh] -> each target frame's slots: [b*f, h, S*L, dh]
        return x[:, ixs].permute(0, 1, 4, 2, 3, 5).reshape(b * f, h, -1, dh)

    def heads(x):
        return x.reshape(b * f, x.shape[2], h, dh).transpose(1, 2)

    qh = heads(q).contiguous()
    ke = torch.cat([expand(k), heads(kw["ctx_k"])], dim=2).contiguous()
    ve = torch.cat([expand(v), heads(kw["ctx_v"])], dim=2).contiguous()
    library_ms = _time_ms(lambda: F.scaled_dot_product_attention(qh, ke, ve), reps)
    del qh, ke, ve
    case = dict(shape=[b, f, h, lq, l, dh], indices=list(idx), dtype=str(dtype).split(".")[-1],
                ctx=[lc, lc], shard=dict(frames=nf, ranks=n, rank=rank, fk=fk, halo=list(halo)),
                max_abs_err=err, err_over_tol=ratio, planted_err_over_tol=planted, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms,
                **_bound([b, f, h, lq, l, dh], idx, lc, dtype, tables=(srcs, mult)))
    print(f"[kernel] {json.dumps(case)}", flush=True)
    return case


def _build_mesh_pipe(backbone: str, dtype_name: str, nf: int):
    import torch

    dtype = torch.bfloat16 if dtype_name == "bf16" else torch.float32
    if backbone == "ad":
        return _build_ad(dtype)[0]
    from univst_torch.pipelines.sd import SDVideoPipeline

    return SDVideoPipeline.build(variant="sd15", num_frames=nf, dtype=dtype, capture_up_block=2,
                                 seed=0, device="cuda")


def _rank_mesh(rank: int, n: int, out_dir: str, n_tensor: int = 1):
    """A job rank's mesh: a gloo process group over a file store in
    ``out_dir``, every rank on ``cuda:0``, ``n_tensor`` ranks on the tensor
    axis; fp32 without TF32, as in the script's own process."""
    sys.path.insert(0, REPO)
    import datetime

    import torch
    import torch.distributed as dist

    from univst_torch.distributed.mesh import make_mesh

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store", rank=rank,
                            world_size=n,
                            timeout=datetime.timedelta(seconds=MESH_PG_TIMEOUT_S))
    return make_mesh(n_tensor=n_tensor, device="cuda:0")


def _mesh_rank(rank: int, n: int, out_dir: str, job: str, steps: int):
    """One rank of a ``[mesh]`` job: a gloo process group over a file store,
    every rank on ``cuda:0``; the pipeline built as the one-process phases
    build it, replicated from rank 0 (``with_mesh``), then the workflow on
    the rank's frames; then, once the script's process has published its
    one-card runs (``_await_fed``), the forward pair on the reference's
    inputs and each stage once more on the one-card run's stage inputs
    (``_stage_fed``), and in ``MESH_SMOOTH_JOB`` the smoothed stylization
    and smoothing steps (``_mesh_smooth``). Each rank writes its counts and
    times; rank 0 also the gathered outputs. Nothing is caught: a failure
    ends the job."""
    import torch
    import torch.distributed as dist

    backbone, dtype_name, px, nf, _, _ = MESH_JOBS[job]
    mesh = _rank_mesh(rank, n, out_dir)
    t0 = time.time()
    pipe = _build_mesh_pipe(backbone, dtype_name, nf)
    _sync()
    build_s = time.time() - t0
    t0 = time.time()
    pipe = pipe.with_mesh(mesh)
    _sync()
    replicate_s = time.time() - t0
    torch.cuda.reset_peak_memory_stats()
    counters = _zero_counters()
    w = _workflow(pipe, backbone, steps, nf, px, f"mesh {job} r{rank}")
    launches = {name: fn.launches for name, fn in counters.items()}
    by_op = _census_by_op(w["census"])
    stats = dict(job=job, rank=rank, ranks=n, steps=steps, build_s=build_s,
                 replicate_s=replicate_s, stage_s=w["stage"], main_path_s=w["main_s"],
                 census_by_stage=w["census"],
                 census_per_inversion_forward={
                     key: dict(count=c["count"] / steps, mb=c["mb"] / steps)
                     for key, c in w["census"]["content_inversion"].items()
                     if not key.endswith(":outputs")},
                 collectives_by_op=by_op,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, launches=launches)
    print(f"[mesh] {json.dumps(stats)}", flush=True)
    torch.save(stats, os.path.join(out_dir, f"stats{rank}.pt"))
    fed_in = _await_fed(out_dir)
    forward = _forward_pair(pipe, fed_in["probe"])  # on the reference's inputs
    t0 = time.time()
    fed = _stage_fed(pipe, backbone, steps, nf, px, fed_in)
    print(f"[mesh] {job} r{rank}: stage-fed stages in {time.time() - t0:.1f}s", flush=True)
    smooth = None
    if job == MESH_SMOOTH_JOB:
        t0 = time.time()
        smooth = _mesh_smooth(pipe, fed_in, steps)
        torch.save({k: v for k, v in smooth.items() if not torch.is_tensor(v)},
                   os.path.join(out_dir, f"smooth{rank}.pt"))
        print(f"[mesh] {job} r{rank}: smoothed stylization and steps in "
              f"{time.time() - t0:.1f}s", flush=True)
    if rank == 0:
        result = {k: w[k].cpu() for k in WF_KEYS}
        torch.save(dict(result, forward=forward, fed=fed, smooth=smooth),
                   os.path.join(out_dir, "result.pt"))
    dist.barrier()
    dist.destroy_process_group()


# the longest a rank waits for the script's one-card runs (``_await_fed``)
MESH_FED_WAIT_S = 900


def _await_fed(out_dir: str) -> dict:
    """In a rank: the one-card run's probe and stage inputs, once the
    script's process has published them in ``out_dir/fed.pt``."""
    import torch

    path, t0 = os.path.join(out_dir, "fed.pt"), time.time()
    while not os.path.exists(path):
        if time.time() - t0 > MESH_FED_WAIT_S:
            raise TimeoutError(f"no one-card inputs in {path} after {MESH_FED_WAIT_S} s")
        time.sleep(0.5)
    return torch.load(path, weights_only=False)


def _run_mesh_job(job: str, steps: int, prepare):
    """Spawn the job's ranks (never fork after CUDA init), and while they
    build and run their workflow (gloo through host memory: the host's
    time), run ``prepare()`` here: the one-card runs (the card's time),
    which return ``(probe, fed, refs)``. The probe and ``fed``'s stage
    inputs go to the ranks in ``out_dir/fed.pt`` (written whole, then
    renamed into place); then wait for the ranks. A rank that raises, or a
    failure here, ends the job and its ranks. Returns rank 0's outputs,
    every rank's stats and ``refs``."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    if job in MESH_JOBS:
        n, target = MESH_JOBS[job][4], _mesh_rank
    else:
        n, target = SD3_MESH_JOBS[job][4] * SD3_MESH_JOBS[job][5], _sd3_mesh_rank
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "results")) as out_dir:
        t0 = time.time()
        ranks = mp.spawn(target, args=(n, out_dir, job, steps), nprocs=n, join=False)
        try:
            probe, fed, refs = prepare()
            tmp = os.path.join(out_dir, "fed.pt.tmp")
            torch.save(dict({k: fed[k] for k in FED_INPUTS + ("pooled", "smooth_in", "smooth_ref")
                             if k in fed}, probe=probe), tmp)
            os.replace(tmp, os.path.join(out_dir, "fed.pt"))
            while not ranks.join():
                pass
        finally:
            for proc in ranks.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join()
        wall = time.time() - t0
        stats = [torch.load(os.path.join(out_dir, f"stats{r}.pt"), weights_only=False)
                 for r in range(n)]
        for r, st in enumerate(stats):
            path = os.path.join(out_dir, f"smooth{r}.pt")
            if os.path.exists(path):
                st["smooth"] = torch.load(path, weights_only=False)
        result = torch.load(os.path.join(out_dir, "result.pt"), weights_only=False)
    print(f"[mesh] {job}: {n} ranks in {wall:.1f}s (the one-card runs beside them)", flush=True)
    return result, stats, refs


def _psnr_frames(got, want):
    """PSNR of each uint8 frame against the reference's, in dB."""
    import torch

    mse = (got.double() - want.double()).pow(2).flatten(1).mean(1)
    return [float("inf") if m == 0 else 10 * torch.log10(255.0**2 / m).item() for m in mse]


def _rel_rms(got, want) -> float:
    got, want = got.double(), want.double()
    return ((got - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt()).item()


def _err_over_tol32(got, want) -> float:
    """``max |got - want| / (2e-5 + 2e-4 |want|)``: the fp32 bar of the JAX
    package's sharded-against-single-device test (tests/test_distributed.py:
    89-125), passing at <= 1."""
    got, want = got.double(), want.double()
    return ((got - want).abs() / (2e-5 + 2e-4 * want.abs())).max().item()


def _probe_inputs(pipe, w: dict, steps: int) -> dict:
    """The inputs of ``_forward_pair`` from a workflow's own tensors at its
    middle step: the content latent, the style latents of all frames, the
    prompt, the step and its timestep (on the host)."""
    i = steps // 2
    return dict(i=i, t=int(pipe.schedule.timesteps(steps)[i]), z=w["traj"][i].cpu(),
                sty=w["straj"][i].expand(pipe.num_frames, -1, -1, -1).cpu(),
                ctx=w["ctx"].cpu())


def _forward_pair(pipe, probe: dict) -> dict:
    """Two UNet forwards on the same inputs (``_probe_inputs``): the
    inversion's (B = 1, the model-default frame set) and the injected
    2-branch stylization forward, the style branch's K/V captured by a
    forward of the style latents; in the pipeline's type and, for a bf16
    pipeline, once more with the UNet in fp32 (``*_fp32``; the UNet is
    back in bf16 after, bit for bit). Under a mesh each runs on the rank's
    frames; the eps come back gathered, on the host."""
    import torch

    from univst_torch.distributed.mesh import gather_frames
    from univst_torch.models.layers import StyleCtx
    from univst_torch.models.unet_sd import extract_pnp_kv

    i, t, nf = probe["i"], probe["t"], pipe.num_frames
    dev = pipe.device
    ctx = probe["ctx"].to(dev)
    z, sty = (pipe._shard(probe[k].to(dev)) for k in ("z", "sty"))
    shard = pipe._frame_shard()

    def whole(x):
        x = x.reshape((-1, z.shape[0]) + x.shape[1:])
        return (x if shard is None else gather_frames(x, pipe.mesh, axis=1)).float().cpu()

    def pair(p):
        with torch.inference_mode():
            eps1 = p._denoise_fn(ctx, p.base_frame_indices, None)(z, t, i)[0]
            cap = StyleCtx(step_idx=i, cfg=p.style_shift_cfg, capture=True)
            p.unet(sty.to(p.dtype), t, ctx, p._stylize_vctx(nf), cap)
            two = p._denoise_fn(torch.cat([ctx, ctx]), p.pnp_frame_indices, p.style_shift_cfg)
            eps2 = two(torch.cat([z, z]), t, i, style_kv=extract_pnp_kv(cap.captured))[0]
        _sync()
        return whole(eps1), whole(eps2)

    out = dict(zip(("inversion", "injected"), pair(pipe)))
    if pipe.dtype != torch.float32:
        pipe.unet.float()
        out.update(zip(("inversion_fp32", "injected_fp32"),
                       pair(dataclasses.replace(pipe, dtype=torch.float32))))
        pipe.unet.to(pipe.dtype)
    return out


def _one_process(backbone: str, dtype_name: str, px: int, nf: int, steps: int, tag: str,
                 forward: bool = True, fed=None, encode_parts=(), smooth: bool = False):
    """A ``[mesh]`` job's one-process run on the card: the workflow (its
    tensors, each stage's output on its own inputs, the decode's frames
    before rounding), with ``forward`` its forward pair, with ``fed`` each
    stage on another run's stage inputs (``_stage_fed``), and the encode's
    batch-shape floor for each split in ``encode_parts``. With ``smooth``:
    without ``fed`` (the fp32 floor) the smoothed stylization on its own
    tensors and its first smoothing step's inputs; with
    ``fed`` (the one-card bf16 run) ``_mesh_smooth`` on ``fed``'s."""
    import torch

    pipe = _build_mesh_pipe(backbone, dtype_name, nf)
    w = _workflow(pipe, backbone, steps, nf, px, tag)
    out = {k: w[k].cpu() for k in WF_KEYS}
    out["frames"] = _decode_float(pipe, w["out"]).cpu()
    out["probe"] = _probe_inputs(pipe, w, steps)
    if forward:
        out["forward"] = _forward_pair(pipe, out["probe"])
    if fed is not None:
        out["fed"] = _stage_fed(pipe, backbone, steps, nf, px, fed)
    if smooth and fed is None:
        out["smooth_in"] = {}
        spipe = _with_smooth_eps(pipe, _first_step_inputs(out["smooth_in"]))
        out["smooth_out"] = _stylize(spipe, backbone, w["traj"], w["straj"], w["ctx"], w["masks"],
                                     steps, **MESH_SMOOTH).cpu()
    elif smooth:
        out["smooth"] = _mesh_smooth(pipe, fed, steps)
    out["encode_floor"] = {parts: _encode_batch_floor(pipe, nf, px, parts)
                           for parts in encode_parts}
    del pipe, w
    torch.cuda.empty_cache()
    return out


def _one_card_fed(backbone: str, dtype_name: str, px: int, nf: int, steps: int, fed) -> dict:
    """Each stage on one card in ``dtype_name``, on ``fed``'s stage inputs."""
    import torch

    pipe = _build_mesh_pipe(backbone, dtype_name, nf)
    out = _stage_fed(pipe, backbone, steps, nf, px, fed)
    del pipe
    torch.cuda.empty_cache()
    return out


def _stage_fed(pipe, backbone: str, steps: int, nf: int, px: int, fed: dict) -> dict:
    """Each stage of ``_workflow`` once more, fed the stage inputs of another
    run (``fed``: its encoded latents, text context, trajectories, feature,
    masks and stylized latents) instead of its own outputs, so that no
    earlier stage's difference reaches a later one: encode (the same frames
    and draws), content inversion, style inversion, mask propagation,
    stylization, decode (in [0, 1], before rounding), reconstruction.
    Returns ``STAGE_OUTPUTS``' tensors, on the host."""
    import torch

    device = pipe.device
    frames, style, mask0 = _load_inputs(nf, px, style_frames=1 if backbone == "sd" else nf)
    ts = pipe.schedule.timesteps(steps)
    cap_t = 301 if 301 in ts else int(ts[len(ts) // 2])
    gen = torch.Generator(device=device).manual_seed(0)
    spipe = _style_pipe(pipe, backbone)

    def inp(k):
        return fed[k].to(device)

    ctx = inp("ctx")
    res = dict(latents=pipe.encode_frames(frames, gen), slatents=spipe.encode_frames(style, gen))
    res["traj"], res["feat"] = pipe.invert(inp("latents"), ctx, num_steps=steps, is_opt=True,
                                           capture_timestep=cap_t)
    res["straj"] = spipe.invert(inp("slatents"), ctx, num_steps=steps, is_opt=False)[0]
    res["masks"] = _propagate(inp("feat"), mask0, device)
    res["out"] = _stylize(pipe, backbone, inp("traj"), inp("straj"), ctx, inp("masks"), steps)
    res["frames"] = _decode_float(pipe, inp("out"))
    res["rec"] = pipe.reconstruct_latents(inp("traj")[-1], ctx, num_steps=steps)
    _sync()
    return {k: v.cpu() for k, v in res.items()}


def _with_smooth_eps(pipe, wrap):
    """A copy of ``pipe`` whose smoothing steps call ``wrap(pipe._smooth_eps)``
    (a recorder, a timer) in its place."""
    pipe = dataclasses.replace(pipe)
    pipe._smooth_eps = wrap(pipe._smooth_eps)
    return pipe


def _first_step_inputs(record: dict):
    """A ``_with_smooth_eps`` wrap that keeps the first smoothing step's inputs
    (``eps``, ``t``, ``latents``, ``mask``) in ``record``."""
    def wrap(smooth_eps):
        def recorded(eps, t, latents, mask, cfg):
            if not record:
                record.update(eps=eps.cpu(), t=t, latents=latents.cpu(), mask=mask.cpu())
            return smooth_eps(eps, t, latents, mask, cfg)
        return recorded
    return wrap


def _raft_seed0(device, mesh=None):
    """RAFT-large as ``[raft]`` builds it (``RAFTConfig()``, weights from
    seed 0, fp32) on ``device``, replicated from rank 0 under ``mesh`` as
    the transfer CLI replicates a loaded one."""
    import torch

    from univst_torch.distributed.mesh import replicate
    from univst_torch.models.raft import RAFT, RAFTConfig, make_raft_flow

    torch.manual_seed(0)
    model = RAFT(RAFTConfig()).eval().to(device)
    return make_raft_flow(replicate(model, mesh))


def _counted_flow(fn, batches: list):
    """``fn`` that appends each call's batch size (pairs x 2) to ``batches``."""
    def counted(a, b):
        batches.append(int(a.shape[0]))
        return fn(a, b)
    return counted


def _mesh_smooth(pipe, fed: dict, steps: int) -> dict:
    """``[mesh] smooth`` on one run of ``MESH_SMOOTH_JOB`` (a rank, or the
    one-card bf16 run): the smoothed stylization (``_stylize`` with
    ``MESH_SMOOTH``, LK) on
    ``fed``'s trajectories, masks and context, with its K1 / K2 launches,
    its ``smooth_halo`` collectives, its flow batches and the seconds of
    each smoothing step; then one smoothing step alone, with the VAE in
    fp32, on the fp32 floor's inputs to its first smoothing step
    (``fed['smooth_in']``; under a mesh the rank's frames of them), with LK
    and with RAFT-large (``_raft_seed0``). Outputs gathered, on the host."""
    import torch

    import univst_torch.methods.flow as flow_mod
    from univst_torch.core.config import StyleTransferConfig
    from univst_torch.distributed.census import collect_collectives

    dev, shard = pipe.device, pipe._frame_shard()
    step_s, batches = [], []

    def timer(smooth_eps):
        def timed(*a, **kw):
            _sync()
            t0 = time.time()
            out = smooth_eps(*a, **kw)
            _sync()
            step_s.append(time.time() - t0)
            return out
        return timed

    lk = _counted_flow(flow_mod.lucas_kanade_flow, batches)
    counters = _zero_counters()
    spipe = _with_smooth_eps(dataclasses.replace(pipe, flow_fn=lk), timer)
    with collect_collectives() as recs:
        out = _stylize(spipe, "sd", *(fed[k].to(dev) for k in ("traj", "straj", "ctx", "masks")),
                       steps, **MESH_SMOOTH)
        _sync()
    res = dict(out=out.cpu(), launches={name: fn.launches for name, fn in counters.items()},
               step_s=step_s, flow_batches=batches,
               halo=[(op, nbytes, sec) for op, nbytes, site, sec in recs
                     if site == "smooth_halo"])
    s_in, one = fed["smooth_in"], fed.get("smooth_ref")
    cfg = StyleTransferConfig(num_steps=steps, **MESH_SMOOTH)
    eps, lat, mask = (pipe._shard(s_in[k].to(dev)) for k in ("eps", "latents", "mask"))
    smooth_fn = flow_mod.sliding_window_smooth
    pipe.vae.float()
    try:
        for name, fn in (("lk", flow_mod.lucas_kanade_flow), ("raft", _raft_seed0(dev, pipe.mesh))):
            fb, rec = [], {}
            p32 = dataclasses.replace(pipe, dtype=torch.float32, flow_fn=_counted_flow(fn, fb))
            decode = p32._decode_local

            def decode_kept(*a, **kw):
                rec["px"] = decode(*a, **kw)
                return rec["px"]

            def smooth_kept(*a, **kw):
                rec["sm"] = smooth_fn(*a, **kw)
                return rec["sm"]

            p32._decode_local, flow_mod.sliding_window_smooth = decode_kept, smooth_kept
            try:
                with torch.inference_mode(), collect_collectives() as step_recs:
                    got = p32._smooth_eps(eps, s_in["t"], lat, mask, cfg)
                    _sync()
                res[f"step_{name}"] = pipe._gather(got, shard).cpu()
                res[f"sm_{name}"] = pipe._gather(rec["sm"], shard).cpu()
                if "px" not in res:  # the same decode for both flows
                    res["px"] = pipe._gather(rec["px"], shard).cpu()
                if one is not None:
                    # the same step fed the one-card run's decoded frames (its
                    # smoother's input) and smoothed frames (its encoder's)
                    p32._decode_local = lambda *a, **kw: pipe._shard(one["px"].to(dev))

                    def smooth_fed(*a, **kw):
                        rec["fed_sm"] = smooth_fn(*a, **kw)
                        return pipe._shard(one[f"sm_{name}"].to(dev))

                    flow_mod.sliding_window_smooth = smooth_fed
                    with torch.inference_mode():
                        fed_step = p32._smooth_eps(eps, s_in["t"], lat, mask, cfg)
                    res[f"fed_step_{name}"] = pipe._gather(fed_step, shard).cpu()
                    res[f"fed_sm_{name}"] = pipe._gather(rec["fed_sm"], shard).cpu()
            finally:
                flow_mod.sliding_window_smooth = smooth_fn
            res[f"step_{name}_flow_batches"] = fb[:1]
            res[f"step_{name}_halo"] = [(op, nbytes) for op, nbytes, site, _ in step_recs
                                        if site == "smooth_halo"]
    finally:
        pipe.vae.to(pipe.dtype)
    torch.cuda.empty_cache()
    return res


def _encode_batch_floor(pipe, nf: int, px: int, parts: int) -> dict:
    """What a change of batch shape alone does to the encode on one card:
    the content frames encoded as ``parts`` batches of ``nf / parts``
    frames against all ``nf`` at once, with the same noise (the encoder is
    per frame: only the convolutions' choice of algorithm per shape
    differs)."""
    import torch

    frames = torch.as_tensor(_load_inputs(nf, px)[0])
    shape = pipe.encode_frames(frames[:1], noise=torch.zeros(())).shape[1:]
    noise = torch.randn((nf,) + tuple(shape), generator=torch.Generator().manual_seed(0))
    whole = pipe.encode_frames(frames, noise=noise).cpu()
    k = nf // parts
    split = torch.cat([pipe.encode_frames(frames[s:s + k], noise=noise[s:s + k]).cpu()
                       for s in range(0, nf, k)])
    out = dict(frames=nf, size=px, parts=parts, dtype=str(pipe.dtype).split(".")[-1],
               rel_rms=_rel_rms(split, whole), err_over_tol32=_err_over_tol32(split, whole),
               max_abs_diff=(split - whole).abs().max().item(),
               bitwise_equal=bool(torch.equal(split, whole)))
    print(f"[mesh] encode batch floor {json.dumps(out)}", flush=True)
    return out


def _compare(result, ref, fp32: bool) -> dict:
    """The workflow outputs of one run against another: the bars of the
    sharded runs (bf16: final latents within 1e-2 relative RMS, every frame
    >= 40 dB, masks equal on >= 99.5% of the pixels; fp32: trajectory,
    final latents and reconstruction within ``_err_over_tol32`` <= 1,
    masks equal, frames within one level) and what they are made of."""
    import torch

    psnr = _psnr_frames(result["video"], ref["video"])
    out = dict(latents_rel_rms=_rel_rms(result["out"], ref["out"]),
               inversion_rel_rms=_rel_rms(result["traj"][-1], ref["traj"][-1]),
               reconstruction_rel_rms=_rel_rms(result["rec"], ref["rec"]),
               frame_psnr_db_min=min(psnr),
               masks_equal=(result["masks"] == ref["masks"]).float().mean().item())
    if fp32:
        out["err_over_tol32"] = {k: _err_over_tol32(result[k], ref[k])
                                 for k in ("traj", "out", "rec")}
        out["traj_rel_rms_by_step"] = [_rel_rms(g, w) for g, w in zip(result["traj"],
                                                                      ref["traj"])]
        out["frames_max_level_diff"] = (result["video"].int()
                                        - ref["video"].int()).abs().max().item()
        out["bars_met"] = bool(max(out["err_over_tol32"].values()) <= 1.0
                               and out["frames_max_level_diff"] <= 1
                               and torch.equal(result["masks"], ref["masks"]))
    else:
        out["frame_psnr_db"] = psnr
        out["bars_met"] = bool(out["latents_rel_rms"] <= 1e-2 and min(psnr) >= 40.0
                               and out["masks_equal"] >= 0.995)
    return out


def _workflow_floor(result, ref, floor) -> dict:
    """A bf16 job's workflow against its one-card fp32 floor (the same
    workflow in fp32 from the same inputs): per output (final latents, the
    inversion's last latent, the reconstruction) the sharded run's relative
    RMS to the floor over the one-card bf16 run's (``bf16_ratio``, as the
    forward gate reads it), and the frames' PSNR against the fp32 frames."""
    out = {}
    for name, pick in (("latents", lambda r: r["out"]), ("inversion", lambda r: r["traj"][-1]),
                       ("reconstruction", lambda r: r["rec"])):
        err, base = _rel_rms(pick(result), pick(floor)), _rel_rms(pick(ref), pick(floor))
        out[name] = dict(sharded_vs_fp32=err, one_card_bf16_vs_fp32=base, bf16_ratio=err / base)
    out["frame_psnr_db_min_vs_fp32"] = dict(
        sharded=min(_psnr_frames(result["video"], floor["video"])),
        one_card_bf16=min(_psnr_frames(ref["video"], floor["video"])))
    return out


def _stage_gates(got: dict, want: dict, fp32: bool, one=None) -> dict:
    """The stage-fed outputs of a sharded run (``got``) against the one-card
    run whose stage inputs fed it (``want``: its own stage outputs). fp32:
    ``_err_over_tol32`` <= 1 (the JAX package's bar) on every latent and
    frame (the captured feature is reported: the bar is not an
    activation's). bf16 (``want`` the
    fp32 floor, ``one`` the one-card bf16 pipeline fed the same inputs):
    the sharded output's relative RMS to ``want`` over ``one``'s, at most
    ``MESH_BF16_RATIO``. Masks (the same feature on every rank): equal on
    >= 99.5% of the pixels. Each row carries ``ok``."""
    rows = {}
    for stage, keys in STAGE_OUTPUTS.items():
        for k in keys:
            g, w = got[k], want[k]
            if k == "masks":
                eq = (g == (want if fp32 else one)[k]).float().mean().item()
                row = dict(masks_equal=eq, ok=eq >= 0.995)
            elif fp32:
                # the JAX bar is a latent's (unit scale); the captured UNet
                # activation is reported, and its consumer, the masks, gated
                e = _err_over_tol32(g, w)
                row = dict(err_over_tol32=e, rel_rms=_rel_rms(g, w), gated=k != "feat",
                           ok=e <= 1.0 or k == "feat")
            else:
                err, base = _rel_rms(g, w), _rel_rms(one[k], w)
                ratio = err / base if base > 0 else (0.0 if err == 0 else float("inf"))
                row = dict(rel_rms_vs_fp32=err, one_card_bf16_rel_rms_vs_fp32=base,
                           bf16_ratio=ratio, rel_rms_vs_one_card_bf16=_rel_rms(g, one[k]),
                           ok=ratio <= MESH_BF16_RATIO)
            rows[f"{stage}:{k}"] = row
    return rows


def _forward_readings(got: dict, want: dict, fp32: bool) -> dict:
    """A sharded forward pair (``_forward_pair`` / ``_forward_pair_sd3``)
    against one card's: fp32 within ``_err_over_tol32``; for a bf16 pair
    (which also holds its fp32 forwards, ``*_fp32``) the bf16 forward's
    relative RMS distance from the one-card fp32 forward over the one-card
    bf16 forward's (``bf16_ratio``)."""
    fwd = {}
    for name in ("inversion", "injected"):
        key = name if fp32 else name + "_fp32"
        fwd[name] = dict(err_over_tol32=_err_over_tol32(got[key], want[key]))
        if not fp32:
            err, ref_err = _rel_rms(got[name], want[key]), _rel_rms(want[name], want[key])
            fwd[name].update(bf16_rel_rms=_rel_rms(got[name], want[name]),
                             bf16_vs_fp32_rel_rms=err, ref_bf16_vs_fp32_rel_rms=ref_err,
                             bf16_ratio=err / ref_err)
    return fwd


def _forward_ok(fwd: dict) -> bool:
    return all(v["err_over_tol32"] <= 1.0 and v.get("bf16_ratio", 0.0) <= MESH_BF16_RATIO
               for v in fwd.values())


def _check_mesh(job: str, result, ref, fed_ref, one_fed=None, floor=None) -> dict:
    """A sharded job against its one-process reference.

    Gated (a sharding fault fails here): the two forwards at the middle
    step (``_forward_pair``, the reference's inputs, no DDIM loop to
    amplify a rounding difference) in fp32 within ``_err_over_tol32`` <= 1
    and, for a bf16 job, in bf16: the sharded forward's relative RMS
    distance from the reference's fp32 forward at most ``MESH_BF16_RATIO``
    times the reference's own bf16 forward's (a wrong halo frame or
    exchange is far outside bf16 rounding); each stage on the one-card
    run's own inputs to it (``_stage_gates``: the fp32 reference's for an
    fp32 job, the fp32 floor's for a bf16 job); the workflow's outputs
    finite, and its masks equal on >= 99.5% of the pixels. Reported: the
    bf16 forwards' relative RMS against the reference's bf16 forwards, the
    workflow bars of ``_compare`` (their misses: ROADMAP queue 3) and, for a
    bf16 job, the workflow against its fp32 floor (``_workflow_floor``)."""
    import torch

    fp32 = (MESH_JOBS[job] if job in MESH_JOBS else SD3_MESH_JOBS[job])[1] == "fp32"
    fwd = _forward_readings(result["forward"], ref["forward"], fp32)
    wf = _compare(result, ref, fp32)
    stages = _stage_gates(result["fed"], fed_ref, fp32, one_fed)
    out = dict(job=job, forward=fwd, workflow=wf)
    if floor is not None:
        out["workflow_floor"] = _workflow_floor(result, ref, floor)
    print(f"[mesh] {json.dumps(out)}", flush=True)
    print(f"[mesh] stage-fed {job}: {json.dumps(stages)}", flush=True)
    out["stage_fed"] = stages
    if not wf["bars_met"]:
        print(f"[mesh] MISS {job}: the workflow bars are not met (ROADMAP queue 3)",
              flush=True)
    for k in ("out", "traj", "rec"):
        if not torch.isfinite(result[k].float()).all():
            raise AssertionError(f"[mesh] {job}: {k} has non-finite values")
    if not (_forward_ok(fwd) and wf["masks_equal"] >= 0.995):
        raise AssertionError(f"[mesh] {job} misses its one-process reference: {out}")
    missed = [k for k, row in stages.items() if not row["ok"]]
    if missed:
        raise AssertionError(f"[mesh] {job}: stage-fed checks missed at {missed}")
    return out


def _window_reads(rank: int, n: int, nf: int, radius: int):
    """The global frames outside rank ``rank``'s shard of ``nf`` frames that
    its keys' +/-radius windows read, and its keys' pairs."""
    f = nf // n
    o = rank * f
    reads = [g for g in (*range(o - radius, o), *range(o + f, o + f + radius)) if 0 <= g < nf]
    pairs = sum(1 for k in range(o, o + f) for b in range(-radius, radius + 1)
                if b and 0 <= k + b < nf)
    return reads, pairs


def _check_mesh_smooth(job: str, result, stats, ref, floor) -> dict:
    """``[mesh] smooth``: the smooth job's ranks against its one-card runs.

    Gated: the smoothing step alone with the VAE in fp32, on the fp32
    floor's inputs to its first smoothing step, sharded against one card
    (the bf16 run's weights in fp32 on both sides), ``_err_over_tol32`` <= 1
    stage by stage, each stage fed the one-card step's own input to it: the
    decode of x0, the smoother (with LK and with RAFT-large) on the
    one-card decoded frames, the encode and ``return_to_timestep`` of the
    one-card smoothed frames; and the whole step with RAFT-large. The whole
    step with LK is reported, not gated: LK's 2x2 solves (a determinant of
    ~1e-6 where the frames are flat) and its 1.5 px occlusion threshold
    carry the decode's fp32 rounding (err / tol ~0.4, a different conv
    algorithm per batch shape) into the smoothed frames ~700-fold (max abs
    1.8e-5 -> 1.3e-2 on the card), where the sharded smoother fed the same
    frames is bit for bit the one-card one; the sharded smoothed stylization's
    relative RMS to the floor's over the one-card bf16 one's at most
    ``MESH_BF16_RATIO``; both finite and each more than 1e-2 (max abs) from
    the unsmoothed stylization on the same inputs; per rank and smoothing
    step one ``smooth_halo`` all-to-all that brings the frames its keys
    read (2 frames of 512 x 512 x 3 fp32 = 6.29 MB on each rank of 2) and
    one flow batch of its own keys' pairs x 2 (58 of the clip's 116); K1
    10 x steps launches a rank, K2 none. Returns the ranks' launches,
    summed."""
    import torch

    _, _, px, nf, n, steps = MESH_JOBS[job]
    radius = MESH_SMOOTH["smoother_radius"]
    n_smooth = len(range(*MESH_SMOOTH["smoother_steps"]))
    got, one = result["smooth"], ref["smooth"]
    fp32 = dict(
        step={k: _err_over_tol32(got[f"step_{k}"], one[f"step_{k}"]) for k in ("lk", "raft")},
        decode=_err_over_tol32(got["px"], one["px"]),
        smoother_fed={k: _err_over_tol32(got[f"fed_sm_{k}"], one[f"sm_{k}"])
                      for k in ("lk", "raft")},
        encode_fed={k: _err_over_tol32(got[f"fed_step_{k}"], one[f"step_{k}"])
                    for k in ("lk", "raft")},
        smoother_on_own_decode={k: _err_over_tol32(got[f"sm_{k}"], one[f"sm_{k}"])
                                for k in ("lk", "raft")},
        decode_max_abs=(got["px"] - one["px"]).abs().max().item(),
        smoother_on_own_decode_max_abs={k: (got[f"sm_{k}"] - one[f"sm_{k}"]).abs().max().item()
                                        for k in ("lk", "raft")})
    err = _rel_rms(got["out"], floor["smooth_out"])
    base = _rel_rms(one["out"], floor["smooth_out"])
    diffs = dict(sharded=(got["out"] - result["fed"]["out"]).abs().max().item(),
                 one_card=(one["out"] - ref["fed"]["out"]).abs().max().item())
    frame_mb = px * px * 3 * 4 / 1e6
    ranks, launches, ok = [], {}, True
    for r, st in enumerate(stats):
        sm = st["smooth"]
        reads, pairs = _window_reads(r, n, nf, radius)
        row = dict(rank=r, smooth_halo=[dict(op=op, mb=b / 1e6) for op, b, _ in sm["halo"]],
                   want_mb=len(reads) * frame_mb,
                   smooth_halo_host_s=sum(sec for *_, sec in sm["halo"]),
                   flows_per_step=sm["flow_batches"], want_flows=2 * pairs,
                   smoothing_step_s=sm["step_s"],
                   stage_fed_halo_mb={k: [b / 1e6 for _, b in sm[f"step_{k}_halo"]]
                                      for k in ("lk", "raft")},
                   stage_fed_flows={k: sm[f"step_{k}_flow_batches"] for k in ("lk", "raft")},
                   launches=sm["launches"])
        want_halo = [("all_to_all", len(reads) * px * px * 3 * 4)]
        ok &= ([(op, b) for op, b, _ in sm["halo"]] == want_halo * n_smooth
               and all(sm[f"step_{k}_halo"] == want_halo for k in ("lk", "raft"))
               and sm["flow_batches"] == [2 * pairs] * n_smooth
               and all(sm[f"step_{k}_flow_batches"] == [2 * pairs] for k in ("lk", "raft")))
        _check_launches(sm["launches"], {"video_flash_attention": 10 * steps,
                                         "video_flash_attention_tokens": 0})
        for name, v in sm["launches"].items():
            launches[name] = launches.get(name, 0) + v
        ranks.append(row)
    out = dict(job=job, steps=steps, smoothing_steps=list(MESH_SMOOTH["smoother_steps"]),
               radius=radius, flow="lk",
               smoothing_step_fp32_err_over_tol32=fp32,
               stylize=dict(sharded_rel_rms_vs_fp32=err, one_card_bf16_rel_rms_vs_fp32=base,
                            bf16_ratio=err / base,
                            rel_rms_vs_one_card_bf16=_rel_rms(got["out"], one["out"])),
               max_abs_diff_vs_unsmoothed=diffs,
               one_card_smoothing_step_s=one["step_s"], ranks=ranks)
    print(f"[mesh] smooth {json.dumps(out)}", flush=True)
    finite = all(torch.isfinite(x).all() for x in (got["out"], one["out"]))
    if not (finite and min(diffs.values()) > 1e-2):
        raise AssertionError(f"[mesh] smooth: non-finite or unsmoothed latents ({diffs})")
    if not ok:
        raise AssertionError(f"[mesh] smooth: the census is not the halo design: {ranks}")
    gated = [fp32["decode"], *fp32["smoother_fed"].values(), *fp32["encode_fed"].values(),
             fp32["step"]["raft"]]
    if not (max(gated) <= 1.0 and err / base <= MESH_BF16_RATIO):
        raise AssertionError(f"[mesh] smooth misses one card: fp32 {fp32}, "
                             f"bf16 ratio {err / base}")
    return launches


def phase_mesh():
    """Frame parallelism on the one card, its kernels: K1's shard form (three
    shapes, a planted slot-table fault) and K2's (also at a tensor rank's
    share of the heads, with a planted slot-table fault). ``main`` then
    runs the ``MESH_JOBS`` (``_mesh_jobs``): the SD-1.5 workflow in bf16 at
    full width over 2 ranks, in fp32 at 256 px over 2 and 4 ranks, and
    AnimateDiff-v2 in bf16 at full width over 2 ranks, each against a
    one-card run at the same steps. The ranks time-slice the card over gloo
    (which stages every collective through host memory): the times are not
    a speed measurement."""
    import torch

    bf = torch.bfloat16
    k1 = [
        _vfa_shard_case(2, 16, 2, 1, 8, 4096, 40, (-1, 0, "first"), bf, plant=True),
        _vfa_shard_case(2, 16, 2, 1, 8, 4096, 40, (-1, "first"), bf),
        _vfa_shard_case(2, 16, 4, 2, 8, 4096, 40, (-1, 0, "first"), bf),
        _vfa_shard_case(2, 16, 2, 1, 8, 1024, 80, (-1, 0, "first"), bf),
    ]
    sd3 = ("first", -1, 0)
    k2 = [_vfa_tokens_shard_case(1, 16, 2, 1, 24, 4429, 4096, 64, sd3, bf, 333),
          # a data x tensor rank: data rank 1 of 2, its tensor share of the
          # heads (SD3-M / SD3.5-M: 12 of 24; SD3.5-L: 19 of 38 at tensor=2)
          _vfa_tokens_shard_case(1, 16, 2, 1, 12, 4429, 4096, 64, sd3, bf, 333, plant=True),
          _vfa_tokens_shard_case(1, 16, 2, 1, 19, 4429, 4096, 64, sd3, bf, 333)]
    torch.cuda.empty_cache()
    return k1, k2


def _mesh_jobs() -> dict:
    """The ``[mesh]`` jobs of ``MESH_JOBS`` with their one-card runs; returns
    the kernel launches of the sharded workflows (``mesh``) and of the
    sharded smoothed stylization (``mesh_smooth``), summed over ranks.

    A bf16 job's one-card runs: its floor (the workflow in fp32 from the
    same inputs), whose stage inputs feed the stage-fed checks, and the
    workflow in bf16 (the reference of the sharded run), whose pipeline
    also runs each stage on the floor's stage inputs. The fp32 jobs share
    one one-card fp32 run, whose own stage inputs feed their checks, with
    the encode's batch-shape floor beside it. ``MESH_SMOOTH_JOB``'s runs
    also stylize with the smoother (``_check_mesh_smooth``)."""
    os.makedirs(os.path.join(REPO, "results"), exist_ok=True)
    launches = {"video_flash_attention": 0, "video_flash_attention_tokens": 0}
    refs = {}
    smooth_launches = dict(launches)
    for job, (backbone, dtype_name, px, nf, n, steps) in MESH_JOBS.items():
        t0 = time.time()
        smooth = job == MESH_SMOOTH_JOB

        def prepare():
            if dtype_name == "bf16":
                floor = _one_process(backbone, "fp32", px, nf, steps, f"mesh {job} fp32 floor",
                                     forward=False, encode_parts=(2,) if backbone == "sd" else (),
                                     smooth=smooth)
                ref = _one_process(backbone, "bf16", px, nf, steps, f"mesh {job} one card",
                                   fed=floor, smooth=smooth)
                fed_ref, one_fed = floor, ref["fed"]
                if smooth:
                    fed_ref = dict(floor, smooth_ref={k: ref["smooth"][k] for k in (
                        "px", "sm_lk", "sm_raft", "step_lk", "step_raft")})
            else:
                key = (backbone, px, nf, steps)
                if key not in refs:
                    refs[key] = _one_process(backbone, "fp32", px, nf, steps,
                                             f"mesh {job} one card", encode_parts=(2, 4))
                ref = fed_ref = refs[key]
                floor = one_fed = None
            return ref["probe"], fed_ref, (ref, fed_ref, one_fed, floor)

        result, stats, (ref, fed_ref, one_fed, floor) = _run_mesh_job(job, steps, prepare)
        forwards = 3 * steps  # inversion, reconstruction, stylization: one a step
        per_forward = 0 if backbone == "ad" else (10 if px == 512 else 5)
        for st in stats:
            _check_launches(st["launches"], {"video_flash_attention": per_forward * forwards,
                                             "video_flash_attention_tokens": 0})
            for name in launches:
                launches[name] += st["launches"][name]
        _check_mesh(job, result, ref, fed_ref, one_fed, floor)
        if smooth:
            smooth_launches = _check_mesh_smooth(job, result, stats, ref, floor)
        print(f"[mesh] {job}: one-card runs, job and checks in {time.time() - t0:.1f}s",
              flush=True)
    return {"mesh": launches, "mesh_smooth": smooth_launches}


def _build_sd3_pipe(variant: str, dtype_name: str, nf: int):
    import torch

    from univst_torch.pipelines.sd3 import SD3VideoPipeline

    dtype = torch.bfloat16 if dtype_name == "bf16" else torch.float32
    return SD3VideoPipeline.build(variant=variant, num_frames=nf, dtype=dtype,
                                  capture_block=SD3_CAPTURE[0], seed=0, device="cuda")


def _sd3_prompt(pipe):
    """The empty prompt's (context, pooled), then the text encoders freed
    (T5-XXL: 9.5 GB in bf16)."""
    out = pipe.encode_prompt("")
    pipe.free_text_encoders()
    return out


def _stylize_sd3(pipe, traj, straj, ctx, pooled, masks, steps: int):
    """The SD3 workflow's stylization (``phase_sd3``'s): from the per-frame
    AdaIN-shifted content noise, the singleton style, the mask."""
    import torch

    from univst_torch.core.adain import latent_adain_sd3
    from univst_torch.core.config import StyleTransferConfig

    content_rev = torch.flip(traj, dims=[0])
    style_rev = torch.flip(straj, dims=[0])[:, :1]
    init = latent_adain_sd3(content_rev[0], style_rev[0])
    return pipe.stylize_latents(content_rev, style_rev, init, content_rev[-1],
                                torch.cat([ctx] * 3), torch.cat([pooled] * 3),
                                mask=masks.float() / 255.0,
                                cfg=StyleTransferConfig(num_steps=steps))


def _workflow_sd3(pipe, steps: int, nf: int, px: int, tag: str, prompt) -> dict:
    """The SD3 workflow after the prompt (``prompt``: its context and pooled
    embedding) on the demo corpus: VAE encode, RF-Solver content inversion
    with the block-20 feature captured at step 5 (the last step of a
    shorter run), single-frame style inversion, mask propagation,
    stylization, chunked decode, reconstruction; with each stage's seconds,
    peak device memory and, under a mesh, collectives; the tensors under
    ``_workflow``'s names (``ctx`` and ``pooled`` the prompt's)."""
    import torch

    from univst_torch.distributed.census import collect_collectives, summarize

    device = pipe.device
    frames, style, mask0 = _load_inputs(nf, px)
    gen = torch.Generator(device=device).manual_seed(0)
    ctx, pooled = prompt
    cap = min(SD3_CAPTURE[1], steps - 1)
    stage, peak, census = {}, {}, {}

    def run(name, fn):
        torch.cuda.reset_peak_memory_stats()
        t = time.time()
        with collect_collectives() as recs:
            out = fn()
            _sync()
        stage[name] = time.time() - t
        peak[name] = torch.cuda.max_memory_allocated() / 1e9
        census[name] = summarize(recs, by_site=True)
        print(f"[{tag}] {name}: {stage[name]:.2f}s, peak {peak[name]:.2f} GB", flush=True)
        return out

    t_main = time.time()
    latents = run("encode", lambda: pipe.encode_frames(frames, gen))
    traj, feat = run("content_inversion", lambda: pipe.invert(
        latents, ctx, pooled, num_steps=steps, is_rf_solver=True, capture_step=cap))
    spipe = pipe.with_frames(1)

    def style_inversion():
        slat = spipe.encode_frames(style, gen)
        return slat, spipe.invert(slat, ctx, pooled, num_steps=steps, is_rf_solver=True)[0]

    slatents, straj = run("style_inversion", style_inversion)
    masks = run("mask_propagation", lambda: _propagate(feat, mask0, device))
    out = run("stylize", lambda: _stylize_sd3(pipe, traj, straj, ctx, pooled, masks, steps))
    video = run("decode", lambda: pipe.decode_latents_uint8(out, chunk=4))
    rec = run("reconstruction", lambda: pipe.reconstruct_latents(
        traj[-1], latents, ctx, pooled, num_steps=steps))
    return dict(latents=latents, slatents=slatents, ctx=ctx, pooled=pooled, traj=traj,
                feat=feat, straj=straj, masks=masks, out=out, video=video, rec=rec,
                stage=stage, peak=peak, census=census, main_s=time.time() - t_main)


def _stage_fed_sd3(pipe, steps: int, nf: int, px: int, fed: dict) -> dict:
    """``_stage_fed`` for the SD3 workflow (``_workflow_sd3``'s stages)."""
    import torch

    device = pipe.device
    frames, style, mask0 = _load_inputs(nf, px)
    gen = torch.Generator(device=device).manual_seed(0)
    spipe = pipe.with_frames(1)

    def inp(k):
        return fed[k].to(device)

    ctx, pooled = inp("ctx"), inp("pooled")
    res = dict(latents=pipe.encode_frames(frames, gen), slatents=spipe.encode_frames(style, gen))
    res["traj"], res["feat"] = pipe.invert(inp("latents"), ctx, pooled, num_steps=steps,
                                           is_rf_solver=True,
                                           capture_step=min(SD3_CAPTURE[1], steps - 1))
    res["straj"] = spipe.invert(inp("slatents"), ctx, pooled, num_steps=steps,
                                is_rf_solver=True)[0]
    res["masks"] = _propagate(inp("feat"), mask0, device)
    res["out"] = _stylize_sd3(pipe, inp("traj"), inp("straj"), ctx, pooled, inp("masks"), steps)
    res["frames"] = pipe.decode_latents(inp("out"), chunk=4)
    res["rec"] = pipe.reconstruct_latents(inp("traj")[-1], inp("latents"), ctx, pooled,
                                          num_steps=steps)
    _sync()
    return {k: v.cpu() for k, v in res.items()}


def _probe_sd3(pipe, w: dict, steps: int) -> dict:
    """``_probe_inputs`` for SD3: the content latents and the style latent
    at the middle step, the prompt, the step and its flow time."""
    i = steps // 2
    mu = pipe._mu(*w["latents"].shape[1:3])
    sigma = float(pipe.schedule.sigmas(steps, mu=mu)[i])
    return dict(i=i, t=sigma * pipe.schedule.cfg.num_train_timesteps, z=w["traj"][i].cpu(),
                sty=w["straj"][i].cpu(), ctx=w["ctx"].cpu(), pooled=w["pooled"].cpu())


def _forward_pair_sd3(pipe, probe: dict) -> dict:
    """``_forward_pair`` for SD3: two MMDiT forwards on the same inputs, the
    inversion's (B = 1) and the injected 2-branch stylization forward, the
    style K/V captured by the single-frame forward of the style latent (as
    ``_stylize2_segment`` runs them); in the pipeline's type and, for a bf16
    pipeline, with the MMDiT in fp32 (``*_fp32``; back in bf16 after, bit
    for bit). Under a mesh each runs on the rank's frames and its tensor
    share of the heads; the velocities come back gathered, on the host."""
    import torch

    from univst_torch.core.config import SD3_STYLE_SHIFT
    from univst_torch.distributed.mesh import gather_frames
    from univst_torch.models.layers import StyleCtx, VideoCtx
    from univst_torch.models.mmdit import extract_mmdit_style_kv

    i, t = probe["i"], probe["t"]
    dev = pipe.device
    ctx, pooled = probe["ctx"].to(dev), probe["pooled"].to(dev)
    z, sty = pipe._shard(probe["z"].to(dev)), probe["sty"].to(dev)
    shard = pipe._frame_shard()

    def whole(x):
        x = x.reshape((-1, z.shape[0]) + x.shape[1:])
        return (x if shard is None else gather_frames(x, pipe.mesh, axis=1)).float().cpu()

    def pair(p):
        with torch.inference_mode():
            v1 = p._denoise_fn(ctx, pooled, None)(z, t, i)[0]
            cap = StyleCtx(step_idx=i, cfg=SD3_STYLE_SHIFT, capture=True)
            c1, p1 = p._cast(ctx, pooled)
            p.mmdit(sty.to(p.dtype), t, c1, p1, VideoCtx(num_frames=1, frame_indices=()), cap)
            sctx = StyleCtx(step_idx=i, cfg=SD3_STYLE_SHIFT,
                            style_kv=extract_mmdit_style_kv(cap.captured))
            c2, p2 = p._cast(torch.cat([ctx, ctx]), torch.cat([pooled, pooled]))
            v2, _ = p.mmdit(torch.cat([z, z]).to(p.dtype), t, c2, p2, p._video_ctx(), sctx)
        _sync()
        return whole(v1), whole(v2)

    out = dict(zip(("inversion", "injected"), pair(pipe)))
    if pipe.dtype != torch.float32:
        pipe.mmdit.float()
        out.update(zip(("inversion_fp32", "injected_fp32"),
                       pair(dataclasses.replace(pipe, dtype=torch.float32))))
        pipe.mmdit.to(pipe.dtype)
    return out


def _one_process_sd3(variant: str, dtype_name: str, px: int, nf: int, steps: int, tag: str,
                     forward: bool = True, fed=None) -> dict:
    """``_one_process`` for an SD3 job."""
    import torch

    pipe = _build_sd3_pipe(variant, dtype_name, nf)
    w = _workflow_sd3(pipe, steps, nf, px, tag, _sd3_prompt(pipe))
    out = {k: w[k].cpu() for k in WF_KEYS + ("pooled",)}
    out["frames"] = pipe.decode_latents(w["out"], chunk=4).cpu()
    out["probe"] = _probe_sd3(pipe, w, steps)
    if forward:
        out["forward"] = _forward_pair_sd3(pipe, out["probe"])
    if fed is not None:
        out["fed"] = _stage_fed_sd3(pipe, steps, nf, px, fed)
    del pipe, w
    torch.cuda.empty_cache()
    return out


def _sd3_mesh_rank(rank: int, n: int, out_dir: str, job: str, steps: int):
    """One rank of an SD3 ``[mesh]`` job (``SD3_MESH_JOBS``): as
    ``_mesh_rank``, on a ``data x tensor`` mesh. The ranks build one at a
    time, each encoding the prompt and freeing its text encoders before the
    next builds (four T5-XXL copies would not fit beside the rest), then
    ``with_mesh`` replicates the MMDiT and the VAE and splits the MMDiT
    over the tensor axis. Gated here: the K2 launches of the workflow."""
    import torch
    import torch.distributed as dist

    variant, dtype_name, px, nf, _, n_tensor, _ = SD3_MESH_JOBS[job]
    mesh = _rank_mesh(rank, n, out_dir, n_tensor)
    build_s = 0.0
    for turn in range(n):
        if turn == rank:
            t0 = time.time()
            pipe = _build_sd3_pipe(variant, dtype_name, nf)
            prompt = _sd3_prompt(pipe)
            _sync()
            build_s = time.time() - t0
        dist.barrier()
    t0 = time.time()
    pipe = pipe.with_mesh(mesh)
    _sync()
    replicate_s = time.time() - t0
    counters = _zero_counters()
    w = _workflow_sd3(pipe, steps, nf, px, f"mesh {job} r{rank}", prompt)
    launches = {name: fn.launches for name, fn in counters.items()}
    cfg = pipe.mmdit.cfg
    per_forward = cfg.num_layers + len(cfg.dual_attention_layers)
    _check_launches(launches, {"video_flash_attention": 0,
                               "video_flash_attention_tokens": per_forward * 4 * steps})
    by_op = _census_by_op(w["census"])
    stats = dict(job=job, rank=rank, ranks=n, data_rank=mesh.data_rank,
                 tensor_rank=mesh.tensor_rank, steps=steps, build_s=build_s,
                 replicate_s=replicate_s, stage_s=w["stage"], main_path_s=w["main_s"],
                 census_by_stage=w["census"],
                 # RF-Solver: two forwards a step
                 census_per_inversion_forward={
                     key: dict(count=c["count"] / (2 * steps), mb=c["mb"] / (2 * steps))
                     for key, c in w["census"]["content_inversion"].items()
                     if not key.endswith(":outputs") and not key.startswith("broadcast")},
                 collectives_by_op=by_op, k2_launches_per_forward=per_forward,
                 peak_mem_gb_by_stage=w["peak"], peak_mem_gb=max(w["peak"].values()),
                 launches=launches)
    print(f"[mesh] {json.dumps(stats)}", flush=True)
    torch.save(stats, os.path.join(out_dir, f"stats{rank}.pt"))
    fed_in = _await_fed(out_dir)
    forward = _forward_pair_sd3(pipe, fed_in["probe"])
    t0 = time.time()
    fed = _stage_fed_sd3(pipe, steps, nf, px, fed_in)
    print(f"[mesh] {job} r{rank}: stage-fed stages in {time.time() - t0:.1f}s", flush=True)
    if rank == 0:
        result = {k: w[k].cpu() for k in WF_KEYS}
        torch.save(dict(result, forward=forward, fed=fed), os.path.join(out_dir, "result.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _census_by_op(census_by_stage: dict) -> dict:
    """A workflow's collectives summed over its stages and sites, by op."""
    by_op = {}
    for c in census_by_stage.values():
        for key, v in c.items():
            s = by_op.setdefault(key.split(":")[0], dict(count=0, mb=0.0, host_ms=0.0))
            for k in s:
                s[k] += v[k]
    return by_op


def phase_mesh_sd3() -> dict:
    """SD3 on a ``data x tensor`` mesh of gloo ranks sharing the card
    (``SD3_MESH_JOBS``): SD3-medium over 2 data ranks and SD3.5-medium over
    2 x 2, bf16 at 512 px, each with its one-card bf16 run and fp32 floor,
    gated as the ``[mesh]`` jobs are (``_check_mesh``). Returns the K2
    launches of the sharded workflows, summed over ranks."""
    launches = {"video_flash_attention": 0, "video_flash_attention_tokens": 0}
    for job, (variant, _, px, nf, _, _, steps) in SD3_MESH_JOBS.items():
        t0 = time.time()

        def prepare():
            floor = _one_process_sd3(variant, "fp32", px, nf, steps, f"mesh {job} fp32 floor",
                                     forward=False)
            ref = _one_process_sd3(variant, "bf16", px, nf, steps, f"mesh {job} one card",
                                   fed=floor)
            print(f"[mesh] {job}: floor and one-card runs in {time.time() - t0:.1f}s "
                  "(beside the ranks)", flush=True)
            return ref["probe"], floor, (ref, floor)

        result, stats, (ref, floor) = _run_mesh_job(job, steps, prepare)
        for st in stats:
            for name in launches:
                launches[name] += st["launches"][name]
        _check_mesh(job, result, ref, floor, ref["fed"], floor)
        print(f"[mesh] {job}: one-card runs, job and checks in {time.time() - t0:.1f}s",
              flush=True)
    return launches


def _mmdit_pipe(dtype, device="cuda"):
    """``SD3_TP_FORWARD``'s pipeline: an ``SD3VideoPipeline`` that holds only
    the MMDiT, its depth cut, with seed-0 weights (``random_init_``, as the
    pipeline's build draws them); enough for ``_forward_pair_sd3``."""
    import torch

    from univst_torch.core.scheduler import FlowMatchConfig, FlowMatchSchedule
    from univst_torch.models.mmdit import MMDiT
    from univst_torch.pipelines.sd import random_init_
    from univst_torch.pipelines.sd3 import SD3VideoPipeline, _configs

    job = SD3_TP_FORWARD
    cfg = dataclasses.replace(_configs(job["variant"], None)[0], num_layers=job["layers"])
    with torch.device(device):
        mmdit = MMDiT(cfg)
    random_init_(mmdit, torch.Generator(device=device).manual_seed(0))
    mmdit.to(dtype).eval().requires_grad_(False)
    return SD3VideoPipeline(mmdit=mmdit, vae=None, clip_l=None, clip_g=None, t5=None,
                            tokenizer=None, tokenizer_3=None,
                            schedule=FlowMatchSchedule(FlowMatchConfig()), num_frames=job["nf"],
                            device=torch.device(device), dtype=dtype)


def _mmdit_probe(pipe) -> dict:
    """Seeded inputs of ``_forward_pair_sd3`` at ``SD3_TP_FORWARD``'s size:
    latents of ``nf`` frames, one style frame, a context of 333 rows (T5's
    256 and CLIP's 77) and a pooled embedding, the probe step's flow time."""
    import numpy as np
    import torch

    job, cfg = SD3_TP_FORWARD, pipe.mmdit.cfg
    steps, i, h = job["steps"], job["steps"] // 2, job["px"] // 8
    sigma = float(pipe.schedule.sigmas(steps, mu=pipe._mu(h, h))[i])
    rng = np.random.default_rng(0)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))

    return dict(i=i, t=sigma * pipe.schedule.cfg.num_train_timesteps,
                z=draw(job["nf"], h, h, cfg.in_channels), sty=draw(1, h, h, cfg.in_channels),
                ctx=draw(1, 333, cfg.joint_attention_dim),
                pooled=draw(1, cfg.pooled_projection_dim))


def _sd3_tp_forward_rank(rank: int, n: int, out_dir: str, probe: dict):
    """One rank of ``SD3_TP_FORWARD``: the MMDiT pipeline replicated from
    rank 0 and split over the tensor axis, the forward pair on ``probe``;
    each rank writes its heads, K2 launches and collectives, rank 0 also
    the (gathered) velocities."""
    import torch
    import torch.distributed as dist

    from univst_torch.distributed.census import collect_collectives, summarize
    from univst_torch.models.mmdit import JointAttention

    mesh = _rank_mesh(rank, n, out_dir, SD3_TP_FORWARD["tensor"])
    pipe = _mmdit_pipe(torch.bfloat16).with_mesh(mesh)
    counters = _zero_counters()
    with collect_collectives() as recs:
        forward = _forward_pair_sd3(pipe, probe)
    stats = dict(rank=rank, tensor_rank=mesh.tensor_rank,
                 heads=sorted({m.num_heads for m in pipe.mmdit.modules()
                               if isinstance(m, JointAttention)}),
                 launches={name: fn.launches for name, fn in counters.items()},
                 census=summarize(recs, by_site=True))
    print(f"[mesh_sd3 tp] {json.dumps(stats)}", flush=True)
    torch.save(stats, os.path.join(out_dir, f"stats{rank}.pt"))
    if rank == 0:
        torch.save(forward, os.path.join(out_dir, "result.pt"))
    dist.barrier()
    dist.destroy_process_group()


def phase_sd3_tp_forward() -> dict:
    """``SD3_TP_FORWARD`` gated as the ``[mesh]`` forward pairs are
    (``_check_mesh``): the sharded fp32 forwards within ``_err_over_tol32``
    <= 1 of the one-card ones, the bf16 ones within ``MESH_BF16_RATIO`` of
    the one-card bf16 distance from fp32; each rank's heads ``share``'s
    (10, 10, 9, 9), its K2 launches 4 x layers (the inversion and injected
    forwards in bf16 and in fp32), the same all-reduce bytes on every rank.
    Returns the ranks' launches, summed."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from univst_torch.distributed.tp import share

    job = SD3_TP_FORWARD
    n = job["data"] * job["tensor"]
    t0 = time.time()
    pipe = _mmdit_pipe(torch.bfloat16)
    probe, num_heads = _mmdit_probe(pipe), pipe.mmdit.cfg.num_heads
    ref = _forward_pair_sd3(pipe, probe)
    del pipe
    torch.cuda.empty_cache()
    os.makedirs(os.path.join(REPO, "results"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "results")) as out_dir:
        mp.spawn(_sd3_tp_forward_rank, args=(n, out_dir, probe), nprocs=n, join=True)
        stats = [torch.load(os.path.join(out_dir, f"stats{r}.pt"), weights_only=False)
                 for r in range(n)]
        got = torch.load(os.path.join(out_dir, "result.pt"), weights_only=False)
    fwd = _forward_readings(got, ref, fp32=False)
    heads = [st["heads"] for st in stats]
    want_heads = [[len(range(num_heads)[share(num_heads, job["tensor"], st["tensor_rank"])])]
                  for st in stats]
    reduces = [{k: v["mb"] for k, v in st["census"].items() if k.startswith("all_reduce")}
               for st in stats]
    out = dict(job=job, forward=fwd, heads=heads, all_reduce_mb=reduces[0],
               seconds=time.time() - t0)
    print(f"[mesh_sd3 tp] {json.dumps(out)}", flush=True)
    if not _forward_ok(fwd):
        raise AssertionError(f"[mesh_sd3 tp] misses the one-card forward: {out}")
    if heads != want_heads or any(r != reduces[0] for r in reduces):
        raise AssertionError(f"[mesh_sd3 tp] heads {heads} (want {want_heads}) or "
                             f"all-reduce MB differ by rank: {reduces}")
    launches = {"video_flash_attention": 0, "video_flash_attention_tokens": 0}
    for st in stats:
        _check_launches(st["launches"], {"video_flash_attention": 0,
                                         "video_flash_attention_tokens": 4 * job["layers"]})
        for name in launches:
            launches[name] += st["launches"][name]
    return launches


def _entry(name, replaces, launches, cases, main_case):
    return dict(name=name, route="cuda", source=SOURCE, replaces=replaces, launches=launches,
                max_abs_err=max(c["max_abs_err"] for c in cases if c["dtype"] == "bfloat16"),
                err_over_tol=max(c["err_over_tol"] for c in cases),
                planted_err_over_tol=main_case["planted_err_over_tol"],
                ms=main_case["ms"], plain_ms=main_case["plain_ms"],
                bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
                bound_unit=main_case["bound_unit"], library_ms=main_case["library_ms"],
                shape=main_case["shape"], cases=cases)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=30, help="SD-1.5 steps (>= 27: both phases)")
    p.add_argument("--ad_steps", type=int, default=30,
                   help="AnimateDiff steps (>= 26: both phases)")
    p.add_argument("--sd3_steps", type=int, default=32,
                   help="SD3-medium steps (>= 32: both phases)")
    p.add_argument("--sd35l_steps", type=int, default=4,
                   help="SD3.5-large steps (>= 32: both phases; 4 runs the 2-branch phase)")
    args = p.parse_args(argv)
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: PyTorch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the GPU port only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        import univst_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.time()

    def clock(name, fn, *a):
        t0 = time.time()
        out = fn(*a)
        print(f"[clock] {name}: {time.time() - t0:.1f}s (script {time.time() - t_start:.1f}s)",
              flush=True)
        return out

    smi = clock("device", phase_device)
    clock("build", phase_build)
    cases, tokens = clock("kernels", phase_kernels)
    sd_launches, sd_state, main_run = clock("main", phase_main_path, args.steps)
    bench_launches = clock("bench", phase_bench, sd_state, main_run, args.steps)
    fallback_launches = clock("sd_fallback", phase_sd_fallback, sd_state, args.steps)
    clock("sd_linear_betas", phase_sd_linear_betas, sd_state, args.steps)
    clock("lk", phase_lk_shift)
    smooth_launches, smooth_frames = clock("smooth", phase_smooth, sd_state, args.steps)
    profile_launches = clock("profile_sd", phase_profile_sd, sd_state, args.steps)
    stages_launches, stages = clock("stages", phase_stages, sd_state)
    anatomy_launches = clock("anatomy", phase_anatomy, sd_state, stages)
    clock("compare", phase_compare, main_run)
    weights_launches, weights_dir = clock("weights_day", phase_weights_day, sd_state,
                                          args.steps)
    del sd_state, main_run
    torch.cuda.empty_cache()
    try:
        sd21_launches = clock("sd21", phase_main_path, args.steps, "sd21", "sd21")[0]
        torch.cuda.empty_cache()
        clock("raft", phase_raft, smooth_frames)
        del smooth_frames
        torch.cuda.empty_cache()
        clock("ad", phase_ad, args.ad_steps)
        torch.cuda.empty_cache()
        recipe = start_recipe(os.path.join(weights_dir, "sd"))
        try:
            sd3_launches, sd3_state = clock("sd3", phase_sd3, "sd3", args.sd3_steps)
            clock("recipe", phase_recipe, recipe)
        finally:
            if recipe[0].poll() is None:
                recipe[0].kill()
                recipe[0].wait()
    finally:
        shutil.rmtree(weights_dir, ignore_errors=True)
    sd3_launches = {"sd3": sd3_launches,
                    "sd3_anatomy": clock("sd3_anatomy", phase_sd3_anatomy, sd3_state)}
    del sd3_state
    torch.cuda.empty_cache()
    sd3_launches["sd35m"], sd35m_state = clock("sd35m", phase_sd3, "sd35m", SD35M_STEPS)
    for k, v in clock("profile_sd35m", phase_profile_sd35m, sd35m_state).items():
        profile_launches[k] += v
    del sd35m_state
    torch.cuda.empty_cache()
    sd3_launches["sd35l"], _ = clock("sd35l", phase_sd3, "sd35l", args.sd35l_steps)
    torch.cuda.empty_cache()
    shard_cases, shard_tokens = clock("mesh_kernels", phase_mesh)
    mesh_launches = clock("mesh", _mesh_jobs)
    torch.cuda.empty_cache()
    mesh_sd3_launches = clock("mesh_sd3", phase_mesh_sd3)
    mesh_sd3_tp_launches = clock("mesh_sd3_tp", phase_sd3_tp_forward)

    k1_paths = {"sd": sd_launches, "sd21": sd21_launches, "bench": bench_launches,
                "sd_fallback": fallback_launches, "weights_day": weights_launches,
                "smooth": smooth_launches, "profile": profile_launches,
                "stages": stages_launches, "anatomy": anatomy_launches, **mesh_launches}
    k1_paths = {k: v["video_flash_attention"] for k, v in k1_paths.items()}
    k2_paths = dict(sd3_launches, profile=profile_launches, **mesh_launches,
                    mesh_sd3=mesh_sd3_launches, mesh_sd3_tp=mesh_sd3_tp_launches)
    k2_paths = {k: v["video_flash_attention_tokens"] for k, v in k2_paths.items()}
    entries = [
        dict(_entry("video_flash_attention", TPU_KERNEL, sum(k1_paths.values()),
                    cases + shard_cases, cases[0]), launches_by_path=k1_paths),
        dict(_entry("video_flash_attention_tokens", TPU_KERNEL_FOLDED, sum(k2_paths.values()),
                    tokens + shard_tokens, tokens[0]), launches_by_path=k2_paths),
    ]
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
