#!/usr/bin/env python3
"""Drive the PyTorch port's SD-1.5, AnimateDiff-v2 and SD3 workflows on one
NVIDIA GPU.

    python3 chip_smoke.py [--steps N] [--ad_steps N] [--sd3_steps N]

Run from the root of a checkout, on a machine with a CUDA card. Phases, each
ending in ``torch.cuda.synchronize()`` so a fault surfaces where it happens;
none catches its own failure:

1. Device: the card's name and power limit (nvidia-smi), torch/CUDA versions.
2. Build: compiles every kernel source of ``univst_torch/csrc`` with nvcc
   (sm_90a), one nvcc per source, all started together.
3. Kernels against their plain PyTorch versions, in bf16 at the shapes the
   main paths give them (and small ragged bf16 and fp32 cases each):
   the error against a tolerance that follows the output's scale
   (``_err_over_tol``), a planted fault per kernel that the same check must
   reject, kernel / plain / library times (CUDA events) and the card's
   least time for the work (bound: the largest of tensor-core FLOPs, the
   exponentials on the MUFU and the FMA pipe together, and bytes, from
   ``univst_torch.attention.video_flash.work``; each term on a ``[bound]``
   line). K1 is the head-major video flash attention of the SD UNet, K2 the
   token-major one of the SD3 MMDiT.
4. SD-1.5 path: ``SDVideoPipeline`` (SD-1.5 widths, 512 px, 16 frames,
   bf16, seeded random weights) through content inversion with feature
   capture, single-frame style inversion, mask propagation, stylization
   (style pre-pass, injected 2-branch phase, stylized-only phase) and the
   chunked temporal-VAE decode, plus the inversion -> reconstruction round
   trip. K1 must launch 10 times per 16-frame UNet forward, K2 never.
5. SD-1.5 fallback: the same pipeline and trajectories, stylized once off
   the style-singleton path (capture-and-inject, what the transfer CLI
   falls back to on a style trajectory whose frames differ), with the
   content trajectory as the style. Per phase-1 step a 16-frame capture
   forward and the injected 2-branch forward, per phase-2 step one
   forward: K1 must launch 10 x (2 k1 + (n - k1)) times (k1 = the shift
   window's end, 26 of 30 steps: 560), K2 never; the latents finite.
6. AnimateDiff-v2 path: ``build_animatediff`` at full width (the SD-1.5 2D
   UNet, 21 motion modules of 8 heads with a 24-frame position table, SVD
   VAE, CLIP-L; bf16, seeded random weights, every motion module's
   ``proj_out`` filled from seed 1 so the temporal path reaches the
   result), 512 px, 16 frames: content inversion with EasyInv and the
   feature captured, 16-frame style inversion, mask propagation,
   capture-and-inject stylization from the raw content noise, chunked
   decode, inversion -> reconstruction round trip. This backbone builds no
   cross-frame K/V: K1 and K2 must launch 0 times.
7. SD3 path: ``SD3VideoPipeline`` at SD3-medium widths (24 blocks, 24 heads
   of 64, T5-XXL, CLIP-L and CLIP-G; bf16, seeded random weights), 1024 px,
   16 frames: prompt encoding (then the text encoders are freed), VAE
   encode, RF-Solver content inversion with the block-20 feature captured
   at step 5, single-frame style inversion, mask propagation on that
   feature, stylization (style-singleton 2-branch phase, then the
   stylized-only phase), decode and the controlled-velocity
   reconstruction. K2 must launch 24 x (2 + 1 + 1) = 96 times per step
   (inversion's two forwards, the reconstruction, one stylization forward;
   single-frame forwards run no video attention), K1 never.

Each path's launch counters are zeroed just before it and read just after.
The last line is ``{"ok": true, "device": {...}}``; the lines before it hold
the per-kernel JSON and the card's name and power limit. Any failed check
exits non-zero. ``--steps`` (SD-1.5) and ``--ad_steps`` default to 30 and
``--sd3_steps`` to 32: the fewest that run both stylization phases (the
shift windows of the 50-step constants close after step 25 (SD), 24 (AD)
and 30 (SD3)); 50 is the full workload.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
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


def _err_over_tol(got, want) -> float:
    """``max |got - want| / (atol + rtol * |want|)``: the check passes at <= 1.

    bf16: rtol 2**-6 is two bf16 ulps (both sides round an fp32 result to
    bf16, and the kernel packs P to bf16 for the PV product); atol is 0.02 x
    the plain output's rms, for elements near zero. With N(0, 1) inputs that
    rms is about sqrt(e / keys) (0.015 at the 64x64 level), so the bar follows
    the shape. fp32: 1e-5 absolute and relative (the same arithmetic up to
    summation order).
    """
    import torch

    if want.dtype == torch.bfloat16:
        want = want.float()
        atol, rtol = 0.02 * want.pow(2).mean().sqrt().item(), 2.0**-6
    else:
        atol, rtol = 1e-5, 1e-5
    diff = (got.float() - want).abs()
    if not torch.isfinite(diff).all():
        return float("inf")
    return (diff / (atol + rtol * want.abs())).max().item()


def _vfa_case(b, f, h, l, dh, idx, dtype, lq=None, lc=None, ctx_valid=None, reps=5,
              plant=False):
    """Kernel vs plain (and SDPA on the expanded K/V) on one shape. With
    ``plant``, also run the kernel with the scale of the padded depth (a
    plausible fault) and require the same check to reject it."""
    import torch
    import torch.nn.functional as F

    from univst_torch.attention.ops import cross_frame_kv
    from univst_torch.attention.video_flash import (
        video_flash_attention, video_flash_attention_plain,
    )

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
    ratio = _err_over_tol(got, want)
    if not ratio <= 1.0:
        raise AssertionError(f"video_flash_attention {tuple(q.shape)} {idx} {dtype}: "
                             f"kernel vs plain at {ratio:.3g}x the tolerance "
                             f"(max abs err {err})")
    planted = None
    if plant:
        pad = -(-dh // 16) * 16  # the MMA depth the kernel pads dh to
        wrong = video_flash_attention(q, k, v, idx, sm_scale=pad**-0.5, **kw)
        planted = _err_over_tol(wrong, want)
        if not planted > 1.0:
            raise AssertionError(f"the check passed a kernel scaled by 1/sqrt({pad}) "
                                 f"instead of 1/sqrt({dh}) ({planted:.3g}x the tolerance)")
        print(f"[kernel] planted fault (scale 1/sqrt({pad})) rejected at "
              f"{planted:.3g}x the tolerance", flush=True)
    ms = _time_ms(lambda: video_flash_attention(q, k, v, idx, **kw), reps)
    plain_ms = _time_ms(lambda: video_flash_attention_plain(q, k, v, idx, **kw), 1)
    library_ms = None
    if not lc and lq == l:
        # yardstick: PyTorch's fused attention on the expanded K/V
        def heads(x):
            return x.reshape(b * f, h, x.shape[3], dh)

        def expand(x):
            xt = x.permute(0, 1, 3, 2, 4).reshape(b * f, l, h * dh)
            xe = cross_frame_kv(xt, f, idx)
            return xe.reshape(b * f, -1, h, dh).transpose(1, 2).contiguous()

        qh, ke, ve = heads(q), expand(k), expand(v)
        library_ms = _time_ms(lambda: F.scaled_dot_product_attention(qh, ke, ve), reps)
    case = dict(shape=[b, f, h, lq, l, dh], indices=list(idx), dtype=str(dtype).split(".")[-1],
                ctx=[lc, ctx_valid] if lc else None, max_abs_err=err, err_over_tol=ratio,
                planted_err_over_tol=planted, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                **_bound([b, f, h, lq, l, dh], idx, ctx_valid or 0, dtype))
    print(f"[kernel] {json.dumps(case)}", flush=True)
    return case


def _bound(shape, idx, ctx_valid: int, dtype) -> dict:
    """The card's least time for one call: the largest of its tensor FLOPs at
    the peak rate of ``dtype``, its exponentials on the MUFU and the FMA pipe
    together (``_exp_rate``), and its bytes at the memory rate. ``bound_by``
    is ``operations`` when either operation term wins (``bound_unit`` says
    which: ``tensor`` or ``exp``) and ``bytes`` otherwise. The terms, and
    the exponentials' time on the MUFU alone, go on a ``[bound]`` line: they
    are computed from shapes, not measured."""
    import torch

    from univst_torch.attention.video_flash import work

    w = work(shape, idx, ctx_valid, itemsize=torch.finfo(dtype).bits // 8)
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
    ratio = _err_over_tol(got, want)
    if not ratio <= 1.0:
        raise AssertionError(f"video_flash_attention_tokens {tuple(q.shape)} {idx} {dtype}: "
                             f"kernel vs plain at {ratio:.3g}x the tolerance (max abs err {err})")
    planted = None
    if plant:
        wrong = video_flash_attention_tokens(q, torch.roll(k, 1, dims=3),
                                             torch.roll(v, 1, dims=3), idx, **kw)
        planted = _err_over_tol(wrong, want)
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
        _vfa_tokens_case(1, 3, 2, 333, 200, 64, idx, bf, lc=20),  # ragged Lq, L and ctx
        _vfa_tokens_case(1, 4, 3, 300, 256, 64, idx, torch.float32, lc=77),  # ragged Lq, fp32
    ]
    _sync()
    return cases, tokens


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
    z0 = z0.double()
    mse = ((rec.double() - z0) ** 2).mean().item()
    psnr = 10 * np.log10((z0.max() - z0.min()).item() ** 2 / mse) if mse > 0 else float("inf")
    if not np.isfinite(psnr):
        raise AssertionError(f"reconstruction latent PSNR {psnr}")
    return psnr


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


def phase_main_path(steps: int):
    """SD-1.5 at 512 px, 16 frames, bf16, on the card."""
    import torch

    from univst_torch.core.adain import latent_adain
    from univst_torch.core.config import StyleTransferConfig
    from univst_torch.pipelines.sd import SDVideoPipeline

    nf, px, device = 16, 512, "cuda"
    frames, style, mask0 = _load_inputs(nf, px)
    t0 = time.time()
    pipe = SDVideoPipeline.build(variant="sd15", num_frames=nf, dtype=torch.bfloat16,
                                 capture_up_block=2, seed=0, device=device)
    _sync()
    print(f"[main] built sd15 (random weights, seed 0) in {time.time() - t0:.1f}s", flush=True)
    ts = pipe.schedule.timesteps(steps)
    cap_t = 301 if 301 in ts else int(ts[len(ts) // 2])
    gen = torch.Generator(device=device).manual_seed(0)
    stage = {}

    def run(name, fn):
        t = time.time()
        out = fn()
        _sync()
        stage[name] = time.time() - t
        print(f"[main] {name}: {stage[name]:.2f}s", flush=True)
        return out

    counters = _zero_counters()
    t_main = time.time()
    latents, ctx = run("encode", lambda: (pipe.encode_frames(frames, gen), pipe.encode_text("")))
    traj, feat = run("content_inversion", lambda: pipe.invert(
        latents, ctx, num_steps=steps, is_opt=True, capture_timestep=cap_t))
    spipe = pipe.with_frames(1)

    def style_inversion():
        straj, _ = spipe.invert(spipe.encode_frames(style, gen), ctx, num_steps=steps,
                                is_opt=False)
        return straj

    straj = run("style_inversion", style_inversion)

    masks = run("mask_propagation", lambda: _propagate(feat, mask0, device))

    def stylize():
        content_rev = torch.flip(traj, dims=[0])
        style_rev = torch.flip(straj, dims=[0])[:, :1]
        init = latent_adain(content_rev[0], style_rev[0])
        return pipe.stylize_latents(content_rev, style_rev, init, torch.cat([ctx] * 3),
                                    mask=masks.float() / 255.0,
                                    cfg=StyleTransferConfig(num_steps=steps))

    out = run("stylize", stylize)
    chunks = run("decode", lambda: pipe.decode_latents_uint8_chunks(out, 8))
    rec = run("reconstruction", lambda: pipe.reconstruct_latents(traj[-1], ctx, num_steps=steps))
    main_s = time.time() - t_main
    launches = {name: fn.launches for name, fn in counters.items()}

    video = torch.cat(chunks)
    psnr = _check_outputs({"trajectory": traj, "feature": feat, "style trajectory": straj,
                           "stylized latents": out, "reconstruction": rec},
                          masks, video, nf, px, traj[0], rec)
    # one 16-frame UNet forward per step of the content inversion, the
    # reconstruction and the stylization (the style branch runs single-frame),
    # each with the sparse-causal attentions at L >= 1024: 5 at 64x64, 5 at 32x32
    _check_launches(launches, {"video_flash_attention": 10 * 3 * steps,
                               "video_flash_attention_tokens": 0})
    summary = dict(steps=steps, frames=nf, size=px, stage_s=stage, main_path_s=main_s,
                   workflow_frames_per_s=nf / main_s,
                   stylize_frames_per_s=nf / (stage["stylize"] + stage["decode"]),
                   recon_latent_psnr_db=psnr, launches=launches,
                   masks_foreground=float((masks > 0).float().mean().item()),
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"[main] {json.dumps(summary)}", flush=True)
    return launches, (pipe, traj, ctx, masks)


def phase_sd_fallback(sd_state, steps: int):
    """The SD pipeline off the style-singleton path, on the card: the main
    path's pipeline and content trajectory, which serves as the style (its
    frames differ)."""
    import torch

    from univst_torch.core.adain import latent_adain
    from univst_torch.core.config import StyleTransferConfig

    pipe, traj, ctx, masks = sd_state
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


def _fill_motion_proj_out(unet, seed: int) -> int:
    """Every motion module's ``proj_out`` (zero at init) from a generator
    seeded with ``seed``, at the random init's lecun scale; returns the
    module count."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    mods = unet.motion_modules()
    with torch.no_grad():
        for mm in mods:
            w = mm.temporal_transformer.proj_out.weight
            w.copy_(torch.randn(w.shape, generator=gen, device=w.device) / w.shape[1] ** 0.5)
    return len(mods)


def phase_ad(steps: int):
    """AnimateDiff-v2 at 512 px, 16 frames, bf16, on the card."""
    import torch

    from univst_torch.core.config import StyleTransferConfig
    from univst_torch.pipelines.animatediff import build_animatediff

    nf, px, device = 16, 512, "cuda"
    frames, style, mask0 = _load_inputs(nf, px, style_frames=nf)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    pipe = build_animatediff(variant="ad", num_frames=nf, dtype=torch.bfloat16,
                             capture_up_block=2, seed=0, device=device)
    n_mm = _fill_motion_proj_out(pipe.unet, seed=1)
    _sync()
    w_max = max(mm.temporal_transformer.proj_out.weight.abs().max().item()
                for mm in pipe.unet.motion_modules())
    print(f"[ad] built AnimateDiff-v2 (SD-1.5 2D UNet + {n_mm} motion modules, SVD VAE, "
          f"CLIP-L; random weights, seed 0) in {time.time() - t0:.1f}s; proj_out of all "
          f"{n_mm} motion modules filled from seed 1 (max |w| {w_max:.4g})", flush=True)
    ts = pipe.schedule.timesteps(steps)
    cap_t = 301 if 301 in ts else int(ts[len(ts) // 2])
    gen = torch.Generator(device=device).manual_seed(0)
    stage = {}

    def run(name, fn):
        t = time.time()
        out = fn()
        _sync()
        stage[name] = time.time() - t
        print(f"[ad] {name}: {stage[name]:.2f}s", flush=True)
        return out

    counters = _zero_counters()
    t_main = time.time()
    latents, ctx = run("encode", lambda: (pipe.encode_frames(frames, gen), pipe.encode_text("")))
    traj, feat = run("content_inversion", lambda: pipe.invert(
        latents, ctx, num_steps=steps, is_opt=True, capture_timestep=cap_t))
    # the style image on all 16 frames: the motion modules tell them apart
    straj, _ = run("style_inversion", lambda: pipe.invert(
        pipe.encode_frames(style, gen), ctx, num_steps=steps, is_opt=False))
    masks = run("mask_propagation", lambda: _propagate(feat, mask0, device))

    def stylize():
        content_rev = torch.flip(traj, dims=[0])
        # the AnimateDiff runner starts from the raw content noise
        return pipe.stylize_latents(content_rev, torch.flip(straj, dims=[0]), content_rev[0],
                                    torch.cat([ctx] * 3), mask=masks.float() / 255.0,
                                    cfg=StyleTransferConfig(num_steps=steps))

    out = run("stylize", stylize)
    chunks = run("decode", lambda: pipe.decode_latents_uint8_chunks(out, 8))
    rec = run("reconstruction", lambda: pipe.reconstruct_latents(traj[-1], ctx, num_steps=steps))
    main_s = time.time() - t_main
    launches = {name: fn.launches for name, fn in counters.items()}

    video = torch.cat(chunks)
    psnr = _check_outputs({"trajectory": traj, "feature": feat, "style trajectory": straj,
                           "stylized latents": out, "reconstruction": rec},
                          masks, video, nf, px, traj[0], rec)
    _check_launches(launches, {"video_flash_attention": 0, "video_flash_attention_tokens": 0})
    summary = dict(steps=steps, frames=nf, size=px, stage_s=stage, main_path_s=main_s,
                   workflow_frames_per_s=nf / main_s,
                   stylize_frames_per_s=nf / (stage["stylize"] + stage["decode"]),
                   recon_latent_psnr_db=psnr, launches=launches,
                   masks_foreground=float((masks > 0).float().mean().item()),
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"[ad] {json.dumps(summary)}", flush=True)
    return launches


def phase_sd3(steps: int, px: int = 1024):
    """SD3-medium widths, ``px`` px, 16 frames, bf16, on the card."""
    import torch

    from univst_torch.core.adain import latent_adain_sd3
    from univst_torch.core.config import StyleTransferConfig
    from univst_torch.pipelines.sd3 import SD3VideoPipeline

    nf, device, block, cap_step = 16, "cuda", 20, 5
    frames, style, mask0 = _load_inputs(nf, px)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    pipe = SD3VideoPipeline.build(variant="sd3", num_frames=nf, dtype=torch.bfloat16,
                                  capture_block=block, seed=0, device=device)
    _sync()
    print(f"[sd3] built sd3-medium + T5-XXL + CLIP-L/G (random weights, seed 0) in "
          f"{time.time() - t0:.1f}s", flush=True)
    gen = torch.Generator(device=device).manual_seed(0)
    stage = {}

    def run(name, fn):
        t = time.time()
        out = fn()
        _sync()
        stage[name] = time.time() - t
        print(f"[sd3] {name}: {stage[name]:.2f}s", flush=True)
        return out

    counters = _zero_counters()
    t_main = time.time()

    def encode_prompt():
        out = pipe.encode_prompt("")
        pipe.free_text_encoders()
        return out

    ctx, pooled = run("encode_prompt", encode_prompt)
    latents = run("encode", lambda: pipe.encode_frames(frames, gen))
    traj, feat = run("content_inversion", lambda: pipe.invert(
        latents, ctx, pooled, num_steps=steps, is_rf_solver=True, capture_step=cap_step))
    spipe = pipe.with_frames(1)
    straj, _ = run("style_inversion", lambda: spipe.invert(
        spipe.encode_frames(style, gen), ctx, pooled, num_steps=steps, is_rf_solver=True))
    masks = run("mask_propagation", lambda: _propagate(feat, mask0, device))

    def stylize():
        content_rev = torch.flip(traj, dims=[0])
        style_rev = torch.flip(straj, dims=[0])[:, :1]
        init = latent_adain_sd3(content_rev[0], style_rev[0])
        return pipe.stylize_latents(content_rev, style_rev, init, content_rev[-1],
                                    torch.cat([ctx] * 3), torch.cat([pooled] * 3),
                                    mask=masks.float() / 255.0,
                                    cfg=StyleTransferConfig(num_steps=steps))

    out = run("stylize", stylize)
    video = run("decode", lambda: pipe.decode_latents_uint8(out, chunk=4))
    rec = run("reconstruction", lambda: pipe.reconstruct_latents(
        traj[-1], latents, ctx, pooled, num_steps=steps))
    main_s = time.time() - t_main
    launches = {name: fn.launches for name, fn in counters.items()}

    if tuple(feat.shape) != (nf, px // 16, px // 16, pipe.mmdit.cfg.hidden):
        raise AssertionError(f"captured feature {tuple(feat.shape)}")
    psnr = _check_outputs({"context": ctx, "pooled": pooled, "trajectory": traj,
                           "feature": feat, "style trajectory": straj,
                           "stylized latents": out, "reconstruction": rec},
                          masks, video, nf, px, traj[0], rec)
    # 24 blocks x (two RF-Solver forwards + one reconstruction forward + one
    # 2x16- or 16-frame stylization forward) per step
    _check_launches(launches, {"video_flash_attention": 0,
                               "video_flash_attention_tokens": 24 * 4 * steps})
    summary = dict(steps=steps, frames=nf, size=px, stage_s=stage, main_path_s=main_s,
                   workflow_frames_per_s=nf / main_s,
                   stylize_frames_per_s=nf / (stage["stylize"] + stage["decode"]),
                   recon_latent_psnr_db=psnr, launches=launches,
                   masks_foreground=float((masks > 0).float().mean().item()),
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"[sd3] {json.dumps(summary)}", flush=True)
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
    p.add_argument("--sd3_steps", type=int, default=32, help="SD3 steps (>= 32: both phases)")
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

    smi = phase_device()
    phase_build()
    cases, tokens = phase_kernels()
    sd_launches, sd_state = phase_main_path(args.steps)
    phase_sd_fallback(sd_state, args.steps)
    del sd_state
    torch.cuda.empty_cache()
    phase_ad(args.ad_steps)
    torch.cuda.empty_cache()
    sd3_launches = phase_sd3(args.sd3_steps)

    entries = [
        _entry("video_flash_attention", TPU_KERNEL, sd_launches["video_flash_attention"],
               cases, cases[0]),
        _entry("video_flash_attention_tokens", TPU_KERNEL_FOLDED,
               sd3_launches["video_flash_attention_tokens"], tokens, tokens[0]),
    ]
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
