"""The port's headline benchmark — port of ``bench.py`` and of the family
scripts it runs, ``scripts/smoke_ad_tpu.py`` and ``scripts/smoke_sd3_tpu.py``.

    python -m univst_torch.bench [--families ad,sd3] [--repeats 3] [--seed 0]
    python -m univst_torch.bench --device cpu          # CPU smoke size
    python -m univst_torch.bench --family ad|sd3       # one family alone

Headline: stylized frames/s on one card for ``bench.py``'s workload (its
lines 121-160): SD-1.5 at full width (UNet 320/640/1280, SVD temporal VAE,
CLIP-L; random weights from seed 0, bf16), 16 frames at 512 px, 50 DDIM
steps, mask on. The trajectories are synthetic, drawn on the device from a
``torch.Generator`` seeded with ``--seed``: content ``[51, 16, 64, 64, 4]``,
style in the single-frame form ``[51, 1, 64, 64, 4]`` that the
style-singleton path consumes (a repeated style image), initial latents and
a ``uniform > 0.5`` mask. A run is ``stylize_latents`` and the chunked uint8
decode (8 frames a chunk) copied to the host. One untimed first run
(``compile_s``: cuDNN's choices, the kernel build), then ``--repeats`` timed
runs; every run's seconds are printed and the best counts, as in
``bench.py``.

Printed: one JSON line with ``bench.py``'s keys (``metric``, ``value``,
``unit``, ``vs_baseline`` and under ``extra`` ``baseline_fps_range``,
``vs_baseline_range``, ``inversion_steps_per_sec``, ``recon_latent_psnr_db``,
``stylize_run_s``, ``effective_tflops``, ``mfu``) and the card's own:
``device`` (name, power limit as nvidia-smi reads it, count),
``peak_mem_gb`` (``max_memory_allocated`` from a reset after the build),
``stylize_runs_s`` and ``k1_launches`` (per timed stylization: 10 per
16-frame forward, one forward a step on both phases, 500 at 50 steps).
``--families`` adds ``extra.families``. The baseline, 0.74-1.05 f/s, is
``bench.py``'s estimate of the PyTorch reference on one A100.

The extras:
  * ``inversion_steps_per_sec``: 50-step EasyInv content inversion, one warm
    run, then one timed;
  * ``recon_latent_psnr_db``: the inversion's last latent reconstructed over
    50 steps, latent-space PSNR against the content latents;
  * ``effective_tflops`` / ``mfu``: one stylization's matmul, conv and
    attention FLOPs (``utils/flops.py::count_matmul_flops``) over the best
    run, decode included (as ``bench.py``), against the card's dense bf16
    peak (``PEAK_BF16_TFLOPS``; a card without an entry fails the run).

What the FLOP counts include. The port counts K1 by ``video_flash.work``,
which drops an index set's duplicate slots (at F = 16, 45 of the 48 slots of
``(-1, 0, 'first')`` and 30 of the 32 of ``(-1, 'first')``); ``bench.py``
traces with ``UNIVST_DISABLE_FLASH=1`` and counts the expanded XLA
formulation, every slot. A 16-frame B = 1 SD-1.5 forward at 512 px runs 5
K1 calls at 64x64 (L = 4096, dh = 40) and 5 at 32x32 (L = 1024, dh = 80),
two of each level on the 3-slot set, three on the 2-slot one: 4.349 TFLOP
counted here against 4.639 expanded, a ratio of 180 / 192 = 0.9375 (0.290
TFLOP less a 16-frame forward). The port's count also holds the style
pre-pass (one batched single-frame forward of the phase-1 steps), which
``bench.py`` leaves out.

Families (``--families ad,sd3``): each runs as a subprocess
(``python -m univst_torch.bench --family ...``), so each returns the card's
memory, and prints ``family``, ``size``, ``frames``, ``measured_steps``,
``ms_per_step``, ``frames_per_sec_50step`` (SD3: ``variant``) as the JAX
scripts do. AnimateDiff-v2: 512 px, 16 frames, 4 steps, capture-and-inject
(all frames of the style). SD3-medium (``variant='sd3'``): 1024 px, 16 frames, 2
steps; the prompt is encoded, then the text encoders are freed. Two changes
from the JAX scripts: a family that fails makes the bench exit non-zero;
and the 50-step estimate is composed from two rates measured here — the
measured steps once inside the shift window (phase 1, what
``ms_per_step`` reports) and once with the window closed (every step
stylized-only, phase 2) — weighted by the 50-step run's phase split
(``phase_segments``): AnimateDiff 25 + 25, SD3 31 + 19.

Runs on the card unless ``--device cpu`` is given; with no card and no
``--device cpu`` it exits non-zero. On the CPU it runs ``bench.py``'s smoke
size (tiny variant, 4 frames, 64 px, 10 steps; families 4 / 2 steps, fp32),
its ``metric`` says so, and ``mfu`` is null.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Optional, Sequence

import torch

REF_BASELINE_FPS = 1.05  # bench.py: the favorable bound of the A100 estimate
REF_BASELINE_FPS_LO = 0.74  # bench.py: the refined bound

# dense bf16 tensor-core peak, TFLOP/s, by a substring of the card's name
# (tried in order: the PCIe and NVL parts before the SXM one)
PEAK_BF16_TFLOPS = (
    ("H100 PCIe", 756.0),
    ("H100 NVL", 835.0),
    ("H100", 989.0),
    ("A100", 312.0),
)

FAMILY_STEPS = {"ad": 4, "sd3": 2}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def peak_tflops(device_name: str) -> float:
    """The dense bf16 peak of the named card; a card without an entry
    raises, naming it."""
    for key, peak in PEAK_BF16_TFLOPS:
        if key in device_name:
            return peak
    raise ValueError(f"no bf16 peak known for the card {device_name!r}: "
                     f"add it to PEAK_BF16_TFLOPS")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_info(device: torch.device) -> dict:
    """The card's name and power limit (nvidia-smi) and the card count."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None, "count": 0}
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", f"--id={device.index or 0}"],
                         capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    line = res.stdout.strip().splitlines()[0]
    return {"name": torch.cuda.get_device_name(device), "power_limit": line.split(",")[-1].strip(),
            "count": torch.cuda.device_count()}


def _launch_counts() -> tuple:
    """K1's and K2's launch counters as they stand."""
    from univst_torch.attention.video_flash import (
        video_flash_attention, video_flash_attention_tokens,
    )

    return video_flash_attention.launches, video_flash_attention_tokens.launches


def _launches_since(before: tuple) -> tuple:
    return tuple(now - then for now, then in zip(_launch_counts(), before))


def synthetic_inputs(device, steps: int, frames: int, size: int, seed: int,
                     style_frames: int = 1, channels: int = 4):
    """Content and style trajectories (reversed, ``steps + 1`` long), initial
    latents and a ``uniform > 0.5`` mask, drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    h8 = size // 8

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)

    content = normal(steps + 1, frames, h8, h8, channels)
    style = normal(steps + 1, style_frames, h8, h8, channels)
    init = normal(frames, h8, h8, channels)
    mask = (torch.rand((frames, size, size), generator=gen, device=device) > 0.5).float()
    return content, style, init, mask


def measure(pipe, steps: int, size: int, repeats: int = 3, seed: int = 0,
            peak: Optional[float] = None) -> dict:
    """``bench.py``'s measurements on a built SD pipeline: one untimed run,
    then stylization plus chunked uint8 decode (best of ``repeats`` timed
    runs), the content inversion's steps/s (one untimed inversion, then one
    timed), the round trip's latent PSNR, and :func:`summarize`'s FLOP count.
    ``peak``: the card's bf16 TFLOP/s (None: no MFU). The peak memory reads
    from the caller's last reset."""
    from univst_torch.core.config import StyleTransferConfig
    from univst_torch.utils.metrics import psnr

    device, frames = pipe.device, pipe.num_frames
    content, style, init, mask = synthetic_inputs(device, steps, frames, size, seed)
    context = pipe.encode_text("")
    context3 = torch.cat([context] * 3)
    cfg = StyleTransferConfig(num_steps=steps)

    def stylize():
        return pipe.stylize_latents(content, style, init, context3, mask=mask, cfg=cfg)

    def run():
        chunks = pipe.decode_latents_uint8_chunks(stylize(), chunk=8)
        out = torch.cat([c.cpu() for c in chunks])
        _sync(device)
        return out

    t0 = time.perf_counter()
    run()
    compile_s = time.perf_counter() - t0
    times, launches = [], []
    for _ in range(repeats):
        before = _launch_counts()
        t0 = time.perf_counter()
        video = run()
        times.append(time.perf_counter() - t0)
        launches.append(_launches_since(before))
    if video.shape[0] != frames or video.shape[-1] != 3 or video.dtype != torch.uint8:
        raise AssertionError(f"decoded frames {tuple(video.shape)} {video.dtype}")

    def invert():
        traj, _ = pipe.invert(content[0], context, num_steps=steps, is_opt=True)
        _sync(device)
        return traj

    invert()
    t0 = time.perf_counter()
    traj = invert()
    inv_s = time.perf_counter() - t0
    rec = pipe.reconstruct_latents(traj[-1], context, num_steps=steps)
    z0 = content[0].double().cpu().numpy()
    recon_psnr = psnr(z0, rec.double().cpu().numpy(), data_range=float(z0.max() - z0.min()))
    m = summarize(stylize, frames, steps, times, inv_s, recon_psnr, peak, device)
    if any(n != (m["k1_launches"], m["k2_launches"]) for n in launches):
        raise AssertionError(f"kernel launches of the timed runs {launches} differ from the "
                             f"counted run's {(m['k1_launches'], m['k2_launches'])}")
    return dict(m, compile_s=compile_s)


def summarize(stylize, frames: int, steps: int, runs_s: Sequence[float], inversion_s: float,
              recon_psnr: float, peak: Optional[float], device: torch.device) -> dict:
    """``extra``'s measured keys from the timings of ``steps``-step runs:
    ``runs_s`` of stylization plus decode (the best counts), ``inversion_s``
    of one content inversion. Runs ``stylize`` once more under the FLOP
    counter; its K1 / K2 launches are the per-stylization counts (read as
    differences: the counters are left running)."""
    from univst_torch.utils.flops import count_matmul_flops

    before = _launch_counts()
    flops = count_matmul_flops(stylize)
    _sync(device)
    k1, k2 = _launches_since(before)
    best = min(runs_s)
    eff = flops / best / 1e12
    return dict(frames=frames, inversion_steps_per_sec=steps / inversion_s,
                recon_latent_psnr_db=recon_psnr, stylize_run_s=best,
                stylize_runs_s=list(runs_s), flops=flops, effective_tflops=eff,
                mfu=None if peak is None else eff / peak, k1_launches=k1, k2_launches=k2,
                peak_mem_gb=(torch.cuda.max_memory_allocated(device) / 1e9
                             if device.type == "cuda" else None))


def headline(m: dict, steps: int, size: int, device: dict, on_card: bool) -> dict:
    """``bench.py``'s JSON line from :func:`measure`'s readings."""
    fps = m["frames"] / m["stylize_run_s"]
    metric = (f"end-to-end stylized frames/sec/card (SD1.5 @{size}, {steps} steps)" if on_card
              else f"CPU-smoke stylized frames/sec (tiny cfg, {size} px, {steps} steps)")
    extra = {k: m[k] for k in ("inversion_steps_per_sec", "recon_latent_psnr_db",
                               "stylize_run_s", "effective_tflops", "mfu")}
    return {
        "metric": metric,
        "value": fps,
        "unit": "frames/sec",
        "vs_baseline": fps / REF_BASELINE_FPS,
        "extra": dict(
            baseline_fps_range=[REF_BASELINE_FPS_LO, REF_BASELINE_FPS],
            vs_baseline_range=[fps / REF_BASELINE_FPS, fps / REF_BASELINE_FPS_LO],
            **extra, device=device, peak_mem_gb=m["peak_mem_gb"],
            stylize_runs_s=m["stylize_runs_s"], k1_launches=m["k1_launches"]),
    }


# -- families ---------------------------------------------------------------------


def closed_window(shift):
    """``shift`` with a window that never opens: every step is stylized-only."""
    out = dataclasses.replace(shift, eta1=float(shift.num_steps + 1))
    assert out.window_end() == 0
    return out


def compose_50(phase1_s_per_step: float, phase2_s_per_step: float, window_end: int,
               frames: int) -> dict:
    """The 50-step run from the two per-step rates and the 50-step run's
    phase split (``phase_segments``)."""
    from univst_torch.pipelines.segments import phase_segments

    p1, _ = phase_segments(50, window_end)
    k1 = sum(c for _, c in p1)
    est = k1 * phase1_s_per_step + (50 - k1) * phase2_s_per_step
    return {"phase1_steps_of_50": k1, "est_50step_s": est, "frames_per_sec_50step": frames / est}


def measure_family(family: str, device: torch.device, seed: int = 0) -> dict:
    """One family's stylization steps on ``device`` (a card: full width;
    the CPU: the tiny config, 4 frames at 64 px, fp32): one untimed run of
    each phase, then ``FAMILY_STEPS`` steps timed inside the shift window
    (phase 1) and as many timed with it closed (phase 2)."""
    from univst_torch.core.config import StyleTransferConfig
    from univst_torch.pipelines.segments import phase_segments

    on_card = device.type == "cuda"
    n = FAMILY_STEPS[family]
    dtype = torch.bfloat16 if on_card else torch.float32
    if family == "ad":
        from univst_torch.pipelines.animatediff import build_animatediff

        frames, size = (16, 512) if on_card else (4, 64)
        pipe = build_animatediff(variant="ad" if on_card else "tiny", num_frames=frames,
                                 dtype=dtype, seed=0, device=device)
        content, style, init, mask = synthetic_inputs(device, n, frames, size, seed,
                                                      style_frames=frames)
        context3 = torch.cat([pipe.encode_text("")] * 3)
        shift = pipe.style_shift_cfg

        def stylize(style_cfg):
            return pipe.stylize_latents(content, style, init, context3, mask=mask,
                                        cfg=StyleTransferConfig(num_steps=n), style_cfg=style_cfg)
    elif family == "sd3":
        from univst_torch.core.config import SD3_STYLE_SHIFT
        from univst_torch.pipelines.sd3 import SD3VideoPipeline

        frames, size = (16, 1024) if on_card else (4, 64)
        variant = "sd3" if on_card else "tiny"
        pipe = SD3VideoPipeline.build(variant=variant, num_frames=frames, dtype=dtype, seed=0,
                                      device=device)
        content, style, init, mask = synthetic_inputs(device, n, frames, size, seed,
                                                      channels=pipe.vae.cfg.latent_channels)
        context, pooled = pipe.encode_prompt("")
        pipe.free_text_encoders()
        context3, pooled3 = torch.cat([context] * 3), torch.cat([pooled] * 3)
        shift = SD3_STYLE_SHIFT

        def stylize(style_cfg):
            return pipe.stylize_latents(content, style, init, content[0], context3, pooled3,
                                        mask=mask, cfg=StyleTransferConfig(num_steps=n),
                                        style_cfg=style_cfg)
    else:
        raise ValueError(f"unknown family {family!r}: ad or sd3")
    if phase_segments(n, shift.window_end())[1]:
        raise ValueError(f"{n} steps reach past the shift window ({shift.window_end()})")

    def timed(style_cfg) -> float:
        t0 = time.perf_counter()
        out = stylize(style_cfg)
        _sync(device)
        dt = time.perf_counter() - t0
        if not torch.isfinite(out).all():
            raise AssertionError(f"{family}: non-finite stylized latents")
        return dt

    solo = closed_window(shift)
    timed(shift), timed(solo)  # untimed: cuDNN's choices, the kernel build
    t1, t2 = timed(shift), timed(solo)
    out = {"family": family}
    if family == "sd3":
        out["variant"] = variant
    out.update(size=size, frames=frames, measured_steps=n, ms_per_step=t1 / n * 1e3,
               phase1_ms_per_step=t1 / n * 1e3, phase2_ms_per_step=t2 / n * 1e3)
    out.update(compose_50(t1 / n, t2 / n, shift.window_end(), frames))
    out.update(peak_mem_gb=torch.cuda.max_memory_allocated(device) / 1e9 if on_card else None,
               device=device_info(device))
    return out


def family_command(family: str, device: Optional[str], seed: int) -> list:
    cmd = [sys.executable, "-m", "univst_torch.bench", "--family", family, "--seed", str(seed)]
    return cmd + (["--device", device] if device else [])


def measure_families(families: Sequence[str], device: Optional[str], seed: int,
                     timeout_s: float = 3600) -> dict:
    """Each family in a subprocess of its own; its last stdout line is its
    JSON. A family that fails raises, with its stderr's tail."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    out = {}
    for fam in families:
        res = subprocess.run(family_command(fam, device, seed), capture_output=True, text=True,
                             timeout=timeout_s, cwd=ROOT, env=env)
        lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
        if res.returncode != 0 or not lines:
            raise RuntimeError(f"family {fam} failed (exit {res.returncode}):\n"
                               + res.stderr[-4000:])
        out[fam] = json.loads(lines[-1])
    return out


# -- entry point -------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu for the smoke size on the CPU; default: the CUDA card")
    ap.add_argument("--seed", type=int, default=0, help="seed of the synthetic trajectories")
    ap.add_argument("--repeats", type=int, default=3, help="timed stylization runs (best counts)")
    ap.add_argument("--families", default="",
                    help="comma-separated families measured after the headline (ad,sd3), "
                         "each in a subprocess, under extra.families")
    ap.add_argument("--family", choices=sorted(FAMILY_STEPS), default=None,
                    help="measure this family alone and print its line")
    args = ap.parse_args(argv)

    from univst_torch.pipelines.sd import SDVideoPipeline, resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"univst_torch.bench: {e}", file=sys.stderr)
        return 2
    on_card = device.type == "cuda"
    if args.family:
        print(json.dumps(measure_family(args.family, device, args.seed)))
        return 0

    info = device_info(device)
    peak = peak_tflops(info["name"]) if on_card else None
    frames, size, steps = (16, 512, 50) if on_card else (4, 64, 10)
    t0 = time.perf_counter()
    pipe = SDVideoPipeline.build(variant="sd15" if on_card else "tiny", num_frames=frames,
                                 dtype=torch.bfloat16 if on_card else torch.float32, seed=0,
                                 device=device)
    _sync(device)
    build_s = time.perf_counter() - t0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    m = measure(pipe, steps, size, repeats=args.repeats, seed=args.seed, peak=peak)
    del pipe
    result = headline(m, steps, size, info, on_card)
    fams = [f for f in args.families.split(",") if f]
    if fams:
        if on_card:
            torch.cuda.empty_cache()
        result["extra"]["families"] = measure_families(fams, args.device, args.seed)
    print(json.dumps(result))
    print(f"# device={info['name']} ({info['power_limit']}) steps={steps} frames={frames} "
          f"size={size} build={build_s:.1f}s compile={m['compile_s']:.1f}s "
          f"runs={['%.3f' % t for t in m['stylize_runs_s']]} flops={m['flops']:.4g} "
          f"k1={m['k1_launches']} k2={m['k2_launches']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
