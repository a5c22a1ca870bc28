"""The frame-parallel SD-1.5 workflow over NCCL, one rank per card, as a user
runs it: ``torchrun --nproc_per_node 4 -m univst_torch.cli.run_workflow
--mesh data=4`` against the same CLI on one card (512 px, 16 frames, 30
steps, bf16, seeded random weights); and the SD3 workflow on a ``data x
tensor`` mesh the same way: SD3.5-large (1024 px, 16 frames, 8 steps) on
``--mesh data=2,tensor=2`` and on ``--mesh data=1,tensor=4`` (its 38 heads
split 10, 10, 9, 9) and SD3.5-medium (32 steps) on ``--mesh data=4``;
and the SD workflow once more with the pixel smoother (``--smoother pixel``,
LK, smoothing steps [20, 25)) on ``data=4``, with the collective census of
one sharded smoothing step held against a ``torch.profiler`` trace of it.
Needs four CUDA cards and skips otherwise; imports no JAX:

    python -m pytest --noconftest tests/test_torch_mesh_nccl.py -m cuda -s

Checked: rank 0 writes the one-card tree (the same files), the masks agree
on >= 99.5% of the pixels, every output is finite and, for SD3, every
stylized frame is >= 30 dB from the one-card one. Then the smoke's forward
check over NCCL, by this file's ``__main__`` on one card and under
torchrun on four: for SD (``chip_smoke._forward_pair``: the inversion
forward and the injected 2-branch stylization forward at step 15 of 30,
on seeded inputs, ``data=4``) with the UNet in fp32 within rtol 2e-4 /
atol 2e-5; for SD3 (``chip_smoke._forward_pair_sd3``: SD3.5-large's
inversion forward and injected 2-branch forward with its single-frame
style capture at step 4 of 8, on seeded inputs, ``data=2,tensor=2``) with
the MMDiT in fp32 within rtol / atol 3e-4 (the JAX package's SD3 bar);
for both, in bf16 no further from the one-card fp32 forward than the
one-card bf16 forward is, up to ``chip_smoke.MESH_BF16_RATIO``. Printed:
the cards' names and power limits, each stage's seconds on one card and
on four (the CLI's ``[workflow]`` lines), how far the four-card outputs
are from the one-card ones (bf16 runs that differ by rounding drift apart
over the DDIM steps: PERF.md §6), and the forward checks' readings.
"""

import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NF, PX, STEPS = 16, 512, 30
# the SD3 forward check: SD3.5-large (38 heads, 19 a tensor rank) at 512 px
# (1024 tokens a frame, so K2 runs), 16 frames, the probe at step 4 of 8
SD3_FWD = dict(variant="sd35", px=512, steps=8, mesh="data=2,tensor=2")
SD3_BAR = dict(rtol=3e-4, atol=3e-4)  # tests/test_distributed.py:198-202


def _cards() -> str:
    """Each card's name and power limit, as nvidia-smi gives them."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return "; ".join(res.stdout.split("\n")).strip("; ")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _stages(log: str) -> dict:
    return {m.group(1): float(m.group(2))
            for m in re.finditer(r"^\[workflow\] (.+?): ([0-9.]+)s$", log, re.M)}


def run_and_compare(root, ranks: int, flags: list, env=None, timeout: float = 1500,
                    mesh=None) -> dict:
    """The workflow CLI once in one process and once over ``ranks`` torchrun
    ranks (``--mesh`` ``mesh``, default ``data=ranks``); returns the stage
    seconds of both and the comparison of their trees."""
    from PIL import Image

    env = dict(os.environ, **(env or {}))
    one, many = os.path.join(root, "one"), os.path.join(root, "many")
    cli = ["-m", "univst_torch.cli.run_workflow", *flags]
    logs = {}
    for name, cmd, out, extra in (
            ("one", [sys.executable, *cli], one, {"CUDA_VISIBLE_DEVICES": "0"}),
            ("many", [sys.executable, "-m", "torch.distributed.run",
                      f"--nproc_per_node={ranks}", f"--master_port={_free_port()}", *cli,
                      "--mesh", mesh or f"data={ranks}"], many, {})):
        res = subprocess.run([*cmd, "--output_root", out], cwd=REPO, env=dict(env, **extra),
                             capture_output=True, text=True, timeout=timeout)
        assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
        logs[name] = res.stdout
    files = sorted(os.path.relpath(os.path.join(d, f), one)
                   for d, _, fs in os.walk(one) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), many)
                           for d, _, fs in os.walk(many) for f in fs)
    worst, masks_equal, psnr = 0.0, [], []
    for rel in files:
        a, b = (os.path.join(d, rel) for d in (one, many))
        if rel.endswith(".pt"):
            x, y = (torch.load(p, weights_only=True).double() for p in (a, b))
            assert torch.isfinite(y).all(), rel
            worst = max(worst, ((x - y).pow(2).mean().sqrt() / x.pow(2).mean().sqrt()).item())
        elif rel.endswith(".png"):
            x, y = (np.asarray(Image.open(p)).astype(np.float64) for p in (a, b))
            if "masks" in rel.split(os.sep) and "palette" not in rel.split(os.sep):
                masks_equal.append(float((x == y).mean()))
            elif "stylizations" in rel.split(os.sep):
                mse = ((x - y) ** 2).mean()
                psnr.append(float("inf") if mse == 0 else 10 * np.log10(255.0**2 / mse))
    return dict(stages_one=_stages(logs["one"]), stages_many=_stages(logs["many"]),
                files=len(files), worst_pt_rel_rms=worst, masks_equal_min=min(masks_equal),
                stylized_psnr_db_min=min(psnr))


def forward_pair(out_path: str) -> None:
    """The smoke's forward pair of the bf16 SD-1.5 pipeline (seed 0) on
    seeded inputs, on one card or, under torchrun, over NCCL with one rank
    per card (``init_from_env``); rank 0 saves the eps (gathered)."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from univst_torch.distributed.mesh import init_from_env
    from univst_torch.pipelines.sd import SDVideoPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = init_from_env() if int(os.environ.get("WORLD_SIZE", 1)) > 1 else None
    dev = mesh.device if mesh is not None else torch.device("cuda", 0)
    pipe = SDVideoPipeline.build(variant="sd15", num_frames=NF, dtype=torch.bfloat16,
                                 capture_up_block=2, seed=0, device=dev)
    rng = np.random.default_rng(0)
    i = STEPS // 2
    with torch.inference_mode():
        ctx = pipe.encode_text("").cpu()
    shape = (PX // 8, PX // 8, 4)  # latents are channels-last
    probe = dict(i=i, t=int(pipe.schedule.timesteps(STEPS)[i]), ctx=ctx,
                 z=torch.from_numpy(rng.standard_normal((NF,) + shape, dtype=np.float32)),
                 sty=torch.from_numpy(rng.standard_normal((1,) + shape, dtype=np.float32))
                 .expand(NF, -1, -1, -1))
    if mesh is not None:
        pipe = pipe.with_mesh(mesh)
    out = chip_smoke._forward_pair(pipe, probe)
    if mesh is None or mesh.rank == 0:
        torch.save(out, out_path)
    if mesh is not None:
        torch.distributed.destroy_process_group()


def forward_pair_sd3(out_path: str, device=None) -> None:
    """The smoke's SD3 forward pair (``chip_smoke._forward_pair_sd3``) of the
    bf16 ``SD3_FWD`` pipeline (seed 0) on seeded inputs, on one card or,
    under torchrun, over NCCL on ``SD3_FWD['mesh']`` with one rank per card
    (``device='cpu'``: gloo ranks on the CPU, to rehearse it with
    ``SD3_FWD`` at the tiny variant); rank 0 saves the velocities
    (gathered)."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from univst_torch.distributed.mesh import parse_mesh_spec
    from univst_torch.pipelines.sd3 import SD3VideoPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    many = int(os.environ.get("WORLD_SIZE", 1)) > 1
    mesh = parse_mesh_spec(SD3_FWD["mesh"], device=device) if many else None
    dev = mesh.device if mesh is not None else torch.device(device or "cuda")
    pipe = SD3VideoPipeline.build(variant=SD3_FWD["variant"], num_frames=NF,
                                  dtype=torch.bfloat16, seed=0, device=dev)
    with torch.inference_mode():
        ctx, pooled = (x.cpu() for x in pipe.encode_prompt(""))
    pipe.free_text_encoders()
    steps, i = SD3_FWD["steps"], SD3_FWD["steps"] // 2
    vcfg = pipe.vae.cfg
    h = SD3_FWD["px"] // 2 ** (len(vcfg.block_out_channels) - 1)
    shape = (h, h, vcfg.latent_channels)  # latents are channels-last
    sigma = float(pipe.schedule.sigmas(steps, mu=pipe._mu(h, h))[i])
    rng = np.random.default_rng(0)
    probe = dict(i=i, t=sigma * pipe.schedule.cfg.num_train_timesteps, ctx=ctx, pooled=pooled,
                 z=torch.from_numpy(rng.standard_normal((NF,) + shape, dtype=np.float32)),
                 sty=torch.from_numpy(rng.standard_normal((1,) + shape, dtype=np.float32)))
    if mesh is not None:
        pipe = pipe.with_mesh(mesh)
    out = chip_smoke._forward_pair_sd3(pipe, probe)
    if mesh is None or mesh.rank == 0:
        torch.save(out, out_path)
    if mesh is not None:
        torch.distributed.destroy_process_group()


def smooth_census(out_path: str) -> None:
    """One sharded smoothing step of the bf16 SD-1.5 pipeline (seed 0;
    ``_smooth_eps`` on seeded eps and latents of 16 frames at 512 px, a
    box mask, LK, radius 2) under torchrun over NCCL, after a warm-up, under
    ``census.collect_collectives`` and a ``torch.profiler`` trace; each rank
    saves its census by op and by site and the trace's collectives (by op,
    ``census.profiler_ops``, by range name, and every ``nccl:*`` range by
    the device it was recorded on)."""
    sys.path.insert(0, REPO)
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    from univst_torch.core.config import StyleTransferConfig
    from univst_torch.distributed.census import (
        collect_collectives, profiler_collectives, profiler_ops, summarize,
    )
    from univst_torch.distributed.mesh import init_from_env
    from univst_torch.pipelines.sd import SDVideoPipeline

    mesh = init_from_env()
    pipe = SDVideoPipeline.build(variant="sd15", num_frames=NF, dtype=torch.bfloat16, seed=0,
                                 device=mesh.device).with_mesh(mesh)
    rng = np.random.default_rng(0)
    h = PX // 2 ** (len(pipe.vae.cfg.block_out_channels) - 1)
    shape = (NF, h, h, 4)  # latents are channels-last
    eps, lat = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)) for _ in "el")
    mask = torch.zeros(NF, PX, PX)
    mask[:, PX // 4:3 * PX // 4, PX // 8:5 * PX // 8] = 1.0
    cfg = StyleTransferConfig(num_steps=STEPS, smoother="pixel")
    t = int(pipe.schedule.timesteps(STEPS)[cfg.smoother_steps[0]])
    eps, lat, mask = (pipe._shard(x.to(mesh.device)) for x in (eps, lat, mask))
    with torch.inference_mode():
        pipe._smooth_eps(eps, t, lat, mask, cfg)  # warm-up
        torch.cuda.synchronize()
        with collect_collectives() as recs, profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pipe._smooth_eps(eps, t, lat, mask, cfg)
            torch.cuda.synchronize()
    ranges = Counter(f"{e.name} ({e.device_type.name})" for e in prof.events()
                     if e.name.startswith("nccl:"))
    torch.save(dict(rank=mesh.rank, census=dict(Counter(op for op, *_ in recs)),
                    by_site=summarize(recs, by_site=True), profiler=dict(profiler_ops(prof)),
                    names=dict(profiler_collectives(prof)), ranges_by_device=dict(ranges)),
               f"{out_path}.{mesh.rank}")
    torch.distributed.destroy_process_group()


def run_forward_pair(root, ranks: int, timeout: float = 900, kind: str = "sd") -> dict:
    """:func:`forward_pair` (``kind='sd3'``: :func:`forward_pair_sd3`) on
    one card and over ``ranks`` torchrun ranks; returns both results."""
    out = {}
    for name, cmd, extra in (
            ("one", [sys.executable], {"CUDA_VISIBLE_DEVICES": "0"}),
            ("many", [sys.executable, "-m", "torch.distributed.run",
                      f"--nproc_per_node={ranks}", f"--master_port={_free_port()}"], {})):
        path = os.path.join(root, f"forward_{kind}_{name}.pt")
        res = subprocess.run([*cmd, os.path.abspath(__file__), path, kind], cwd=REPO,
                             env=dict(os.environ, **extra), capture_output=True, text=True,
                             timeout=timeout)
        assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
        out[name] = torch.load(path, weights_only=True)
    return out


@pytest.mark.cuda
def test_sd_workflow_over_nccl_matches_one_card(tmp_path):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards (one NCCL rank per card)")
    from univst_torch import _build

    _build.build("video_flash_attention")  # once, before the ranks start
    ex = os.path.join(REPO, "examples")
    out = run_and_compare(str(tmp_path), 4, [
        "--backbone", "sd", "--variant", "sd15", "--num_frames", "16", "--height", "512",
        "--width", "512", "--time_steps", "30",
        "--content_path", os.path.join(ex, "contents", "demo-fly"),
        "--style_path", os.path.join(ex, "styles", "00033.png"),
        "--mask_path", os.path.join(ex, "masks", "demo-fly.png")])
    print(f"[nccl] {_cards()}: {out}")
    assert out["masks_equal_min"] >= 0.995

    sys.path.insert(0, REPO)
    import chip_smoke

    fwd = run_forward_pair(str(tmp_path), 4)
    readings = forward_readings(fwd["many"], fwd["one"], chip_smoke._err_over_tol32)
    print(f"[nccl] forward pair: {readings}")
    for name, r in readings.items():
        assert r["err_over_tol"] <= 1.0, (name, r)
        assert r["bf16_ratio"] <= chip_smoke.MESH_BF16_RATIO, (name, r)


SD3_RUNS = {
    # SD3.5-large's 38 heads split 19 a tensor rank
    "sd35l_dp2tp2": ("sd35", "8", "data=2,tensor=2"),
    # ... and 10, 10, 9, 9 over four tensor ranks, every rank on all 16 frames
    "sd35l_tp4": ("sd35", "8", "data=1,tensor=4"),
    "sd35m_dp4": ("sd35m", "32", "data=4"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("run", sorted(SD3_RUNS))
def test_sd3_workflow_over_nccl_matches_one_card(run, tmp_path):
    """The SD3 workflow CLI (1024 px, 16 frames, bf16, seeded random
    weights) on one card and on four over NCCL: rank 0 writes the one-card
    tree, the masks agree on >= 99.5% of the pixels, every output is
    finite; printed: each stage's seconds on one card and on four, and how
    far the four-card outputs are from the one-card ones."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards (one NCCL rank per card)")
    from univst_torch import _build

    _build.build("video_flash_attention")  # once, before the ranks start
    variant, steps, mesh = SD3_RUNS[run]
    ex = os.path.join(REPO, "examples")
    out = run_and_compare(str(tmp_path), 4, [
        "--backbone", "sd3", "--variant", variant, "--num_frames", "16", "--height", "1024",
        "--width", "1024", "--time_steps", steps,
        "--content_path", os.path.join(ex, "contents", "demo-fly"),
        "--style_path", os.path.join(ex, "styles", "00033.png"),
        "--mask_path", os.path.join(ex, "masks", "demo-fly.png")], mesh=mesh)
    print(f"[nccl] {run} ({mesh}) {_cards()}: {out}")
    assert out["masks_equal_min"] >= 0.995
    assert out["stylized_psnr_db_min"] >= 30.0


def forward_readings(got: dict, want: dict, err_over_tol) -> dict:
    """The forward pair over four cards (``got``) against one card
    (``want``): fp32 err / tol under ``err_over_tol``, and the bf16 ratio
    the smoke's forward gate reads."""
    sys.path.insert(0, REPO)
    import chip_smoke

    readings = {}
    for name in ("inversion", "injected"):
        key = name + "_fp32"
        ref_err = chip_smoke._rel_rms(want[name], want[key])
        readings[name] = dict(err_over_tol=err_over_tol(got[key], want[key]),
                              bf16_rel_rms=chip_smoke._rel_rms(got[name], want[name]),
                              ref_bf16_vs_fp32_rel_rms=ref_err,
                              bf16_ratio=chip_smoke._rel_rms(got[name], want[key]) / ref_err)
    return readings


def err_over_tol_sd3(got, want) -> float:
    """The largest ``|got - want| / (atol + rtol |want|)`` under the JAX
    package's SD3 bar."""
    tol = SD3_BAR["atol"] + SD3_BAR["rtol"] * want.double().abs()
    return ((got.double() - want.double()).abs() / tol).max().item()


@pytest.mark.cuda
def test_sd_smoother_workflow_over_nccl_matches_one_card(tmp_path):
    """The SD workflow CLI with ``--smoother pixel`` (LK; 30 steps, so the
    five smoothing steps [20, 25) run) on one card and on ``data=4`` over
    NCCL: rank 0 writes the one-card tree, the masks agree on >= 99.5% of
    the pixels, every stylized frame is >= 30 dB from the one-card one.
    Then the census of one sharded smoothing step against its
    ``torch.profiler`` trace (``smooth_census``): op by op equal on every
    rank, one ``smooth_halo`` all-to-all among them."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards (one NCCL rank per card)")
    from univst_torch import _build

    _build.build("video_flash_attention")  # once, before the ranks start
    ex = os.path.join(REPO, "examples")
    out = run_and_compare(str(tmp_path), 4, [
        "--backbone", "sd", "--variant", "sd15", "--num_frames", str(NF), "--height", str(PX),
        "--width", str(PX), "--time_steps", str(STEPS), "--smoother", "pixel",
        "--content_path", os.path.join(ex, "contents", "demo-fly"),
        "--style_path", os.path.join(ex, "styles", "00033.png"),
        "--mask_path", os.path.join(ex, "masks", "demo-fly.png")])
    print(f"[nccl] smoother {_cards()}: {out}")
    assert out["masks_equal_min"] >= 0.995
    assert out["stylized_psnr_db_min"] >= 30.0

    path = os.path.join(str(tmp_path), "smooth_census.pt")
    res = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=4",
                          f"--master_port={_free_port()}", os.path.abspath(__file__), path,
                          "smooth_census"], cwd=REPO, capture_output=True, text=True,
                         timeout=900)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    for rank in range(4):
        got = torch.load(f"{path}.{rank}", weights_only=False)
        print(f"[nccl] smoothing-step census, rank {rank}: {got}")
        assert got["profiler"] == got["census"], got
        assert got["by_site"]["all_to_all:smooth_halo"]["count"] == 1, got


@pytest.mark.cuda
def test_sd3_forward_pair_over_nccl_matches_one_card(tmp_path):
    """The SD3 forward check over NCCL on ``data=2,tensor=2`` (the tensor
    all-reduce and K2's halo on the card's collectives) against one card."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards (one NCCL rank per card)")
    from univst_torch import _build

    _build.build("video_flash_attention")  # once, before the ranks start
    sys.path.insert(0, REPO)
    import chip_smoke

    fwd = run_forward_pair(str(tmp_path), 4, kind="sd3")
    readings = forward_readings(fwd["many"], fwd["one"], err_over_tol_sd3)
    print(f"[nccl] SD3 forward pair ({SD3_FWD}) {_cards()}: {readings}")
    for name, r in readings.items():
        assert r["err_over_tol"] <= 1.0, (name, r)
        assert r["bf16_ratio"] <= chip_smoke.MESH_BF16_RATIO, (name, r)


if __name__ == "__main__":
    {"sd3": forward_pair_sd3, "smooth_census": smooth_census}.get(
        (sys.argv[2:] or [""])[0], forward_pair)(sys.argv[1])
