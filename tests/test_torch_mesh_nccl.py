"""The frame-parallel SD-1.5 workflow over NCCL, one rank per card, as a user
runs it: ``torchrun --nproc_per_node 4 -m univst_torch.cli.run_workflow
--mesh data=4`` against the same CLI on one card (512 px, 16 frames, 30
steps, bf16, seeded random weights). Needs four CUDA cards and skips
otherwise; imports no JAX:

    python -m pytest --noconftest tests/test_torch_mesh_nccl.py -m cuda -s

Checked: rank 0 writes the one-card tree (the same files), the masks agree
on >= 99.5% of the pixels and every output is finite. Then the smoke's
forward check over NCCL (``chip_smoke._forward_pair``: the inversion
forward and the injected 2-branch stylization forward at step 15 of 30,
on seeded inputs, by this file's ``__main__`` on one card and under
torchrun on four): with the UNet in fp32 within rtol 2e-4 / atol 2e-5,
and in bf16 no further from the one-card fp32 forward than the one-card
bf16 forward is, up to ``chip_smoke.MESH_BF16_RATIO``. Printed: each
stage's seconds on one card and on four (the CLI's ``[workflow]`` lines),
how far the four-card outputs are from the one-card ones (bf16 runs that
differ by rounding drift apart over the DDIM steps: PERF.md §6), and the
forward check's readings.
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


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _stages(log: str) -> dict:
    return {m.group(1): float(m.group(2))
            for m in re.finditer(r"^\[workflow\] (.+?): ([0-9.]+)s$", log, re.M)}


def run_and_compare(root, ranks: int, flags: list, env=None, timeout: float = 1500) -> dict:
    """The workflow CLI once in one process and once over ``ranks`` torchrun
    ranks (``--mesh data=ranks``); returns the stage seconds of both and
    the comparison of their trees."""
    from PIL import Image

    env = dict(os.environ, **(env or {}))
    one, many = os.path.join(root, "one"), os.path.join(root, "many")
    cli = ["-m", "univst_torch.cli.run_workflow", *flags]
    logs = {}
    for name, cmd, out, extra in (
            ("one", [sys.executable, *cli], one, {"CUDA_VISIBLE_DEVICES": "0"}),
            ("many", [sys.executable, "-m", "torch.distributed.run",
                      f"--nproc_per_node={ranks}", f"--master_port={_free_port()}", *cli,
                      "--mesh", f"data={ranks}"], many, {})):
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


def run_forward_pair(root, ranks: int, timeout: float = 900) -> dict:
    """:func:`forward_pair` on one card and over ``ranks`` torchrun ranks;
    returns both results."""
    out = {}
    for name, cmd, extra in (
            ("one", [sys.executable], {"CUDA_VISIBLE_DEVICES": "0"}),
            ("many", [sys.executable, "-m", "torch.distributed.run",
                      f"--nproc_per_node={ranks}", f"--master_port={_free_port()}"], {})):
        path = os.path.join(root, f"forward_{name}.pt")
        res = subprocess.run([*cmd, os.path.abspath(__file__), path], cwd=REPO,
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
    print(f"[nccl] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}: {out}")
    assert out["masks_equal_min"] >= 0.995

    sys.path.insert(0, REPO)
    import chip_smoke

    fwd = run_forward_pair(str(tmp_path), 4)
    got, want = fwd["many"], fwd["one"]
    readings = {}
    for name in ("inversion", "injected"):
        key = name + "_fp32"
        ref_err = chip_smoke._rel_rms(want[name], want[key])
        readings[name] = dict(err_over_tol32=chip_smoke._err_over_tol32(got[key], want[key]),
                              bf16_rel_rms=chip_smoke._rel_rms(got[name], want[name]),
                              ref_bf16_vs_fp32_rel_rms=ref_err,
                              bf16_ratio=chip_smoke._rel_rms(got[name], want[key]) / ref_err)
    print(f"[nccl] forward pair: {readings}")
    for name, r in readings.items():
        assert r["err_over_tol32"] <= 1.0, (name, r)
        assert r["bf16_ratio"] <= chip_smoke.MESH_BF16_RATIO, (name, r)


if __name__ == "__main__":
    forward_pair(sys.argv[1])
