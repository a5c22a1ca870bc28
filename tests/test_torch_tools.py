"""The port's tools (``univst_torch/tools/``) on the CPU at tiny size.

* ``compare_outputs`` against ``scripts/compare_outputs.py`` on the same
  seeded PNG directories, ``.pt`` latents and LPIPS weight files: the same
  JSON (to 1e-6) and the same exit code, for a plain comparison, a passing
  gate, a violated gate, a gate that cannot be evaluated, latents and LPIPS.
* The stage timers' pieces, run in order, give ``stylize_latents``' output
  bit for bit: ``bench_stages.Workload`` on the tiny SD pipeline (both
  phases), ``bench_sd3_anatomy.SD3Workload`` on the tiny SD3 one.
* Each timing tool's JSON line (its ``main`` on the CPU): its rows, all
  finite and positive, and its device.
* The ``start_*.sh`` recipes: every command line, with the default
  environment and with every variable set, names a ``univst_torch.cli``
  module and parses through that module's ``build_parser()``; no line names
  the JAX package.
"""

import importlib
import importlib.util
import json
import math
import os
import subprocess

import numpy as np
import pytest
import torch
from PIL import Image

import _torch_parity  # noqa: F401  (gives this worker's torch its share of the cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "univst_torch", "tools")


# -- compare_outputs ----------------------------------------------------------------


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """Two seeded 3-frame 64 px PNG directories, a 1-frame-shorter one,
    two fp16 trajectory files and random LPIPS weight files in the
    torchvision / lpips-release layouts."""
    from univst_torch.utils.lpips import random_lpips_params

    root = tmp_path_factory.mktemp("outputs")
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (3, 64, 64, 3)).astype(np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-12, 13, a.shape), 0, 255).astype(np.uint8)
    for name, stack in (("a", a), ("b", b), ("short", b[:2])):
        (root / name).mkdir()
        for i, frame in enumerate(stack):
            Image.fromarray(frame).save(root / name / f"{i:05d}.png")
    for name in ("za", "zb"):
        torch.save(torch.tensor(rng.standard_normal((4, 8, 8, 4)), dtype=torch.float16),
                   root / f"{name}.pt")
    sd = random_lpips_params(5).state_dict()
    torch.save({k: v for k, v in sd.items() if k.startswith("features.")}, root / "alex.pth")
    torch.save({k: v for k, v in sd.items() if k.startswith("lin")}, root / "lin.pth")
    return root


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "_jax_compare_outputs", os.path.join(REPO, "scripts", "compare_outputs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _exit_code(fn):
    """``fn``'s exit code as a process would report it."""
    try:
        code = fn()
    except SystemExit as e:
        code = e.code
    return 1 if isinstance(code, str) else int(code or 0)


COMPARE_CASES = {
    "plain": ["{a}", "{b}", "--json"],
    "gates_pass": ["{a}", "{b}", "--json", "--psnr-min", "20", "--ssim-min", "0.5"],
    "psnr_violated": ["{a}", "{b}", "--json", "--psnr-min", "40"],
    "lpips_unevaluable": ["{a}", "{b}", "--json", "--lpips-max", "0.5"],
    "lpips": ["{a}", "{b}", "--json", "--lpips-alexnet", "{alex}", "--lpips-lin", "{lin}",
              "--lpips-max", "10"],
    "lpips_violated": ["{a}", "{b}", "--json", "--lpips-alexnet", "{alex}", "--lpips-lin",
                       "{lin}", "--lpips-max", "0"],
    "latents": ["--latents", "{za}", "{zb}", "--json"],
    "latents_psnr_gate": ["--latents", "{za}", "{zb}", "--json", "--psnr-min", "1"],
    "frame_count_mismatch": ["{a}", "{short}", "--json"],
}


@pytest.mark.parametrize("case", sorted(COMPARE_CASES))
def test_compare_outputs_matches_the_jax_script(case, outputs, monkeypatch, capsys):
    from univst_torch.tools import compare_outputs

    paths = {k: str(outputs / v) for k, v in dict(
        a="a", b="b", short="short", za="za.pt", zb="zb.pt", alex="alex.pth",
        lin="lin.pth").items()}
    argv = [x.format(**paths) for x in COMPARE_CASES[case]]
    jax_main = _jax_script().main
    monkeypatch.setattr("sys.argv", ["compare_outputs.py"] + argv)
    want_code = _exit_code(jax_main)
    want = capsys.readouterr().out
    got_code = _exit_code(lambda: compare_outputs.main(argv + ["--device", "cpu"]))
    got = capsys.readouterr().out
    assert got_code == want_code
    assert want_code == {"psnr_violated": 1, "lpips_unevaluable": 1, "lpips_violated": 1,
                         "latents_psnr_gate": 1, "frame_count_mismatch": 1}.get(case, 0)
    want_lines, got_lines = want.splitlines(), got.splitlines()
    assert len(got_lines) == len(want_lines)
    if want_lines:
        w, g = json.loads(want_lines[-1]), json.loads(got_lines[-1])
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-6, atol=1e-6, err_msg=k)
        assert ("lpips_mean" in g) == (case in ("lpips", "lpips_violated"))


# -- the stage timers' pieces --------------------------------------------------------


def test_stage_pieces_reproduce_stylize_latents_bit_for_bit():
    """``bench_stages.Workload`` on the tiny SD pipeline at 28 steps (phase 1
    the shift window's 26, phase 2 two): the pre-pass, the phase-1 segment
    and the phase-2 segment, in order, equal ``stylize_latents``."""
    from univst_torch.pipelines.sd import SDVideoPipeline
    from univst_torch.tools.bench_stages import Workload

    pipe = SDVideoPipeline.build(variant="tiny", num_frames=2, dtype=torch.float32, seed=0,
                                 device="cpu")
    w = Workload.build(pipe, steps=28, size=64, seed=1)
    assert w.phase1 == [(0, 26)] and w.phase2 == [(26, 2)] and w.k1 == 26
    assert torch.equal(w.pieces(), w.stylize())


@pytest.mark.parametrize("chunk", [2, 50])
def test_sd3_segments_reproduce_stylize_latents_bit_for_bit(chunk):
    """``bench_sd3_anatomy.SD3Workload`` on the tiny SD3 pipeline at 33
    steps (phase 1 the window's 31, phase 2 two), in segments of ``chunk``
    steps: equal to ``stylize_latents``."""
    from univst_torch.pipelines.sd3 import SD3VideoPipeline
    from univst_torch.tools.bench_sd3_anatomy import SD3Workload

    pipe = SD3VideoPipeline.build(variant="tiny", num_frames=2, dtype=torch.float32, seed=0,
                                  device="cpu")
    context, pooled = pipe.encode_prompt("")
    w = SD3Workload.build(pipe, 33, 64, context, pooled, seed=2)
    assert w.phase1 == [(0, 31)] and w.phase2 == [(31, 2)]
    assert torch.equal(w.pieces(chunk), w.stylize())


# -- the JSON lines ------------------------------------------------------------------


def _small_sd(device):
    from univst_torch.pipelines.sd import SDVideoPipeline

    pipe = SDVideoPipeline.build(variant="tiny", num_frames=2, dtype=torch.float32, seed=0,
                                 device=device)
    return pipe, 64, 4


TOOL_RUNS = {
    "bench_stages": ("bench_stages", []),
    "bench_anatomy": ("bench_anatomy", []),
    "sd3_segments": ("bench_sd3_anatomy", ["--probe", "segments", "--segment_steps", "1"]),
    "sd3_attn": ("bench_sd3_anatomy", ["--probe", "attn"]),
    "sd3_matmul": ("bench_sd3_anatomy", ["--probe", "matmul"]),
}


def _finite_positive(tree, path=""):
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _finite_positive(v, f"{path}.{k}")]
    return [] if isinstance(tree, float) and math.isfinite(tree) and tree > 0 else [path]


@pytest.mark.parametrize("run", sorted(TOOL_RUNS))
def test_tool_json_line_has_finite_rows(run, tmp_path, monkeypatch, capsys):
    name, extra = TOOL_RUNS[run]
    mod = importlib.import_module(f"univst_torch.tools.{name}")
    if name in ("bench_stages", "bench_anatomy"):
        # the bench's CPU smoke workload at 2 frames and 4 steps
        monkeypatch.setattr("univst_torch.tools.bench_stages.build_pipe", _small_sd)
    argv = ["--device", "cpu", "--reps", "1"] + extra
    if name == "bench_stages" or run == "sd3_segments":
        argv += ["--trace_dir", str(tmp_path)]
    assert mod.main(argv) == 0
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["tool"] == name and line["device"]["name"] == "cpu"
    assert line["rows"] and not _finite_positive(line["rows"])
    if name == "bench_stages":
        assert set(line["rows"]) >= {"prepass", "phase1 seg", "chunked decode + transfer",
                                     "full stylize+decode+transfer", "closure"}
        assert math.isfinite(line["closure_ratio"]) and not _finite_positive(line["marks"])
        assert set(line["device_split"]) == {"prepass", "phase1 step",
                                             "chunked decode + transfer"}
        assert not line["device_split"]["prepass"]["device_time_seen"]  # no card here
    elif name == "bench_anatomy":
        assert len(line["attn_paths"]) == 12
        assert all(p["k1_launches"] == 0 for p in line["attn_paths"].values())
    elif run == "sd3_segments":
        assert set(line["device_split"]) == {"phase1 step", "phase2 step"}
        assert line["device_split"]["phase1 step"]["idle_share_untraced"] is None  # no card
        assert len(line["outputs"]) == 2
        assert all(o["finite"] and o["shape"] == [4, 8, 8, 16] for o in line["outputs"].values())
        # the CPU runs each kernel's plain version, which counts no launch
        assert [v.get("k2 a step", v.get("k2")) for v in line["launches"].values()] == [0] * 5
    elif run == "sd3_attn":
        assert all(c["err_over_tol"] <= 1.0 for c in line["cases"].values())


def test_anatomy_takes_its_chunk_rows_from_the_stage_timer():
    """``bench_anatomy.measure`` given ``bench_stages.measure``'s result on
    the same pipeline and workload copies its pre-pass and chunk rows (it
    times the same calls); a result of another workload is refused."""
    from univst_torch.tools import bench_anatomy, bench_stages

    pipe, size, steps = _small_sd("cpu")
    stages = bench_stages.measure(pipe, steps, size, seed=0, reps=1)
    line = bench_anatomy.measure(pipe, steps, size, seed=0, reps=1, stages=stages)
    assert line["chunk_rows"] == "bench_stages"
    rows = line["rows"]
    assert rows["style pre-pass (batch k1 single-frame fwd)"] == stages["rows"]["prepass"]
    assert rows[f"phase1 chunk ({steps} steps, batch 4)"] == stages["rows"]["phase1 seg"]
    assert (rows[f"phase1 chunk ({steps} steps, batch 4) per step"]
            == stages["rows"]["phase1 seg per step"])
    assert set(stages["marks"]) == {"prepass", "phase1 seg", "decode (sync'd, no transfer)"}
    assert not _finite_positive(rows) and not _finite_positive(stages["marks"])
    with pytest.raises(ValueError, match="another workload"):
        bench_anatomy.measure(pipe, steps, size, seed=1, reps=1, stages=stages)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_err_over_tol_is_the_kernel_checks_bar(dtype):
    """``univst_torch.tools.err_over_tol``: 0 on equal tensors, at most 1
    within the bar (fp32 1e-5; bf16 2**-6 relative plus 0.02 x the rms),
    above 1 past it, infinite on a NaN."""
    from univst_torch.tools import err_over_tol

    want = torch.randn(64, 64, generator=torch.Generator().manual_seed(0)).to(dtype)
    assert err_over_tol(want, want) == 0.0
    rel = 1e-5 if dtype == torch.float32 else 2.0**-6
    near = want.float() * (1 + 0.5 * rel)
    far = want.float() * (1 + 4 * rel) + 0.1
    assert err_over_tol(near, want) <= 1.0 < err_over_tol(far, want)
    nan = want.float().clone()
    nan[3, 5] = float("nan")
    assert err_over_tol(nan, want) == float("inf")


def test_tools_without_a_card_exit_nonzero(monkeypatch, capsys):
    from univst_torch.tools import bench_anatomy, bench_sd3_anatomy, bench_stages

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (bench_stages, bench_anatomy, bench_sd3_anatomy):
        assert mod.main([]) == 2
    out = capsys.readouterr()
    assert not out.out and "no CUDA device" in out.err


# -- the recipes ---------------------------------------------------------------------

RECIPES = ("start_sd.sh", "start_animatediff.sh", "start_sd3.sh")
SET_ENV = dict(PRETRAINED="/ckpt/dir", MOTION_MODULE="/ckpt/mm.ckpt", PLATFORM="cpu",
               ARGS="--num_frames 4 --height 64 --width 64 --time_steps 10",
               CONTENT="/data/clip", STYLE="/data/style.png", MASK="/data/mask.png")


def _recorded_commands(recipe: str, env: dict, tmp_path) -> list:
    """Run ``recipe`` with ``PYTHON`` a stand-in that records its arguments."""
    log = tmp_path / "calls"
    shim = tmp_path / "python"
    shim.write_text("#!/usr/bin/env bash\n"
                    "for a in \"$@\"; do printf '%s\\x1f' \"$a\"; done >> \"$CALLS\"\n"
                    "echo >> \"$CALLS\"\n")
    shim.chmod(0o755)
    base = {k: v for k, v in os.environ.items() if k not in SET_ENV}
    res = subprocess.run(["bash", os.path.join(TOOLS, recipe)], cwd=tmp_path,
                         env=dict(base, **env, PYTHON=str(shim), CALLS=str(log)),
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    return [ln.split("\x1f")[:-1] for ln in log.read_text().splitlines()]


@pytest.mark.parametrize("env", ["default", "set"])
@pytest.mark.parametrize("recipe", RECIPES)
def test_recipe_lines_parse_through_the_port_clis(recipe, env, tmp_path):
    text = open(os.path.join(TOOLS, recipe)).read()
    assert "univst_tpu" not in text
    calls = _recorded_commands(recipe, SET_ENV if env == "set" else {}, tmp_path)
    backbone = {"start_sd.sh": "sd", "start_animatediff.sh": "animatediff",
                "start_sd3.sh": "sd3"}[recipe]
    stages = ["run_content_inversion", "run_style_inversion", "mask_propagation",
              "run_video_style_transfer"]
    assert [c[1].rsplit(".", 1)[-1].replace(f"_{backbone}", "") for c in calls] == stages
    for call in calls:
        assert call[0] == "-m" and call[1].startswith("univst_torch.cli.")
        args = importlib.import_module(call[1]).build_parser().parse_args(call[2:])
        if env == "set":
            assert args.platform == "cpu"
        if call[1].endswith("mask_propagation"):
            assert args.backbone == backbone
            assert args.feature_path.startswith(f"results/contents-inv/{backbone}/")
            assert env == "set" or os.path.exists(args.mask_path)
            continue
        if env == "set":
            assert (args.pretrained_model_path, args.num_frames, args.height) == (
                "/ckpt/dir", 4, 64)
            if backbone == "animatediff":
                assert args.motion_module_path == "/ckpt/mm.ckpt"
        else:
            assert args.pretrained_model_path is None and args.platform is None
            for path in ("content_path", "style_path"):
                assert os.path.exists(getattr(args, path, None) or REPO), path


def test_every_tool_has_its_jax_counterpart():
    """``univst_torch.tools.TOOLS`` names every tool of the directory and a
    JAX script that exists."""
    from univst_torch import tools

    for script in tools.TOOLS.values():
        assert os.path.exists(os.path.join(REPO, script)), script
    assert set(tools.TOOLS) == {f for f in os.listdir(TOOLS) if f.endswith(".sh")} | {
        f[:-3] for f in os.listdir(TOOLS) if f.endswith(".py") and f != "__init__.py"}
