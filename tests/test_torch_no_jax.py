"""The PyTorch port stands alone: every module of ``univst_torch`` imports
with JAX and the JAX package blocked, its CLIs answer ``--help``, and no
source of the port or ``chip_smoke.py`` imports ``jax``, ``flax`` or
``univst_tpu``."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "univst_torch")
BLOCKED = ("jax", "jaxlib", "flax", "univst_tpu")

_BLOCK = ("import sys\n"
          + "".join(f"sys.modules[{m!r}] = None\n" for m in BLOCKED))


def _modules():
    import univst_torch

    return sorted(m.name for m in pkgutil.walk_packages(univst_torch.__path__, "univst_torch."))


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for base, _, files in os.walk(PKG):
        out += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _run(code, *args):
    return subprocess.run([sys.executable, "-c", _BLOCK + code, *args], cwd=REPO,
                          capture_output=True, text=True, timeout=300)


def test_every_module_imports_without_jax():
    mods = _modules()
    assert "univst_torch.pipelines.sd" in mods and len(mods) > 20
    assert {"univst_torch.utils.profiling", "univst_torch.utils.flops",
            "univst_torch.models.lora", "univst_torch.models.sparse_controlnet",
            "univst_torch.models.group_norm",
            "univst_torch.distributed.mesh", "univst_torch.distributed.comm",
            "univst_torch.distributed.census", "univst_torch.distributed.tp",
            "univst_torch.bench"} <= set(mods)
    code = ("import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            f"assert not any(sys.modules.get(b) for b in {BLOCKED!r})\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("cli", ["run_workflow", "run_content_inversion_sd",
                                 "run_style_inversion_sd", "mask_propagation",
                                 "run_video_style_transfer_sd", "run_content_inversion_sd3",
                                 "run_style_inversion_sd3", "run_video_style_transfer_sd3",
                                 "run_content_inversion_animatediff",
                                 "run_style_inversion_animatediff",
                                 "run_video_style_transfer_animatediff", "cal_optical_flow"])
def test_cli_help_without_jax(cli):
    res = _run(f"import runpy; sys.argv = ['x', '--help']; "
               f"runpy.run_module('univst_torch.cli.{cli}', run_name='__main__')")
    assert res.returncode == 0, res.stderr
    assert "usage:" in res.stdout


def test_bench_help_without_jax():
    res = _run("import runpy; sys.argv = ['x', '--help']; "
               "runpy.run_module('univst_torch.bench', run_name='__main__')")
    assert res.returncode == 0, res.stderr
    assert "--families" in res.stdout


def test_no_source_imports_jax_or_the_jax_package():
    offenders = []
    for path in _sources():
        tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                if n.split(".")[0] in BLOCKED:
                    offenders.append(f"{os.path.relpath(path, REPO)}: {n}")
    assert not offenders, offenders


@pytest.mark.parametrize("backbone", ["animatediff", "sd3"])
def test_unported_backbones_raise_clearly(backbone, tmp_path):
    """Both backbones are ported now: the tiny workflow on the CPU writes the
    reference tree. AnimateDiff: ``[1, C, F, h, w]`` fp16 trajectories (the
    style inverted on every frame), the captured feature, F stylized PNGs.
    SD3: rank-4 trajectories (``[F, C, h, w]`` fp16; frames are SD3's
    batch)."""
    import torch

    from univst_torch.cli import run_workflow

    ex = os.path.join(REPO, "examples")
    ft = ["--ft_indices", "0", "--ft_timesteps", "0"] if backbone == "sd3" else [
        "--ft_timesteps", "501"]
    run_workflow.main(run_workflow.build_parser().parse_args([
        "--backbone", backbone, "--variant", "tiny", "--platform", "cpu", "--num_frames", "2",
        "--height", "32", "--width", "32", "--time_steps", "1" if backbone == "sd3" else "2",
        *ft, "--content_path", os.path.join(ex, "contents", "demo-fly-tiny"),
        "--style_path", os.path.join(ex, "styles", "tiny-00033.png"),
        "--mask_path", os.path.join(ex, "masks", "demo-fly-tiny.png"),
        "--output_root", str(tmp_path)]))
    shape = (2, 16, 16, 16) if backbone == "sd3" else (1, 4, 2, 16, 16)
    for stage, name in (("contents-inv", "demo-fly-tiny"), ("styles-inv", "tiny-00033")):
        for i in range(2):
            z = torch.load(tmp_path / stage / backbone / name / "inversion"
                           / f"ddim_latents_{i}.pt", weights_only=True)
            assert z.dtype == torch.float16 and tuple(z.shape) == shape
    if backbone == "animatediff":
        feat = torch.load(tmp_path / "contents-inv" / backbone / "demo-fly-tiny" / "features"
                          / "inversion_feature_map_2_block_501_step.pt", weights_only=True)
        assert feat.shape[0] == 2 and feat.float().abs().max() > 0
    out = tmp_path / "stylizations" / backbone / "demo-fly-tiny_tiny-00033"
    assert len(os.listdir(out)) == 2


def test_sd_transfer_falls_back_on_a_non_identical_style_trajectory(tmp_path):
    """A style trajectory whose frames differ (here the content inversion
    itself) is not cut to its first frame: the SD transfer CLI warns and
    stylizes by capture-and-inject (the JAX CLI's fallback)."""
    import numpy as np

    from univst_torch.cli import run_video_style_transfer_sd as st
    from univst_torch.core.trajectory import save_trajectory

    steps, f, size = 3, 2, 64
    content = np.random.default_rng(0).standard_normal((steps + 1, f, size // 8, size // 8, 4))
    inv = tmp_path / "ci" / "vid" / "inversion"
    save_trajectory(content.astype(np.float32), str(inv))
    argv = ["--variant", "tiny", "--num_frames", str(f), "--height", str(size), "--width",
            str(size), "--time_steps", str(steps), "--platform", "cpu", "--content_inv_path",
            str(inv), "--style_inv_path", str(inv), "--output_path", str(tmp_path / "st")]
    with pytest.warns(UserWarning, match="non-identical"):
        st.main(st.build_parser().parse_args(argv))
    assert len(os.listdir(tmp_path / "st" / "sd" / "vid_vid")) == f
