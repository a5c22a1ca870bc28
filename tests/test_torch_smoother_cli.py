"""The pixel smoother through the port's CLIs on the CPU, tiny config:
``run_workflow --smoother pixel`` (SD and AnimateDiff) writes the JAX
CLIs' output tree, with 21 steps so that smoothing step 20 runs (32 px,
the first-frame mask resized to match: the smoother keeps the masked
region at the frames' size, as the JAX package's does); the SD
transfer CLI refuses ``--flow raft`` without ``--raft_ckpt`` with the JAX
CLI's message, before it builds anything. Numerics are held against the
JAX package in ``test_torch_smoother.py``."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX = os.path.join(REPO, "examples")


@pytest.mark.parametrize("backbone", ["sd", "animatediff"])
def test_workflow_with_the_smoother_writes_the_reference_tree(backbone, tmp_path, monkeypatch):
    import univst_torch.methods.flow as flow_mod
    from univst_torch.cli import run_workflow

    calls = []
    smooth = flow_mod.sliding_window_smooth

    def counted(frames, *a, **kw):
        calls.append(tuple(frames.shape))
        return smooth(frames, *a, **kw)

    monkeypatch.setattr(flow_mod, "sliding_window_smooth", counted)
    f, steps = 2, 21
    (tmp_path / "m").mkdir()
    mask = tmp_path / "m" / "demo-fly-tiny.png"
    Image.open(os.path.join(EX, "masks", "demo-fly-tiny.png")).resize(
        (32, 32), Image.NEAREST).save(mask)
    run_workflow.main(run_workflow.build_parser().parse_args([
        "--backbone", backbone, "--variant", "tiny", "--platform", "cpu", "--num_frames", str(f),
        "--height", "32", "--width", "32", "--time_steps", str(steps), "--ft_timesteps", "1",
        "--content_path", os.path.join(EX, "contents", "demo-fly-tiny"),
        "--style_path", os.path.join(EX, "styles", "tiny-00033.png"),
        "--mask_path", str(mask), "--smoother", "pixel", "--output_root", str(tmp_path)]))
    assert calls == [(f, 32, 32, 3)]  # smoothing step 20 of the default [20, 25)
    for stage, name in (("contents-inv", "demo-fly-tiny"), ("styles-inv", "tiny-00033")):
        inv = tmp_path / stage / backbone / name / "inversion"
        assert sorted(os.listdir(inv)) == sorted(f"ddim_latents_{i}.pt" for i in range(steps + 1))
        z = torch.load(inv / "ddim_latents_0.pt", weights_only=True)
        assert z.dtype == torch.float16 and tuple(z.shape) == (1, 4, f, 16, 16)
    masks = tmp_path / "masks" / backbone / "demo-fly-tiny"
    assert sorted(p for p in os.listdir(masks) if p.endswith(".png")) == [
        "%05d.png" % i for i in range(f)]
    out = tmp_path / "stylizations" / backbone / "demo-fly-tiny_tiny-00033"
    assert sorted(os.listdir(out)) == ["%05d.png" % i for i in range(f)]
    frames = [np.asarray(Image.open(out / p)) for p in sorted(os.listdir(out))]
    assert all(x.shape == (32, 32, 3) and x.dtype == np.uint8 and x.std() > 0 for x in frames)


def test_flow_raft_needs_a_checkpoint(monkeypatch):
    from univst_torch.cli import common
    from univst_torch.cli import run_video_style_transfer_sd as st

    def no_build(*a, **kw):
        raise AssertionError("built a pipeline before checking the flags")

    monkeypatch.setattr(common, "build_pipeline_from_args", no_build)
    monkeypatch.setattr(st, "build_pipeline_from_args", no_build)
    args = st.build_parser().parse_args(["--smoother", "pixel", "--flow", "raft", "--platform",
                                         "cpu"])
    with pytest.raises(SystemExit, match="--flow raft requires --raft_ckpt"):
        st.main(args)
