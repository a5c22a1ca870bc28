"""``univst_torch.tools.make_synthetic_checkpoints``, the port of
``scripts/make_synthetic_checkpoints.py``, at tiny size on the CPU.

Checked: for each of ``sd``, ``ad`` and ``sd3`` the port's tool writes the
JAX script's files, file names, key sets, shapes and dtypes (the JAX
script runs in process under ``seeded_init``, which gives its builds the
init's shapes without XLA's compile of the init); loading what the tool
wrote gives the seeded build back bit for bit, in fp32 and bf16 (the
loaded build draws its own random init from another seed first, so a key
that did not load would show); the tool refuses to fall back to the CPU.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

from _torch_parity import seeded_init
from univst_torch.tools import make_synthetic_checkpoints as msc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("sd", "ad", "sd3")


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "make_synth_ckpt", os.path.join(REPO, "scripts", "make_synthetic_checkpoints.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    jax_root, port_root = tmp_path_factory.mktemp("jax_ckpt"), tmp_path_factory.mktemp("port")
    script = _jax_script()
    with seeded_init(0):
        for fam in FAMILIES:
            getattr(script, f"make_{fam}")(str(jax_root / fam), "tiny", 4, 64)
    written = msc.main(["--root", str(port_root), "--platform", "cpu"])
    return jax_root, port_root, written


def _files(root):
    return sorted(os.path.relpath(os.path.join(base, f), root)
                  for base, _, names in os.walk(root) for f in names)


def _layout(path):
    if path.endswith(".safetensors"):
        return {k: (v.shape, v.dtype) for k, v in load_file(path).items()}
    ckpt = torch.load(path, weights_only=True)
    return dict(top=sorted(ckpt), **{k: (tuple(v.shape), v.dtype)
                                     for k, v in ckpt["state_dict"].items()})


@pytest.mark.parametrize("family", FAMILIES)
def test_tool_writes_the_jax_scripts_layout(roots, family):
    jax_root, port_root, _ = roots
    files = _files(jax_root / family)
    assert files == _files(port_root / family) and files
    for rel in files:
        want, got = _layout(str(jax_root / family / rel)), _layout(str(port_root / family / rel))
        assert sorted(got) == sorted(want), rel
        for k in want:
            assert got[k] == want[k], (rel, k)


def test_tool_reports_what_it_wrote(roots):
    _, port_root, written = roots
    files = _files(port_root)
    assert written["files"] == len(files) == 12
    assert written["bytes"] == sum(os.path.getsize(port_root / f) for f in files)
    assert written["write_s"] > 0


def _build(family, path, dtype, seed):
    from univst_torch.pipelines.animatediff import build_animatediff
    from univst_torch.pipelines.sd import SDVideoPipeline
    from univst_torch.pipelines.sd3 import SD3VideoPipeline

    kw = dict(variant="tiny", num_frames=4, dtype=dtype, seed=seed, device="cpu")
    if family == "sd":
        pipe = SDVideoPipeline.build(pretrained_model_path=path, **kw)
    elif family == "ad":
        pipe = build_animatediff(pretrained_model_path=path,
                                 motion_module_path=path and os.path.join(path, "mm.ckpt"), **kw)
    else:
        pipe = SD3VideoPipeline.build(pretrained_model_path=path, **kw)
        return {"mmdit": pipe.mmdit, "vae": pipe.vae, "clip_l": pipe.clip_l,
                "clip_g": pipe.clip_g, "t5": pipe.t5}
    return {"unet": pipe.unet, "vae": pipe.vae, "text_encoder": pipe.text_encoder}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("family", FAMILIES)
def test_load_after_write_gives_the_seeded_build_bit_for_bit(roots, family, dtype):
    _, port_root, _ = roots
    loaded = _build(family, str(port_root / family), dtype, seed=1)
    seeded = _build(family, None, dtype, seed=0)
    for name, module in seeded.items():
        want = dict(module.named_parameters()) | dict(module.named_buffers())
        got = dict(loaded[name].named_parameters()) | dict(loaded[name].named_buffers())
        assert list(got) == list(want), name
        for k, v in want.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), (family, name, k)


def test_motion_checkpoint_holds_the_released_tables(roots):
    """``mm.ckpt`` carries each motion attention's sinusoidal table
    ``[1, 24, C]`` (the loader skips it), and the VAE its mix factors as
    ``[1]``."""
    _, port_root, _ = roots
    mm = torch.load(port_root / "ad" / "mm.ckpt", weights_only=True)
    assert (mm["epoch"], mm["global_step"]) == (0, 0)
    pes = {k: v for k, v in mm["state_dict"].items() if k.endswith("pos_encoder.pe")}
    assert pes and all(v.shape[:2] == (1, 24) for v in pes.values())
    pe = next(iter(pes.values()))[0].double()
    np.testing.assert_allclose(pe[1, 0].item(), np.sin(1.0), rtol=1e-6)
    vae = load_file(port_root / "sd" / "vae" / "diffusion_pytorch_model.safetensors")
    mix = [v for k, v in vae.items() if k.endswith("mix_factor")]
    assert mix and all(v.shape == (1,) and v[0] == 0.5 for v in mix)


def test_tool_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        msc.main(["--root", str(tmp_path), "--families", "sd"])
    assert not os.listdir(tmp_path)
