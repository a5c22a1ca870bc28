"""The weights-day fire drill's CLI layer for the port: the torch CLIs with
``--pretrained_model_path`` at checkpoint DIRECTORIES in the released
layouts (diffusers ``unet`` / ``vae`` / ``transformer``, transformers
``text_encoder*``, the AnimateDiff ``mm.ckpt`` pickle), as
``tests/test_fire_drill.py`` drives the JAX CLIs. On the CPU, at tiny size,
with nothing downloaded.

The AnimateDiff and SD3 directories are the ones
``scripts/make_synthetic_checkpoints.py`` writes (its ``make_ad`` /
``make_sd3``; the JAX builds inside run under ``seeded_init``, which gives
them the init's shapes without XLA's compile of the init, and the values
written are ``synth_ckpt``'s own draws either way). The SD directory has
SD-2.1's topology at tiny widths (``_torch_parity.sd21_tiny_configs``:
linear ``proj_in`` / ``proj_out``, a wider GELU text encoder), written with
the same ``synth_ckpt`` functions and the script's ``_save``; the SD CLI
reaches it through ``--variant sd21`` with the variant's configs set to
those widths, as no tiny SD-2.1 variant exists in either package.

Checked: each CLI writes its trajectory files; the SD-2.1 workflow writes
the whole tree ({0, 255} masks, stylized frames); the checkpoint's values
are the ones the pipeline holds; a renamed key fails the strict load.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch
from PIL import Image

from _torch_parity import sd21_tiny_configs, seeded_init

FRAMES, SIZE, STEPS = 4, 64, 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX = os.path.join(REPO, "examples")
CONTENT = os.path.join(EX, "contents", "demo-fly-tiny")


def _script():
    spec = importlib.util.spec_from_file_location(
        "make_synth_ckpt", os.path.join(REPO, "scripts", "make_synthetic_checkpoints.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _make_sd21(msc, root: str):
    """An SD checkpoint directory of SD-2.1's topology at tiny widths."""
    import jax.numpy as jnp

    from univst_tpu.models import clip_text, synth_ckpt as sk, unet_sd
    from univst_tpu.pipelines.sd import SDVideoPipeline

    unet_cfg, clip_cfg = sd21_tiny_configs(unet_sd, clip_text)
    pipe = SDVideoPipeline.build(variant="tiny", num_frames=FRAMES, height=SIZE, width=SIZE,
                                 dtype=jnp.float32, unet_cfg=unet_cfg, clip_cfg=clip_cfg)
    msc._save(sk.synth_sd_unet(pipe.unet_params, pipe.unet.cfg), os.path.join(root, "unet"))
    msc._save(sk.synth_vae(pipe.vae_params, pipe.vae.cfg), os.path.join(root, "vae"))
    msc._save(sk.synth_clip_text(pipe.text_params, pipe.text_encoder.cfg),
              os.path.join(root, "text_encoder"), name="model.safetensors")


@pytest.fixture(scope="module")
def ckpt_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth_ckpt")
    msc = _script()
    with seeded_init(0):
        msc.make_ad(str(root / "ad"), "tiny", FRAMES, SIZE)
        msc.make_sd3(str(root / "sd3"), "tiny", FRAMES, SIZE)
        _make_sd21(msc, str(root / "sd21"))
    return root


@pytest.fixture
def sd21_variant(monkeypatch):
    """``--variant sd21`` builds SD-2.1's topology at the tiny widths (and
    the tiny temporal VAE) for the length of a test."""
    from univst_torch.models import clip_text, unet_sd
    from univst_torch.models.vae import VAEConfig

    unet_cfg, clip_cfg = sd21_tiny_configs(unet_sd, clip_text)
    monkeypatch.setattr(unet_sd.UNetSDConfig, "sd21", staticmethod(
        lambda **kw: dataclasses.replace(unet_cfg, **kw)))
    monkeypatch.setattr(clip_text.CLIPTextConfig, "sd21", staticmethod(
        lambda **kw: dataclasses.replace(clip_cfg, **kw)))
    monkeypatch.setattr(VAEConfig, "svd", staticmethod(
        lambda **kw: VAEConfig.tiny(temporal_decoder=True, **kw)))
    return unet_cfg, clip_cfg


def _common(variant: str, *extra):
    return ["--variant", variant, "--num_frames", str(FRAMES), "--height", str(SIZE),
            "--width", str(SIZE), "--time_steps", str(STEPS), "--platform", "cpu", *extra]


def _latents(path) -> torch.Tensor:
    z = torch.load(path, weights_only=True)
    assert torch.isfinite(z.float()).all()
    return z


def test_ad_cli_loads_synth_checkpoint_and_motion_module(ckpt_root, tmp_path):
    from univst_torch.cli import run_content_inversion_animatediff as ci

    ci.main(ci.build_parser().parse_args(_common(
        "tiny", "--pretrained_model_path", str(ckpt_root / "ad"),
        "--motion_module_path", str(ckpt_root / "ad" / "mm.ckpt"),
        "--content_path", CONTENT, "--output_path", str(tmp_path))))
    z = _latents(tmp_path / "animatediff" / "demo-fly-tiny" / "inversion"
                 / f"ddim_latents_{STEPS}.pt")
    assert z.shape[:3] == (1, 4, FRAMES)


def test_ad_motion_module_values_transported(ckpt_root):
    """The motion module's values from ``mm.ckpt`` and the 2D UNet's from
    ``unet/`` are the ones the built AnimateDiff UNet holds."""
    from safetensors.numpy import load_file

    from univst_torch.pipelines.animatediff import build_animatediff

    pipe = build_animatediff(pretrained_model_path=str(ckpt_root / "ad"),
                             motion_module_path=str(ckpt_root / "ad" / "mm.ckpt"),
                             variant="tiny", num_frames=FRAMES, dtype=torch.float32,
                             device="cpu")
    got = pipe.unet.state_dict()
    mm = torch.load(ckpt_root / "ad" / "mm.ckpt", weights_only=True)["state_dict"]
    key = next(k for k in sorted(mm) if k.endswith("proj_out.weight"))
    np.testing.assert_array_equal(got[key].numpy(), mm[key].numpy())
    unet = load_file(ckpt_root / "ad" / "unet" / "diffusion_pytorch_model.safetensors")
    np.testing.assert_array_equal(got["conv_in.weight"].numpy(), unet["conv_in.weight"])


def test_sd3_cli_loads_synth_checkpoint(ckpt_root, tmp_path):
    from univst_torch.cli import run_content_inversion_sd3 as ci

    ci.main(ci.build_parser().parse_args(_common(
        "tiny", "--pretrained_model_path", str(ckpt_root / "sd3"),
        "--content_path", CONTENT, "--output_path", str(tmp_path),
        "--ft_indices", "1", "--ft_timesteps", "1")))  # tiny has 2 blocks
    z = _latents(tmp_path / "sd3" / "demo-fly-tiny" / "inversion" / f"ddim_latents_{STEPS}.pt")
    assert z.shape[0] == FRAMES and z.shape[1] == 16  # SD3: [F, 16, h, w]


def test_sd21_workflow_cli_loads_synth_checkpoint(ckpt_root, sd21_variant, tmp_path):
    """``run_workflow --backbone sd --variant sd21`` on the SD-2.1-topology
    directory: the four stages write the reference tree."""
    from univst_torch.cli import run_workflow

    run_workflow.main(run_workflow.build_parser().parse_args(_common(
        "sd21", "--backbone", "sd", "--pretrained_model_path", str(ckpt_root / "sd21"),
        "--content_path", CONTENT, "--style_path", os.path.join(EX, "styles", "tiny-00033.png"),
        "--mask_path", os.path.join(EX, "masks", "demo-fly-tiny.png"), "--ft_timesteps", "501",
        "--output_root", str(tmp_path))))
    inv = tmp_path / "contents-inv" / "sd" / "demo-fly-tiny"
    assert _latents(inv / "inversion" / f"ddim_latents_{STEPS}.pt").shape[:3] == (1, 4, FRAMES)
    feat = _latents(inv / "features" / "inversion_feature_map_2_block_501_step.pt")
    assert feat.shape[0] == FRAMES and feat.float().abs().max() > 0
    for i in range(1, FRAMES):
        mask = np.asarray(Image.open(tmp_path / "masks" / "sd" / "demo-fly-tiny" / f"{i:05d}.png"))
        assert set(np.unique(mask)) <= {0, 255}
        frame = np.asarray(Image.open(tmp_path / "stylizations" / "sd"
                                      / "demo-fly-tiny_tiny-00033" / f"{i:05d}.png"))
        assert frame.dtype == np.uint8 and frame.shape[-1] == 3


def test_sd21_values_transported_and_drift_fails(ckpt_root, sd21_variant, tmp_path):
    """The SD-2.1-topology values land where they belong (the linear
    ``proj_in`` as ``[C, C]``, the 48-wide ``attn2.to_k``); a renamed key
    fails the strict load instead of keeping the random init."""
    import shutil

    from safetensors.numpy import load_file, save_file

    from univst_torch.pipelines.sd import SDVideoPipeline

    pipe = SDVideoPipeline.build(pretrained_model_path=str(ckpt_root / "sd21"), variant="sd21",
                                 num_frames=FRAMES, dtype=torch.float32, device="cpu")
    unet = load_file(ckpt_root / "sd21" / "unet" / "diffusion_pytorch_model.safetensors")
    got = pipe.unet.state_dict()
    for key in ("down_blocks.1.attentions.0.proj_in.weight",
                "up_blocks.2.attentions.1.transformer_blocks.0.attn2.to_k.weight"):
        assert unet[key].ndim == 2
        np.testing.assert_array_equal(got[key].numpy(), unet[key])
    text = load_file(ckpt_root / "sd21" / "text_encoder" / "model.safetensors")
    key = "text_model.encoder.layers.1.mlp.fc1.weight"
    np.testing.assert_array_equal(pipe.text_encoder.state_dict()[key].numpy(), text[key])

    drift = tmp_path / "drifted"
    shutil.copytree(ckpt_root / "sd21", drift)
    unet["down_blocks.0.attentions.0.proj_in.weight_RENAMED"] = unet.pop(
        "down_blocks.0.attentions.0.proj_in.weight")
    save_file(unet, drift / "unet" / "diffusion_pytorch_model.safetensors")
    with pytest.raises((KeyError, RuntimeError, ValueError)):
        SDVideoPipeline.build(pretrained_model_path=str(drift), variant="sd21",
                              num_frames=FRAMES, dtype=torch.float32, device="cpu")
