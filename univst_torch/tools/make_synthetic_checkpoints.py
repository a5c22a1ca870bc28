"""Write checkpoint DIRECTORIES in the released layouts from the port's own
seeded weights: the counterpart of ``scripts/make_synthetic_checkpoints.py``.

    python -m univst_torch.tools.make_synthetic_checkpoints --root DIR \\
        [--variant tiny|sd15|sd21] [--families sd,ad,sd3] [--frames 4] \\
        [--size 64] [--platform cpu]

Every CLI takes ``--pretrained_model_path`` (and the AnimateDiff ones
``--motion_module_path``); this writes directories they load, with the
JAX script's files, file names, keys, shapes and dtypes:

    {root}/sd/{unet,vae}/diffusion_pytorch_model.safetensors
    {root}/sd/text_encoder/model.safetensors
    {root}/ad/... as sd/, + {root}/ad/mm.ckpt  (torch pickle: epoch,
        global_step, state_dict of the motion modules)
    {root}/sd3/{transformer,vae}/diffusion_pytorch_model.safetensors
    {root}/sd3/{text_encoder,text_encoder_2,text_encoder_3}/model.safetensors

The values are the port's seeded build (``SDVideoPipeline.build``,
``build_animatediff``, ``SD3VideoPipeline.build`` at ``seed=0``, fp32) on
the device: a directory holds the weights that a CLI builds without
``--pretrained_model_path`` on the same device, so loading it gives that
build back bit for bit. (The JAX script writes ``synth_ckpt``'s own numpy
draws; only the layouts agree across the two packages.) Where the released
layout differs from the modules' state dicts: the SVD VAE's scalar mix
factors are stored as ``[1]`` (diffusers' ``AlphaBlender``), and ``mm.ckpt``
carries each motion module's sinusoidal ``pos_encoder.pe`` table
``[1, 24, C]``, which the port recomputes and skips on load.

``--variant`` maps as in the JAX script: ``tiny`` gives every family its
tiny config; any other value is the SD family's variant (``sd15``,
``sd21``), with AnimateDiff-v2 and SD3-medium for the other two.
``--frames`` sets the pipelines' frame count and ``--size`` is accepted
for the JAX script's command line: the port's modules take any size, so
neither changes what is written. The device is the card unless
``--platform cpu``; files are written by :mod:`univst_torch.utils.safetensors`.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from univst_torch.models.convert import _is_motion_key
from univst_torch.utils.safetensors import save_file

UNET_FILE = "diffusion_pytorch_model.safetensors"
TEXT_FILE = "model.safetensors"


class Writer:
    """Writes the files of one run and keeps their count, bytes and the
    seconds spent writing (from the device's tensors to the closed file)."""

    def __init__(self):
        self.files, self.bytes, self.seconds = 0, 0, 0.0

    def save(self, sd, dirpath: str, name: str = UNET_FILE) -> None:
        os.makedirs(dirpath, exist_ok=True)
        path = os.path.join(dirpath, name)
        t0 = time.perf_counter()
        n = save_file(sd, path)
        self.seconds += time.perf_counter() - t0
        self.files, self.bytes = self.files + 1, self.bytes + n
        print(f"  {path}: {len(sd)} tensors", flush=True)

    def save_ckpt(self, sd, path: str) -> None:
        t0 = time.perf_counter()
        # released motion checkpoints are torch pickles
        torch.save({"epoch": 0, "global_step": 0,
                    "state_dict": {k: v.detach().to("cpu") for k, v in sd.items()}}, path)
        self.seconds += time.perf_counter() - t0
        self.files, self.bytes = self.files + 1, self.bytes + os.path.getsize(path)
        print(f"  {path}: {len(sd)} tensors", flush=True)


def released(module, keep=lambda key: True) -> dict:
    """``module``'s state dict in the released layout: scalar parameters as
    ``[1]`` (the SVD VAE's ``time_mixer.mix_factor``)."""
    return {k: v.reshape(1) if v.dim() == 0 else v
            for k, v in module.state_dict().items() if keep(k)}


def motion_state(unet) -> dict:
    """The motion modules' weights of an AnimateDiff UNet as ``mm_sd_v15_v2``
    holds them: with each attention's ``pos_encoder.pe`` table ``[1, L, C]``."""
    sd = released(unet, _is_motion_key)
    sd.update({k: v[None] for k, v in unet.named_buffers() if k.endswith("pos_encoder.pe")})
    return sd


def _save_sd_family(w: Writer, pipe, root: str) -> None:
    w.save(released(pipe.unet, lambda k: not _is_motion_key(k)), os.path.join(root, "unet"))
    w.save(released(pipe.vae), os.path.join(root, "vae"))
    w.save(released(pipe.text_encoder), os.path.join(root, "text_encoder"), TEXT_FILE)


def make_sd(w: Writer, root: str, variant: str, frames: int, device) -> None:
    from univst_torch.pipelines.sd import SDVideoPipeline

    pipe = SDVideoPipeline.build(variant=variant, num_frames=frames, dtype=torch.float32,
                                 seed=0, device=device)
    _save_sd_family(w, pipe, root)


def make_ad(w: Writer, root: str, variant: str, frames: int, device) -> None:
    from univst_torch.pipelines.animatediff import build_animatediff

    pipe = build_animatediff(variant=variant, num_frames=frames, dtype=torch.float32, seed=0,
                             device=device)
    _save_sd_family(w, pipe, root)
    w.save_ckpt(motion_state(pipe.unet), os.path.join(root, "mm.ckpt"))


def make_sd3(w: Writer, root: str, variant: str, frames: int, device) -> None:
    from univst_torch.pipelines.sd3 import SD3VideoPipeline

    pipe = SD3VideoPipeline.build(variant=variant, num_frames=frames, dtype=torch.float32,
                                  seed=0, device=device)
    w.save(released(pipe.mmdit), os.path.join(root, "transformer"))
    w.save(released(pipe.vae), os.path.join(root, "vae"))
    for sub, module in (("text_encoder", pipe.clip_l), ("text_encoder_2", pipe.clip_g),
                        ("text_encoder_3", pipe.t5)):
        w.save(released(module), os.path.join(root, sub), TEXT_FILE)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default="synth_ckpt")
    p.add_argument("--variant", default="tiny",
                   help="tiny (tests), or the SD family's full-width variant (sd15, sd21); "
                        "AnimateDiff-v2 and SD3-medium then write at full width")
    p.add_argument("--families", default="sd,ad,sd3")
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--size", type=int, default=64,
                   help="accepted for the JAX script's command line; no effect")
    p.add_argument("--platform", default=None, help="cpu: build on the CPU (default: the card)")
    return p


def main(argv=None) -> dict:
    """Write the directories; returns ``{"files", "bytes", "write_s"}``."""
    from univst_torch.cli.common import setup_device

    args = build_parser().parse_args(argv)
    device = setup_device(args.platform)
    tiny = args.variant == "tiny"
    variants = {"sd": args.variant, "ad": "tiny" if tiny else "ad",
                "sd3": "tiny" if tiny else "sd3"}
    makers = {"sd": make_sd, "ad": make_ad, "sd3": make_sd3}
    w = Writer()
    for fam in args.families.split(","):
        print(f"{fam}:", flush=True)
        makers[fam](w, os.path.join(args.root, fam), variants[fam], args.frames, device)
    print(f"synthetic checkpoints written under {args.root}: {w.files} files, "
          f"{w.bytes / 1e9:.3f} GB in {w.seconds:.2f}s of writing", flush=True)
    return dict(files=w.files, bytes=w.bytes, write_s=w.seconds)


if __name__ == "__main__":
    main()
