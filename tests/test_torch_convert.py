"""The weights bridge: the port's ``flax_*_to_state_dict`` emit exactly the
keys and values of the diffusers/transformers-layout checkpoints
(``univst_tpu/models/synth_ckpt.py``, written to disk by
``scripts/make_synthetic_checkpoints.py``), the port's modules load them
with ``strict=True``, and ``load_pretrained`` reads such a directory.
Exact comparisons: these are layout transforms, no arithmetic."""

import os
import sys

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

from univst_tpu.models import convert as jcv
from univst_tpu.models.clip_text import CLIPTextConfig as JCLIPCfg
from univst_tpu.models.unet_sd import UNetSDConfig as JUNetCfg
from univst_tpu.models.vae import VAEConfig as JVAECfg
from univst_torch.models import convert as tcv
from univst_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from univst_torch.models.unet_sd import UNetPseudo3D, UNetSDConfig
from univst_torch.models.vae import AutoencoderKL, VAEConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FAMILIES = {
    # subdir: (JAX converter, JAX cfg, port emitter, port module factory)
    "unet": (jcv.convert_sd_unet, JUNetCfg.tiny(temporal_identity=True),
             tcv.flax_unet_to_state_dict, lambda: UNetPseudo3D(UNetSDConfig.tiny())),
    "vae": (jcv.convert_vae, JVAECfg.tiny(temporal_decoder=True), tcv.flax_vae_to_state_dict,
            lambda: AutoencoderKL(VAEConfig.tiny(temporal_decoder=True))),
    "text_encoder": (jcv.convert_clip_text, JCLIPCfg.tiny(), tcv.flax_clip_to_state_dict,
                     lambda: CLIPTextModel(CLIPTextConfig.tiny())),
}


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import make_synthetic_checkpoints as msc
    finally:
        sys.path.pop(0)
    root = str(tmp_path_factory.mktemp("synth_ckpt"))
    msc.make_sd(root, "tiny", 4, 64)
    return root


def _weights(ckpt_dir, sub):
    path = tcv._find_weights(os.path.join(ckpt_dir, sub))
    assert path is not None and path.endswith(".safetensors")
    return path


@pytest.mark.parametrize("sub", sorted(FAMILIES))
def test_flax_to_state_dict_equals_the_checkpoint_layout(ckpt_dir, sub):
    """flax_*_to_state_dict(JAX converter(checkpoint)) == checkpoint, key for
    key and value for value; the port's module then loads it strictly."""
    j_convert, jcfg, emit, make = FAMILIES[sub]
    sd = load_file(_weights(ckpt_dir, sub))
    mine = emit(j_convert(sd, jcfg), jcfg)
    assert sorted(mine) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(mine[k], sd[k], err_msg=k)
    make().load_state_dict(tcv.to_torch_state_dict(mine), strict=True)


def test_load_pretrained_reads_the_synthetic_directory(ckpt_dir):
    from univst_torch.pipelines.sd import SDVideoPipeline

    pipe = SDVideoPipeline.build(pretrained_model_path=ckpt_dir, variant="tiny", num_frames=4,
                                 dtype=torch.float32, device="cpu")
    for sub, module in (("unet", pipe.unet), ("vae", pipe.vae),
                        ("text_encoder", pipe.text_encoder)):
        sd = load_file(_weights(ckpt_dir, sub))
        state = module.state_dict()
        for k in sd:
            np.testing.assert_array_equal(state[k].numpy(), sd[k], err_msg=k)


def test_load_pretrained_is_strict(ckpt_dir, tmp_path):
    sd = load_file(_weights(ckpt_dir, "vae"))
    sd.pop("decoder.conv_out.bias")
    os.makedirs(tmp_path / "vae")
    save_file(sd, str(tmp_path / "vae" / "diffusion_pytorch_model.safetensors"))
    with pytest.raises(RuntimeError, match="conv_out.bias"):
        tcv.load_pretrained(str(tmp_path), vae=FAMILIES["vae"][3]())
