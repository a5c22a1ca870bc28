"""The SD3 weights bridge: ``flax_mmdit_to_state_dict`` /
``flax_t5_to_state_dict`` (and CLIP-G with its projection through
``flax_clip_to_state_dict``) emit exactly the keys and values of the
diffusers/transformers-layout checkpoints that
``univst_tpu/models/synth_ckpt.py::synth_mmdit`` / ``synth_t5`` /
``synth_clip_text`` write (through ``scripts/make_synthetic_checkpoints.py``),
the port's modules load them with ``strict=True``, and ``load_pretrained``
reads the SD3 subfolders. Exact comparisons: layout transforms only."""

import os
import sys

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

from univst_tpu.models import convert as jcv
from univst_tpu.models.clip_text import CLIPTextConfig as JCLIPCfg
from univst_tpu.models.mmdit import MMDiTConfig as JMMDiTCfg
from univst_tpu.models.t5 import T5Config as JT5Cfg
from univst_tpu.models.vae import VAEConfig as JVAECfg
from univst_torch.models import convert as tcv
from univst_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from univst_torch.models.mmdit import MMDiT, MMDiTConfig
from univst_torch.models.t5 import T5Config, T5Encoder
from univst_torch.models.vae import AutoencoderKL, VAEConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VAE_KW = dict(latent_channels=16, scaling_factor=1.5305, shift_factor=0.0609)

FAMILIES = {
    # subdir: (JAX converter, JAX cfg, port emitter, port module factory)
    "transformer": (jcv.convert_mmdit, JMMDiTCfg.tiny(), tcv.flax_mmdit_to_state_dict,
                    lambda: MMDiT(MMDiTConfig.tiny())),
    "vae": (jcv.convert_vae, JVAECfg.tiny(**VAE_KW), tcv.flax_vae_to_state_dict,
            lambda: AutoencoderKL(VAEConfig.tiny(**VAE_KW))),
    "text_encoder": (jcv.convert_clip_text, JCLIPCfg.tiny(projection_dim=16),
                     tcv.flax_clip_to_state_dict,
                     lambda: CLIPTextModel(CLIPTextConfig.tiny(projection_dim=16))),
    "text_encoder_2": (jcv.convert_clip_text, JCLIPCfg.tiny(projection_dim=16),
                       tcv.flax_clip_to_state_dict,
                       lambda: CLIPTextModel(CLIPTextConfig.tiny(projection_dim=16))),
    "text_encoder_3": (jcv.convert_t5, JT5Cfg.tiny(d_model=64), tcv.flax_t5_to_state_dict,
                       lambda: T5Encoder(T5Config.tiny(d_model=64))),
}


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import make_synthetic_checkpoints as msc
    finally:
        sys.path.pop(0)
    root = str(tmp_path_factory.mktemp("synth_sd3"))
    msc.make_sd3(root, "tiny", 4, 64)
    return root


def _weights(ckpt_dir, sub):
    path = tcv._find_weights(os.path.join(ckpt_dir, sub))
    assert path is not None and path.endswith(".safetensors")
    return path


@pytest.mark.parametrize("sub", sorted(FAMILIES))
def test_flax_to_state_dict_equals_the_sd3_checkpoint_layout(ckpt_dir, sub):
    """flax_*_to_state_dict(JAX converter(checkpoint)) == checkpoint, key for
    key and value for value; the port's module then loads it strictly. The
    MMDiT's persisted ``pos_embed.pos_embed`` is zeros on both sides: both
    packages recompute the table."""
    j_convert, jcfg, emit, make = FAMILIES[sub]
    sd = load_file(_weights(ckpt_dir, sub))
    mine = emit(j_convert(sd, jcfg), jcfg)
    assert sorted(mine) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(mine[k], sd[k], err_msg=k)
    make().load_state_dict(tcv.to_torch_state_dict(mine), strict=True)


def test_load_pretrained_reads_the_sd3_directory(ckpt_dir):
    from univst_torch.pipelines.sd3 import SD3VideoPipeline

    pipe = SD3VideoPipeline.build(pretrained_model_path=ckpt_dir, variant="tiny", num_frames=4,
                                  dtype=torch.float32, device="cpu")
    for sub, module in (("transformer", pipe.mmdit), ("vae", pipe.vae),
                        ("text_encoder", pipe.clip_l), ("text_encoder_2", pipe.clip_g),
                        ("text_encoder_3", pipe.t5)):
        sd = load_file(_weights(ckpt_dir, sub))
        state = module.state_dict()
        for k in sd:
            if k != "pos_embed.pos_embed":
                np.testing.assert_array_equal(state[k].numpy(), sd[k], err_msg=k)
    # T5's two tied embedding names are one table
    assert pipe.t5.shared.weight is pipe.t5.encoder.embed_tokens.weight
