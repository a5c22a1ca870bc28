"""The AnimateDiff weights bridge and loaders: ``flax_ad_unet_to_state_dict``
emits exactly the keys and values of the released layouts (the diffusers
``unet/`` of ``scripts/make_synthetic_checkpoints.py::make_ad`` plus its
``mm.ckpt`` motion pickle) and the port's UNet loads them strictly; the
port's ``build_animatediff`` on that directory computes what the JAX
package's computes on the same files; the motion loader refuses keys that
map nowhere; the port's copy of ``convert_ldm`` equals the JAX package's.

Exact comparisons for layouts and remaps (no arithmetic); the UNet output
at relative 1e-3 of its max (fp32, two frameworks).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

from _torch_parity import rel_err, seeded_init, t
from univst_tpu.models import convert as jcv
from univst_torch.models import convert as tcv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F, PX = 4, 64


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import make_synthetic_checkpoints as msc
    finally:
        sys.path.pop(0)
    root = str(tmp_path_factory.mktemp("synth_ad"))
    with seeded_init(0):
        msc.make_ad(root, "tiny", F, PX)
    return root


def _files(ckpt_dir):
    unet = load_file(tcv._find_weights(os.path.join(ckpt_dir, "unet")))
    mm = torch.load(os.path.join(ckpt_dir, "mm.ckpt"), weights_only=True)["state_dict"]
    return unet, {k: v.numpy() for k, v in mm.items()}


def _ad_unet():
    from univst_torch.models.unet_ad import UNetAnimateDiff, UNetADConfig

    return UNetAnimateDiff(UNetADConfig.tiny())


def test_flax_ad_unet_to_state_dict_equals_the_checkpoint_layout(ckpt_dir):
    """flax_ad_unet_to_state_dict(JAX converters(unet/ + mm.ckpt)) == the two
    files (less the motion pickle's ``pos_encoder.pe`` tables), key for key
    and value for value; the port's UNet loads it strictly."""
    from univst_tpu.models.unet_ad import UNetADConfig

    cfg = UNetADConfig.tiny()
    unet_sd, mm_sd = _files(ckpt_dir)
    tree = {**jcv.convert_ad_unet(unet_sd, cfg), **jcv.convert_motion_module(mm_sd, cfg)}
    mine = tcv.flax_ad_unet_to_state_dict(tree, cfg)
    want = {**unet_sd, **{k: v for k, v in mm_sd.items() if not k.endswith("pos_encoder.pe")}}
    assert sorted(mine) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(mine[k], want[k], err_msg=k)
    _ad_unet().load_state_dict(tcv.to_torch_state_dict(mine), strict=True)


def test_load_pretrained_reads_an_ad_unet_and_then_its_motion_modules(ckpt_dir):
    """``unet/`` carries no motion modules: load_pretrained accepts exactly
    that gap, and load_motion_module fills it from the .ckpt pickle (its
    weights nested under ``state_dict``)."""
    unet_sd, mm_sd = _files(ckpt_dir)
    m = _ad_unet()
    tcv.load_pretrained(ckpt_dir, unet=m)
    tcv.load_motion_module(m, os.path.join(ckpt_dir, "mm.ckpt"))
    state = m.state_dict()
    for k, v in list(unet_sd.items()) + list(mm_sd.items()):
        if not k.endswith("pos_encoder.pe"):
            np.testing.assert_array_equal(state[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("fault", ["stray", "missing"])
def test_load_motion_module_is_strict(ckpt_dir, tmp_path, fault):
    _, mm_sd = _files(ckpt_dir)
    key = "down_blocks.0.motion_modules.0.temporal_transformer.proj_in.bias"
    if fault == "stray":
        mm_sd["down_blocks.0.motion_modules.0.temporal_transformer.bogus.weight"] = mm_sd[key]
    else:
        mm_sd.pop(key)
    path = str(tmp_path / "mm.ckpt")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in mm_sd.items()}}, path)
    with pytest.raises(RuntimeError, match="bogus" if fault == "stray" else "proj_in.bias"):
        tcv.load_motion_module(_ad_unet(), path)


def test_build_animatediff_on_the_checkpoint_matches_jax(ckpt_dir):
    """The weights-day drill: both packages' ``build_animatediff`` on the
    same ``unet/``, ``vae/``, ``text_encoder/`` and ``mm.ckpt`` give the same
    UNet output (through the motion modules) and the same text context."""
    import jax

    from univst_tpu.models.layers import VideoCtx as JVideoCtx
    from univst_tpu.pipelines.animatediff import build_animatediff as j_build
    from univst_torch.models.layers import VideoCtx
    from univst_torch.pipelines.animatediff import build_animatediff

    mm = os.path.join(ckpt_dir, "mm.ckpt")
    # every weight comes from the files: the JAX build function's random init is
    # overwritten, so it is stood in for (seeded_init) instead of compiled
    with seeded_init(1):
        jp = j_build(pretrained_model_path=ckpt_dir, motion_module_path=mm, variant="tiny",
                     num_frames=F, height=PX, width=PX, dtype=jnp.float32)
    tp = build_animatediff(pretrained_model_path=ckpt_dir, motion_module_path=mm,
                           variant="tiny", num_frames=F, dtype=torch.float32, device="cpu")
    assert tp.style_singleton is False and tp.schedule.cfg.beta_schedule == "linear"
    rng = np.random.default_rng(0)
    x = rng.standard_normal((F, PX // 8, PX // 8, 4)).astype(np.float32)
    jctx, tctx = jp.encode_text(""), tp.encode_text("")
    assert rel_err(tctx, jctx) < 1e-5
    want, _ = jax.jit(jp.unet.apply)({"params": jp.unet_params}, jnp.asarray(x),
                                     jnp.asarray(301), jctx, JVideoCtx(F, ()))
    with torch.no_grad():
        got, _ = tp.unet(t(x), 301, tctx, VideoCtx(F, ()))
    assert rel_err(got, want) < 1e-3


def _synthetic_ldm_vae(rng):
    """An LDM VAE key set of two levels (values are placeholders)."""
    sd = {}

    def add(name, shape=(2,)):
        sd[name + ".weight"] = rng.standard_normal(shape).astype(np.float32)
        sd[name + ".bias"] = rng.standard_normal((shape[0],)).astype(np.float32)

    def resnet(p):
        for n, s in (("norm1", (2,)), ("conv1", (2, 2, 3, 3)), ("norm2", (2,)),
                     ("conv2", (2, 2, 3, 3))):
            add(f"{p}.{n}", s)

    def attn(p):
        add(p + ".norm")
        for q in ("q", "k", "v", "proj_out"):
            add(f"{p}.{q}", (2, 2, 1, 1))

    add("encoder.conv_in", (2, 3, 3, 3))
    for i in range(2):
        for j in range(2):
            resnet(f"encoder.down.{i}.block.{j}")
    add("encoder.down.0.downsample.conv", (2, 2, 3, 3))
    resnet("encoder.mid.block_1")
    attn("encoder.mid.attn_1")
    resnet("encoder.mid.block_2")
    add("encoder.norm_out")
    add("encoder.conv_out", (8, 2, 3, 3))
    add("quant_conv", (8, 8, 1, 1))
    add("decoder.conv_in", (2, 4, 3, 3))
    resnet("decoder.mid.block_1")
    attn("decoder.mid.attn_1")
    resnet("decoder.mid.block_2")
    for i in range(2):
        for j in range(3):
            resnet(f"decoder.up.{i}.block.{j}")
    add("decoder.up.1.upsample.conv", (2, 2, 3, 3))
    add("decoder.norm_out")
    add("decoder.conv_out", (3, 2, 3, 3))
    add("post_quant_conv", (4, 4, 1, 1))
    return {f"first_stage_model.{k}": v for k, v in sd.items()}


def _lora_case(rng, stems):
    """A base weight dict with the given ``{key stem: shape}`` and a rank-2
    webui LoRA on each (``lora_te_`` for the text encoder's keys)."""
    base, lora = {}, {}
    for stem, shape in stems.items():
        base[stem + ".weight"] = rng.standard_normal(shape).astype(np.float32)
        name = ("lora_te_" if stem.startswith("text") else "lora_unet_") + stem.replace(".", "_")
        lora[name + ".lora_up.weight"] = rng.standard_normal(
            (shape[0], 2) + shape[2:]).astype(np.float32)
        lora[name + ".lora_down.weight"] = rng.standard_normal(
            (2, shape[1]) + shape[2:]).astype(np.float32)
    return base, lora


def test_merge_lora_where_the_jax_package_raises():
    """W + alpha * up @ down on the targets the JAX package's merge cannot
    reach: 1x1 convs (its einsum names an axis '1'), a feed-forward and a
    text-encoder layer (it joins 'ff.net' and 'encoder.layers')."""
    from univst_torch.models.convert_ldm import merge_lora

    base, lora = _lora_case(np.random.default_rng(1), {
        "up_blocks.1.attentions.0.proj_in": (4, 4, 1, 1),
        "down_blocks.0.resnets.0.conv_shortcut": (6, 4, 1, 1),
        "up_blocks.1.attentions.0.transformer_blocks.0.ff.net.0.proj": (8, 4),
        "text_model.encoder.layers.0.self_attn.q_proj": (4, 4)})
    out = merge_lora(base, lora, alpha=0.7)
    for k, w in base.items():
        stem = ("lora_te_" if k.startswith("text") else "lora_unet_") + k[:-7].replace(".", "_")
        up, down = lora[stem + ".lora_up.weight"], lora[stem + ".lora_down.weight"]
        delta = up.reshape(up.shape[0], -1) @ down.reshape(2, -1)
        np.testing.assert_allclose(out[k], w + 0.7 * delta.reshape(w.shape), rtol=1e-6,
                                   atol=1e-6)


def _ldm_case(fn, rng):
    """(JAX output, port output) of one convert_ldm function."""
    from test_convert_ldm import _synthetic_ldm_unet

    from univst_tpu.models import convert_ldm as jl
    from univst_torch.models import convert_ldm as tl

    if fn == "merge_lora":  # the targets the JAX package's merge reaches
        base, lora = _lora_case(rng, {
            "up_blocks.1.attentions.0.transformer_blocks.0.attn1.to_q": (4, 4),
            "mid_block.attentions.0.transformer_blocks.0.attn2.to_out.0": (6, 4),
            "down_blocks.1.resnets.0.time_emb_proj": (4, 8)})
        return jl.merge_lora(base, lora, alpha=0.7), tl.merge_lora(base, lora, alpha=0.7)
    if fn == "ldm_clip_to_hf":
        sd = {"cond_stage_model.transformer.text_model.final_layer_norm.weight": np.ones(2),
              "cond_stage_model.transformer.text_model.embeddings.position_ids": np.ones(2),
              "cond_stage_model.transformer.text_model.encoder.layers.0.mlp.fc1.bias":
              rng.standard_normal(3), "model.diffusion_model.out.0.weight": np.ones(2)}
    elif fn == "ldm_vae_to_diffusers":
        sd = _synthetic_ldm_vae(rng)
    else:
        sd = _synthetic_ldm_unet(rng)
    return getattr(jl, fn)(sd), getattr(tl, fn)(sd)


@pytest.mark.parametrize("fn", ["ldm_unet_to_diffusers", "ldm_vae_to_diffusers",
                                "ldm_clip_to_hf", "merge_lora"])
def test_convert_ldm_equals_jax(fn):
    want, got = _ldm_case(fn, np.random.default_rng(0))
    assert sorted(got) == sorted(want) and len(got) > 0
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
