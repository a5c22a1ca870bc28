"""The SD pipeline off the style-singleton path: capture-and-inject, what
the SD transfer CLI falls back to on a style trajectory whose frames differ,
against the JAX package's, on the tiny SD config (4 frames, 64 px, fp32,
CPU; K1's plain version), with the JAX pipeline's weights (drawn by
``seeded_init(0)``) carried across with strict loads. A 6-step window config runs both phases (steps
0-3 injected, 4-5 stylized-only); mask blend and AdaIN re-anchor on.

Tolerance: relative 1e-3 of the max (two fp32 frameworks over the DDIM
steps, as ``test_torch_pipeline.py`` states it).
"""

import dataclasses

import jax.numpy as jnp
import torch

from _torch_parity import rel_err, seeded_init
from test_torch_ad_pipeline import F, N, PX, _carry, _shift, _stylize_inputs


def test_sd_non_singleton_stylize_matches_jax():
    from univst_tpu.core.adain import latent_adain as j_latent_adain
    from univst_tpu.core.config import StyleTransferConfig as JSTCfg
    from univst_tpu.pipelines.sd import SDVideoPipeline as JPipe
    from univst_torch.core.adain import latent_adain
    from univst_torch.core.config import StyleTransferConfig
    from univst_torch.models import convert as tcv
    from univst_torch.pipelines.sd import SDVideoPipeline

    with seeded_init(0):
        jp = JPipe.build(variant="tiny", num_frames=F, height=PX, width=PX, dtype=jnp.float32,
                         seed=0)
    tp = SDVideoPipeline.build(variant="tiny", num_frames=F, dtype=torch.float32, device="cpu")
    _carry(tp, jp, tcv.flax_unet_to_state_dict)
    jp = dataclasses.replace(jp, style_singleton=False)
    tp = dataclasses.replace(tp, style_singleton=False)
    content, style, mask = _stylize_inputs(4)
    jshift, tshift = _shift("sd")
    jctx, tctx = jp.encode_text(""), tp.encode_text("")
    jinit = j_latent_adain(jnp.asarray(content[0]), jnp.asarray(style[0]))
    want = jp.stylize_latents(jnp.asarray(content), jnp.asarray(style), jinit,
                              jnp.concatenate([jctx] * 3), mask=jnp.asarray(mask),
                              cfg=JSTCfg(num_steps=N), style_cfg=jshift)
    tinit = latent_adain(torch.tensor(content[0]), torch.tensor(style[0]))
    got = tp.stylize_latents(torch.tensor(content), torch.tensor(style), tinit,
                             torch.cat([tctx] * 3), mask=torch.tensor(mask),
                             cfg=StyleTransferConfig(num_steps=N), style_cfg=tshift)
    assert rel_err(got, want) < 1e-3
