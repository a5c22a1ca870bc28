"""The slice as a whole: the port's AnimateDiff pipeline against the JAX
package's, on the tiny AD config (4 frames, 64 px, fp32, CPU), weights
carried across with strict loads (every motion module's ``proj_out`` filled
from a numpy seed, so the temporal path reaches the output). The SD
pipeline's use of the same path is in ``test_torch_sd_fallback.py``.

Covered: AD content inversion with EasyInv and feature capture, then the
reconstruction (linear betas); AD stylization by capture-and-inject with a
mask, non-identical style frames and both phases (a 6-step window config:
steps 0-2 inject, 3-5 stylized-only); in the port alone, capture-and-inject
against the 3-branch batch it decomposes, and the batched style capture
(``style_prepass_chunk=3``, a full and a tail chunk) against per-step
capture.

Tolerances: relative 1e-3 of the max against JAX (two fp32 frameworks over
the DDIM steps, as ``test_torch_pipeline.py`` states it); 1e-5 between two
paths of the port (the same arithmetic on batches of other sizes).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import rel_err, to_np
from test_torch_unet_ad import _fill_proj_out

F, PX, N = 4, 64, 6
H8 = PX // 8


def _carry(tp, jp, unet_emit):
    from univst_torch.models import convert as tcv

    for module, emit, params, cfg in (
        (tp.unet, unet_emit, jp.unet_params, jp.unet.cfg),
        (tp.vae, tcv.flax_vae_to_state_dict, jp.vae_params, jp.vae.cfg),
        (tp.text_encoder, tcv.flax_clip_to_state_dict, jp.text_params, jp.text_encoder.cfg),
    ):
        module.load_state_dict(tcv.to_torch_state_dict(emit(to_np(params), cfg)), strict=True)


@pytest.fixture(scope="module")
def ad_pipes():
    from univst_tpu.pipelines.animatediff import build_animatediff as j_build
    from univst_torch.models import convert as tcv
    from univst_torch.pipelines.animatediff import build_animatediff

    jp = j_build(variant="tiny", num_frames=F, height=PX, width=PX, dtype=jnp.float32,
                 capture_up_block=2, seed=0)
    jp = dataclasses.replace(jp, unet_params=_fill_proj_out(to_np(jp.unet_params)))
    tp = build_animatediff(variant="tiny", num_frames=F, dtype=torch.float32,
                           capture_up_block=2, device="cpu")
    _carry(tp, jp, tcv.flax_ad_unet_to_state_dict)
    return jp, tp


def _shift(mode, n=N):
    """Shift constants scaled to ``n`` steps, so both phases run."""
    from univst_tpu.core.config import StyleShiftConfig as JShift
    from univst_torch.core.config import StyleShiftConfig

    kw = (dict(alpha=0.8, gamma=2.0, eta2=0.5, num_steps=n, window_mode="ad") if mode == "ad"
          else dict(alpha=0.65, gamma=3.0, eta2=0.5, num_steps=n, window_mode="sd"))
    assert 0 < StyleShiftConfig(**kw).window_end() < n
    return JShift(**kw), StyleShiftConfig(**kw)


def _stylize_inputs(seed, n=N):
    rng = np.random.default_rng(seed)
    content = rng.standard_normal((n + 1, F, H8, H8, 4)).astype(np.float32)
    style = rng.standard_normal((n + 1, F, H8, H8, 4)).astype(np.float32)  # frames differ
    mask = np.zeros((F, PX, PX), np.float32)
    mask[:, 16:48, 8:40] = 1.0
    return content, style, mask


def test_ad_invert_and_reconstruct_match_jax(ad_pipes):
    jp, tp = ad_pipes
    lat0 = np.random.default_rng(0).standard_normal((F, H8, H8, 4)).astype(np.float32)
    cap_t = int(jp.schedule.timesteps(N)[::-1][2])
    jctx, tctx = jp.encode_text(""), tp.encode_text("")
    jtraj, jfeat = jp.invert(jnp.asarray(lat0), jctx, num_steps=N, is_opt=True,
                             capture_timestep=cap_t)
    ttraj, tfeat = tp.invert(torch.tensor(lat0), tctx, num_steps=N, is_opt=True,
                             capture_timestep=cap_t)
    assert ttraj.shape == jtraj.shape == (N + 1, F, H8, H8, 4)
    assert rel_err(ttraj, jtraj) < 1e-3
    assert tfeat.shape == jfeat.shape and rel_err(tfeat, jfeat) < 1e-3
    jrec = jp.reconstruct_latents(jtraj[-1], jctx, num_steps=N)
    trec = tp.reconstruct_latents(torch.tensor(np.asarray(jtraj[-1])), tctx, num_steps=N)
    assert rel_err(trec, jrec) < 1e-3


def test_ad_stylize_matches_jax(ad_pipes):
    """Capture-and-inject with the raw content noise as the init, as the
    AnimateDiff transfer CLI runs it."""
    from univst_tpu.core.config import StyleTransferConfig as JSTCfg
    from univst_torch.core.config import StyleTransferConfig

    jp, tp = ad_pipes
    content, style, mask = _stylize_inputs(1)
    jshift, tshift = _shift("ad")
    jctx, tctx = jp.encode_text(""), tp.encode_text("")
    want = jp.stylize_latents(jnp.asarray(content), jnp.asarray(style), jnp.asarray(content[0]),
                              jnp.concatenate([jctx] * 3), mask=jnp.asarray(mask),
                              cfg=JSTCfg(num_steps=N), style_cfg=jshift)
    got = tp.stylize_latents(torch.tensor(content), torch.tensor(style),
                             torch.tensor(content[0]), torch.cat([tctx] * 3),
                             mask=torch.tensor(mask), cfg=StyleTransferConfig(num_steps=N),
                             style_cfg=tshift)
    assert rel_err(got, want) < 1e-3


def _port_stylize(tp, content, style, mask, shift, n=N, **replace):
    from univst_torch.core.config import StyleTransferConfig

    pipe = dataclasses.replace(tp, **replace)
    return pipe.stylize_latents(torch.tensor(content), torch.tensor(style),
                                torch.tensor(content[0]), torch.cat([tp.encode_text("")] * 3),
                                mask=torch.tensor(mask), cfg=StyleTransferConfig(num_steps=n),
                                style_cfg=shift)


def test_ad_capture_equals_the_three_branch_batch(ad_pipes):
    """Per-step capture + 2-branch injection == the reference's in-batch
    [content | style | stylized] form, without identical style frames: the
    branches couple only through the attention shift."""
    from univst_torch.core.config import StyleTransferConfig
    from univst_torch.methods.style_transfer import style_transfer_ddim_steps

    _, tp = ad_pipes
    content, style, mask = _stylize_inputs(2)
    _, shift = _shift("ad")
    got = _port_stylize(tp, content, style, mask, shift)

    ctx3 = torch.cat([tp.encode_text("")] * 3)
    cfg = StyleTransferConfig(num_steps=N)
    ts, k1 = tp.schedule.timesteps(N), shift.window_end()
    denoise = tp._denoise_fn(ctx3, tp.pnp_frame_indices, shift)
    with torch.inference_mode():
        lat = style_transfer_ddim_steps(lambda x3, t, i: denoise(x3, t, i)[0],
                                        torch.tensor(content[:k1]), torch.tensor(style[:k1]),
                                        torch.tensor(content[0]), range(k1), ts[:k1],
                                        tp.schedule, cfg, mask=torch.tensor(mask))
        want = tp._stylize_chunk_solo(torch.tensor(content), torch.tensor(style), lat, ts, k1,
                                      ctx3, torch.tensor(mask), cfg, N - k1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_ad_batched_style_capture_equals_per_step_capture(ad_pipes):
    """One [chunk*F]-row capture forward per 3 steps (over a 4-step window:
    a full chunk and a tail) == one F-row capture forward per step."""
    _, tp = ad_pipes
    n = 8
    content, style, mask = _stylize_inputs(3, n)
    _, shift = _shift("ad", n)
    assert shift.window_end() == 4
    per_step = _port_stylize(tp, content, style, mask, shift, n)
    batched = _port_stylize(tp, content, style, mask, shift, n, style_prepass_chunk=3)
    torch.testing.assert_close(batched, per_step, rtol=1e-5, atol=1e-5)


def test_ad_round_trip_psnr_is_the_jax_packages(ad_pipes):
    """Inversion -> reconstruction comes back to the start latent exactly as
    far in the port as in the JAX package on the same weights (to 0.01 dB):
    the AnimateDiff path's round-trip PSNR on the card (below SD's, with or
    without the motion modules) belongs to the method and the random
    weights, not to the port."""
    jp, tp = ad_pipes
    lat0 = np.random.default_rng(0).standard_normal((F, H8, H8, 4)).astype(np.float32)
    cap_t = int(jp.schedule.timesteps(N)[::-1][2])  # as above: the compiled JAX segment

    def psnr(rec):
        err = np.mean((np.asarray(rec, np.float64) - lat0) ** 2)
        return 10 * np.log10((lat0.max() - lat0.min()) ** 2 / err)

    jctx, tctx = jp.encode_text(""), tp.encode_text("")
    jtraj, _ = jp.invert(jnp.asarray(lat0), jctx, num_steps=N, is_opt=True,
                         capture_timestep=cap_t)
    ttraj, _ = tp.invert(torch.tensor(lat0), tctx, num_steps=N, is_opt=True,
                         capture_timestep=cap_t)
    want = psnr(jp.reconstruct_latents(jtraj[-1], jctx, num_steps=N))
    got = psnr(tp.reconstruct_latents(ttraj[-1], tctx, num_steps=N))
    assert np.isfinite(want) and abs(got - want) < 0.01
