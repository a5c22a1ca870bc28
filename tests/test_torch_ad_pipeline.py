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

The captured feature has a float64 referee: the port's own modules in
float64 (``ad_pipe64``; its DDIM updates stay fp32, ~1e-7). At 64 px the
tiny UNet's lowest levels are 1x1, where every motion module's GroupNorm
(32 groups of 64 channels) normalizes groups of 2 values; a group whose two
values nearly coincide (variance ~1e-7 against eps 1e-6) turns any rounding
of its input into ~1e3 times as much output. The JAX GroupNorm's one-pass
variance, E[x^2] - E[x]^2 in fp32 (univst_tpu/models/layers.py:163-170),
loses such a variance outright, and how far that carries into the feature
depends on the host's XLA CPU code (ROADMAP queue 3). So the feature is
held to the float64 run at 1e-4, and to JAX at 1e-3 plus JAX's own
distance from the float64 run, measured in the test; that distance is itself
capped at 5e-3 (readings on an x86 CPU host: the feature 5.50e-5 from
float64 in the port, 1.507e-3 in JAX; the trajectory 9.7e-6 / 2.27e-4).
"""

import copy
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


@pytest.fixture(scope="module")
def ad_pipe64(ad_pipes):
    """The port's pipeline with the same weights in float64 (UNet and text
    encoder): the referee of the fp32 runs."""
    _, tp = ad_pipes
    return dataclasses.replace(tp, unet=copy.deepcopy(tp.unet).double(),
                               text_encoder=copy.deepcopy(tp.text_encoder).double(),
                               dtype=torch.float64)


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


def test_ad_invert_and_reconstruct_match_jax(ad_pipes, ad_pipe64):
    jp, tp = ad_pipes
    lat0 = np.random.default_rng(0).standard_normal((F, H8, H8, 4)).astype(np.float32)
    cap_t = int(jp.schedule.timesteps(N)[::-1][2])
    jctx, tctx = jp.encode_text(""), tp.encode_text("")
    jtraj, jfeat = jp.invert(jnp.asarray(lat0), jctx, num_steps=N, is_opt=True,
                             capture_timestep=cap_t)
    ttraj, tfeat = tp.invert(torch.tensor(lat0), tctx, num_steps=N, is_opt=True,
                             capture_timestep=cap_t)
    rtraj, rfeat = ad_pipe64.invert(torch.tensor(lat0), ad_pipe64.encode_text(""), num_steps=N,
                                    is_opt=True, capture_timestep=cap_t)
    assert rfeat.dtype == torch.float64
    print(f"feature from float64: port {rel_err(tfeat, rfeat):.3e} jax {rel_err(jfeat, rfeat):.3e};"
          f" trajectory: port {rel_err(ttraj, rtraj):.3e} jax {rel_err(jtraj, rtraj):.3e};"
          f" feature port from jax {rel_err(tfeat, jfeat):.3e}")
    assert ttraj.shape == jtraj.shape == (N + 1, F, H8, H8, 4)
    assert rel_err(ttraj, jtraj) < 1e-3
    # the referee itself agrees with JAX where JAX is well conditioned
    assert rel_err(rtraj, jtraj) < 1e-3
    assert rel_err(ttraj, rtraj) < 1e-4
    assert tfeat.shape == jfeat.shape == rfeat.shape
    assert rel_err(tfeat, rfeat) < 1e-4
    assert rel_err(tfeat, jfeat) < 1e-3 + rel_err(jfeat, rfeat)
    # JAX's own distance from the referee is bounded too: a feature captured
    # in the wrong place (in either package) is an O(1) miss, not rounding
    assert rel_err(jfeat, rfeat) < 5e-3
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


def _motion_norm_readings(ad_pipes, ad_pipe64):
    """Every motion module's GroupNorm at the feature-capture step of the
    float64 inversion: fed that run's input rounded to fp32, the port's and
    the JAX package's GroupNorm against the float64 one (relative to its
    max), with the group size and the smallest group variance."""
    from univst_tpu.models.layers import GroupNorm as JGroupNorm
    from univst_torch.models.layers import VideoCtx

    jp, tp = ad_pipes
    lat0 = np.random.default_rng(0).standard_normal((F, H8, H8, 4)).astype(np.float32)
    cap_t = int(jp.schedule.timesteps(N)[::-1][2])
    ctx64 = ad_pipe64.encode_text("")
    rtraj, _ = ad_pipe64.invert(torch.tensor(lat0), ctx64, num_steps=N, is_opt=True,
                                capture_timestep=cap_t)
    mods32, mods64 = dict(tp.unet.named_modules()), dict(ad_pipe64.unet.named_modules())
    names = [n for n in mods32 if n.endswith("temporal_transformer.norm")]
    inputs = {}
    hooks = [mods64[n].register_forward_pre_hook(lambda m, a, n=n: inputs.setdefault(n, a[0]))
             for n in names]
    try:
        with torch.inference_mode():
            ad_pipe64.unet(rtraj[2].double(), cap_t, ctx64,
                           VideoCtx(num_frames=F, frame_indices=()), None)
    finally:
        for h in hooks:
            h.remove()
    rows = []
    for n in names:
        x64, m32 = inputs[n], mods32[n]
        with torch.inference_mode():
            want = mods64[n](x64).permute(0, 2, 3, 1)
            got = m32(x64.float()).permute(0, 2, 3, 1)
        params = {"scale": jnp.asarray(m32.weight.numpy()), "bias": jnp.asarray(m32.bias.numpy())}
        jgot = JGroupNorm(num_groups=m32.num_groups, eps=m32.eps).apply(
            {"params": params}, jnp.asarray(x64.float().permute(0, 2, 3, 1).numpy()))
        groups = x64.reshape(x64.shape[0], m32.num_groups, -1)
        rows.append(dict(name=n, group_size=groups.shape[-1],
                         min_var=groups.var(-1, unbiased=False).min().item(),
                         port=rel_err(got, want), jax=rel_err(jgot, want)))
    return rows


def test_ad_group_norm_two_value_groups_against_f64(ad_pipes, ad_pipe64):
    """The port's GroupNorm (two-pass ``torch.var_mean``) stays within 1e-4
    of float64 at every motion module of the capture-step forward, the 2-value
    groups of the 1x1 levels included; the JAX package's is printed (the
    bisection in ROADMAP queue 3: ``python -m pytest
    tests/test_torch_ad_pipeline.py -s -k two_value_groups``)."""
    rows = _motion_norm_readings(ad_pipes, ad_pipe64)
    assert min(r["group_size"] for r in rows) == 2
    for r in rows:
        print(f"{r['name']:56s} group {r['group_size']:3d} min var {r['min_var']:.2e} "
              f"jax {r['jax']:.3e} port {r['port']:.3e}")
        assert r["port"] < 1e-4, r

