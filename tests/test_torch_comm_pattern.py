"""Communication pattern of the port's frame-parallel forwards: the census
that ``univst_torch.distributed.census`` collects from the comm layer,
mirroring the JAX package's HLO census tests (tests/test_comm_pattern.py:
33, 105, 241) on the tiny SD and AnimateDiff UNets over gloo ranks on the
CPU.

What the JAX tests assert of XLA's lowering holds here by construction and
is checked call by call:
  * an SD forward moves the K/V of the halo frames only (frame 0 and the
    frame before the shard: one all-to-all per sparse-causal attention,
    each of exactly that many bytes) plus the frame-spanning GroupNorms'
    statistics (one small all-gather each), and no whole activation;
  * an AnimateDiff forward makes exactly two all-to-alls per motion module
    (to tokens and back, each 1/N of the module's activation) and no frame
    gather, no K/V exchange and no statistics exchange;
  * a ``torch.profiler`` trace of the forward sees as many gloo
    collectives as the census (none bypasses the comm layer);
  * the sharded eps equals the one-process forward (1e-5 of the max).
"""

import numpy as np
import pytest
import torch

import _torch_dist as td
from _torch_parity import rel_err

F, T = 8, 501


def _one_process(backbone, x, mode):
    """The same forward on one process: the seeded random weights are the
    ranks' own."""
    pipe = td._tiny_pipe(None, backbone, None, F)
    ctx = pipe.encode_text("")
    with torch.inference_mode():
        if mode == "invert":
            return pipe._denoise_fn(ctx, pipe.base_frame_indices, None)(torch.tensor(x), T, 0)[0]
        kv = pipe._style_prepass(torch.tensor(x[None, :1]), np.asarray([T]),
                                 torch.cat([ctx] * 3), 1)
        denoise = pipe._denoise_fn(torch.cat([ctx, ctx]), pipe.pnp_frame_indices,
                                   pipe.style_shift_cfg)
        return denoise(torch.tensor(x), T, 0,
                       style_kv=tuple((k[0][None], v[0][None]) for k, v in kv))[0]


@pytest.mark.parametrize("n, mode", [(2, "inject"), (4, "invert")])
def test_sd_forward_moves_only_the_halo_and_norm_statistics(n, mode, tmp_path):
    from univst_torch.attention.ops import shard_halo_needs

    b = 2 if mode == "inject" else 1
    x = td.noise(0, b * F, 16, 16, 4)
    res = td.run_ranks(td.unet_census, n, tmp_path, "sd", F, x, T, mode)
    assert rel_err(res[0][0], _one_process("sd", x, mode)) < 1e-5
    needs = shard_halo_needs((-1, 0, "first"), F, n)
    assert needs == shard_halo_needs((-1, "first"), F, n)  # the PnP layers' set: the same
    for r, (_, recs, prof, attn, n_norms) in enumerate(res):
        halo = [nb for op, nb, *_ in recs if op == "all_to_all"]
        stats = [nb for op, nb, *_ in recs if op == "all_gather"]
        assert {op for op, *_ in recs} <= {"all_to_all", "all_gather"}
        assert {site for _, _, site, _ in recs} == {"kv_halo", "group_norm"}
        # one halo exchange per attention: exactly the halo frames' K and V
        assert len(halo) == len(attn) == 16
        assert halo == [len(needs[r]) * 2 * bf // (F // n) * l * d * 4 for bf, l, d in attn]
        # one statistics gather per frame-spanning GroupNorm: (count, mean,
        # var) in float64 per (video, group) from each other rank
        assert len(stats) == n_norms > 0
        assert all(nb == (n - 1) * 3 * b * 8 * 8 for nb in stats)  # 8 groups (tiny)
        # no whole activation: the largest exchange is under one frame of K/V
        assert max(halo) <= 2 * 2 * b * max(l * d for _, l, d in attn) * 4
        assert sum(prof.values()) == len(recs)


@pytest.mark.parametrize("n", [2, 4])
def test_ad_motion_modules_make_two_all_to_alls_each(n, tmp_path):
    """16x16 latents: 256 / 64 / 16 / 4 tokens a level, all divide 2 and
    4, so every motion module swaps frames for tokens (Ulysses) and back."""
    x = td.noise(1, F, 16, 16, 4)
    res = td.run_ranks(td.unet_census, n, tmp_path, "ad", F, x, T, "invert")
    assert rel_err(res[0][0], _one_process("ad", x, "invert")) < 1e-5
    for _, recs, prof, attn, n_norms in res:
        assert n_norms == 0 and all(l == 256 or l < 256 for _, l, _ in attn)
        assert [op for op, *_ in recs] == ["all_to_all"] * (2 * 21)  # 21 motion modules
        assert {site for _, _, site, _ in recs} == {"motion_module"}
        # each swap brings (N - 1) / N of the rank's [f, L, C] activation
        sizes = sorted({nb for _, nb, *_ in recs})
        per_level = {f_l_c: (n - 1) * (F // n) * f_l_c // n * 4
                     for f_l_c in (256 * 32, 64 * 64, 16 * 64, 4 * 64)}
        assert sizes == sorted(set(per_level.values()))
        assert sum(prof.values()) == len(recs)
