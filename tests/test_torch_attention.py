"""Parity of the port's attention ops with the JAX package, and of the video
flash attention kernel's plain version with the JAX Pallas kernel run in
interpret mode (as tests/test_pallas_attention.py runs it on the CPU).

Tolerances: 1e-5 absolute for the elementwise shift/gather ops and the
expanded-KV attention (fp32, same arithmetic up to summation order);
atol/rtol 2e-3 for the flash kernel comparisons, as in
tests/test_pallas_attention.py (the Pallas kernel's online softmax runs in
base 2 with blocked sums). The CUDA kernel against its plain version is in
tests/test_torch_video_flash_cuda.py, which imports no JAX so that it runs
on a machine with the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univst_tpu.attention import ops as jops
from univst_tpu.attention.pallas_attention import video_flash_attention as j_vfa
from univst_tpu.core.config import SD_STYLE_SHIFT as J_SHIFT
from univst_torch.attention import ops
from univst_torch.attention.video_flash import slot_tables, video_flash_attention
from univst_torch.core.config import SD_STYLE_SHIFT

INDEX_SETS = [(-1, "first"), ("first", -1, 0), (-1, 0, "first")]


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("indices", INDEX_SETS + [("last", "mid", 2, -3)])
@pytest.mark.parametrize("f", [1, 5])
def test_resolve_frame_indices_and_cross_frame_kv(indices, f):
    for got, want in zip(ops.resolve_frame_indices(indices, f),
                         jops.resolve_frame_indices(indices, f)):
        np.testing.assert_array_equal(got, want)
    x = _rand(np.random.default_rng(0), 2 * f, 6, 8)
    np.testing.assert_array_equal(
        ops.cross_frame_kv(torch.tensor(x), f, indices).numpy(),
        np.asarray(jops.cross_frame_kv(jnp.asarray(x), f, indices)))


@pytest.mark.parametrize("step", [0, 10, 25, 26, 40])  # in / at the edge of / past the window
def test_apply_style_shift_matches_jax(step):
    rng = np.random.default_rng(step)
    f = 3
    q, k, v = (_rand(rng, 3 * f, 16, 8) for _ in range(3))
    want = jops.apply_style_shift(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), step,
                                  J_SHIFT, f)
    got = ops.apply_style_shift(torch.tensor(q), torch.tensor(k), torch.tensor(v), step,
                                SD_STYLE_SHIFT, f)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("step", [3, 30])
def test_apply_style_shift_injected_matches_jax(step):
    rng = np.random.default_rng(step)
    f = 3
    q, k, v = (_rand(rng, 2 * f, 16, 8) for _ in range(3))
    sk, sv = _rand(rng, 1, 16, 8), _rand(rng, 1, 16, 8)
    want = jops.apply_style_shift_injected(*map(jnp.asarray, (q, k, v, sk, sv)), step,
                                           J_SHIFT, f)
    got = ops.apply_style_shift_injected(*map(torch.tensor, (q, k, v, sk, sv)), step,
                                         SD_STYLE_SHIFT, f)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("l", [64, 1024])  # expanded-KV path / kernel-wrapper path
@pytest.mark.parametrize("indices", [(-1, "first"), (-1, 0, "first")])
def test_video_mha_matches_jax(l, indices):
    rng = np.random.default_rng(l)
    f, heads, d = 3, 2, 80
    q, k, v = (_rand(rng, f, l, d) for _ in range(3))
    want = jops.video_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads, f, indices)
    got = ops.video_mha(torch.tensor(q), torch.tensor(k), torch.tensor(v), heads, f, indices)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)


def test_mha_matches_jax():
    rng = np.random.default_rng(7)
    q, k, v = _rand(rng, 2, 40, 32), _rand(rng, 2, 77, 32), _rand(rng, 2, 77, 32)
    want = jops.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 4)
    got = ops.mha(torch.tensor(q), torch.tensor(k), torch.tensor(v), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)


def test_slot_tables_match_the_kernel_table():
    """Multiplicities: the first occurrence of a source keeps the count."""
    srcs, mult = slot_tables((-1, 0, "first"), 4)
    np.testing.assert_array_equal(srcs, [[0, 0, 0], [0, 1, 0], [1, 2, 0], [2, 3, 0]])
    np.testing.assert_array_equal(mult, [[3, 0, 0], [2, 1, 0], [1, 1, 1], [1, 1, 1]])


def _qkv(rng, b, f, h, l, dh, lq=None):
    lq = l if lq is None else lq
    return (_rand(rng, b, f, h, lq, dh), _rand(rng, b, f, h, l, dh), _rand(rng, b, f, h, l, dh))


@pytest.mark.parametrize("indices", INDEX_SETS)
@pytest.mark.parametrize("dh", [40, 64, 80])
def test_video_flash_plain_matches_pallas(indices, dh):
    q, k, v = _qkv(np.random.default_rng(dh), 1, 4, 2, 128, dh)
    want = np.asarray(j_vfa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), indices,
                            block_q=128, block_k=128, interpret=True))
    got = video_flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), indices)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("dh,lc,ctx_valid", [(40, 77, None), (64, 128, 77), (80, 200, 77)])
@pytest.mark.parametrize("lq", [128, 256])  # Lq == L, Lq != L
def test_video_flash_plain_ctx_and_lq_match_pallas(dh, lc, ctx_valid, lq):
    """The masked context step (ragged Lc, explicit ctx_valid) and Lq != L."""
    rng = np.random.default_rng(lc + lq)
    q, k, v = _qkv(rng, 1, 3, 2, 128, dh, lq=lq)
    ck, cv = _rand(rng, 1, 3, 2, lc, dh), _rand(rng, 1, 3, 2, lc, dh)
    idx = ("first", -1, 0)
    want = np.asarray(j_vfa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), idx, block_q=128,
                            block_k=128, ctx_k=jnp.asarray(ck), ctx_v=jnp.asarray(cv),
                            ctx_valid=ctx_valid, interpret=True))
    got = video_flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), idx,
                                ctx_k=torch.tensor(ck), ctx_v=torch.tensor(cv),
                                ctx_valid=ctx_valid)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("bad", ["dh", "dtype", "contiguous", "indices", "scale"])
def test_video_flash_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros(1, 2, 1, 64, 40)
    if bad == "dh":
        q = torch.zeros(1, 2, 1, 64, 36)
    elif bad == "dtype":
        q = q.half()
    elif bad == "contiguous":
        q = torch.zeros(1, 2, 1, 40, 64).transpose(3, 4)
    idx = () if bad == "indices" else (-1, "first")
    with pytest.raises((ValueError, TypeError)):
        video_flash_attention(q, q, q, idx, sm_scale=0.0 if bad == "scale" else None)
