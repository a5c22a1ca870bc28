"""Parity of the port's SD3 attention with the JAX package: the plain
version of the token-major video flash kernel (K2) against the JAX Pallas
kernel ``video_flash_attention_folded`` run in interpret mode (as
tests/test_pallas_attention.py runs it on the CPU), and
``joint_video_attention_tokens`` / ``cross_frame_kv_heads`` against the JAX
functions.

Tolerances: 2e-5 against the interpret-mode kernel (its online softmax runs
in base 2 over blocks: fp32 sums in another order); 1e-5 for the
joint attention (fp32, the same expanded-KV math); the KV gather exactly.
The CUDA kernel against its plain version is in
tests/test_torch_video_flash_tokens_cuda.py, which imports no JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univst_tpu.attention import ops as jops
from univst_tpu.attention.pallas_attention import video_flash_attention_folded as j_folded
from univst_torch.attention import ops
from univst_torch.attention.video_flash import (
    video_flash_attention_tokens, video_flash_attention_tokens_plain,
)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("dh", [16, 32, 64])
@pytest.mark.parametrize("with_ctx", [False, True])
@pytest.mark.parametrize("lq_extra", [0, 64])  # the merged [img | ctx] q stream is longer
@pytest.mark.parametrize("indices", [("first", -1, 0), (-1, "first")])
def test_tokens_plain_matches_the_jax_folded_kernel(dh, with_ctx, lq_extra, indices):
    rng = np.random.default_rng(dh + lq_extra)
    b, f, h, l = 1, 4, 128 // dh, 128  # the folded kernel packs 128 // dh heads per lane block
    lq = l + lq_extra
    q, k, v = _rand(rng, b, f, lq, h, dh), _rand(rng, b, f, l, h, dh), _rand(rng, b, f, l, h, dh)
    kw = {}
    if with_ctx:
        kw = dict(ctx_k=_rand(rng, b, f, 40, h, dh), ctx_v=_rand(rng, b, f, 40, h, dh),
                  ctx_valid=33)
    want = np.asarray(j_folded(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), indices, block_q=64, block_k=64,
        dual=2, interpret=True, **{n: jnp.asarray(x) if n != "ctx_valid" else x
                                   for n, x in kw.items()}))
    tkw = {n: torch.tensor(x) if n != "ctx_valid" else x for n, x in kw.items()}
    got = video_flash_attention_tokens_plain(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                             indices, **tkw)
    assert got.shape == (b, f, lq, h, dh)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    # on a CPU tensor the wrapper is its plain version and launches nothing
    before = video_flash_attention_tokens.launches
    same = video_flash_attention_tokens(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                        indices, **tkw)
    assert video_flash_attention_tokens.launches == before
    torch.testing.assert_close(same, got, atol=0, rtol=0)


def test_tokens_wrapper_checks_its_inputs():
    q = torch.zeros(1, 2, 10, 2, 16)
    k = torch.zeros(1, 2, 8, 2, 16)
    with pytest.raises(ValueError, match="frame index"):
        video_flash_attention_tokens(q, k, k, ())
    with pytest.raises(ValueError, match="disagree"):
        video_flash_attention_tokens(q, torch.zeros(1, 2, 8, 3, 16), torch.zeros(1, 2, 8, 3, 16),
                                     ("first",))
    with pytest.raises(ValueError, match="ctx_valid"):
        video_flash_attention_tokens(q, k, k, ("first",), ctx_k=torch.zeros(1, 2, 5, 2, 16),
                                     ctx_v=torch.zeros(1, 2, 5, 2, 16), ctx_valid=6)


@pytest.mark.parametrize("indices", [("first", -1, 0), ("last", 2)])
def test_cross_frame_kv_heads_matches_jax(indices):
    x = _rand(np.random.default_rng(0), 2 * 4, 3, 5, 8)
    np.testing.assert_array_equal(
        ops.cross_frame_kv_heads(torch.tensor(x), 4, indices).numpy(),
        np.asarray(jops.cross_frame_kv_heads(jnp.asarray(x), 4, indices)))


@pytest.mark.parametrize("with_ctx", [False, True])
@pytest.mark.parametrize("n,indices", [(64, ("first", -1, 0)), (128, ("first", -1, 0)),
                                       (64, ())])
def test_joint_video_attention_tokens_matches_jax(with_ctx, n, indices):
    rng = np.random.default_rng(n + with_ctx)
    f, h, dh = 4, 2, 16
    q, k, v = (_rand(rng, 2 * f, n, h, dh) for _ in range(3))
    ctx = {}
    if with_ctx:
        ctx = {name: _rand(rng, 2 * f, 11, h, dh) for name in ("cq", "ck", "cv")}
    want = np.asarray(jops.joint_video_attention_tokens(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), f if indices else 1, indices,
        **{name: jnp.asarray(x) for name, x in ctx.items()}))
    got = ops.joint_video_attention_tokens(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), f if indices else 1, indices,
        **{name: torch.tensor(x) for name, x in ctx.items()})
    assert got.shape == (2 * f, n + (11 if with_ctx else 0), h, dh)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
