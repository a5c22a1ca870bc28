"""The video flash attention CUDA kernel against its plain PyTorch version.

Needs a CUDA card (the kernel has no CPU form) and skips without one. Imports
no JAX, so it runs where the port runs; ``--noconftest`` skips
tests/conftest.py, which sets up JAX:

    python -m pytest --noconftest tests/test_torch_video_flash_cuda.py -m cuda

Tolerances: 1e-5 absolute and relative in fp32 (the same arithmetic up to
summation order). In bf16, rtol 2**-6 (two bf16 ulps: both sides round their
output to bf16, and the kernel also rounds P for the PV product) plus atol
0.02 x the plain output's rms, for elements near zero.
"""

import pytest
import torch

from univst_torch.attention.video_flash import video_flash_attention, video_flash_attention_plain

INDEX_SETS = [(-1, "first"), ("first", -1, 0), (-1, 0, "first")]

# b, f, h, lq, l, dh, (lc, ctx_valid) or None, indices
BASE = [(1, 4, 2, 200, 256, 40, (90, 77), ind) for ind in INDEX_SETS]
# Tile edges of the bf16 kernel (128 query rows per block; 192-key tiles at
# dh <= 64 and 128-key tiles above; 64-column atoms of dh): Lq below and not
# a multiple of 128, L not a multiple of the key tile, ctx_valid below one
# tile, dh 40/64/80/128, B*F*H = 1, and a frame whose slots all name one
# source (one kept slot of weight 2).
EDGES = [
    (1, 4, 2, 100, 256, 40, (90, 77), (-1, 0, "first")),
    (1, 4, 2, 300, 200, 64, None, (-1, "first")),
    (1, 3, 1, 129, 130, 80, (20, 5), ("first", -1, 0)),
    (1, 1, 1, 77, 64, 128, (40, 33), (-1, "first")),
    (2, 2, 3, 256, 384, 128, None, (-1, 0, "first")),
]
CASES = ([(torch.float32, *case) for case in BASE]
         + [(torch.bfloat16, *case) for case in BASE + EDGES])


def _assert_matches_plain(q, k, v, indices, **kw):
    """One launch of the kernel, held to its plain version (the module's
    tolerances)."""
    before = video_flash_attention.launches
    got = video_flash_attention(q, k, v, indices, **kw)
    torch.cuda.synchronize()
    assert video_flash_attention.launches == before + 1
    assert got.shape == q.shape
    want = video_flash_attention_plain(q, k, v, indices, **kw).float()
    if q.dtype == torch.float32:
        atol, rtol = 1e-5, 1e-5
    else:
        atol, rtol = 0.02 * want.pow(2).mean().sqrt().item(), 2.0**-6
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,f,h,lq,l,dh,ctx,indices", CASES)
def test_video_flash_cuda_kernel_matches_plain(dtype, b, f, h, lq, l, dh, ctx, indices):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    gen = torch.Generator(device="cuda").manual_seed(lq + dh)

    def r(*s):
        return torch.randn(s, generator=gen, device="cuda").to(dtype)

    q, k, v = r(b, f, h, lq, dh), r(b, f, h, l, dh), r(b, f, h, l, dh)
    kw = {}
    if ctx:
        kw = dict(ctx_k=r(b, f, h, ctx[0], dh), ctx_v=r(b, f, h, ctx[0], dh), ctx_valid=ctx[1])
    _assert_matches_plain(q, k, v, indices, **kw)


# Logits that grow along the keys, so a row's max keeps outgrowing the
# running max of earlier tiles (by more than the 2^8 the kernel lets it lag,
# and, in the step case, by more than an fp32 exponent can hold): the
# kernel's path that recomputes a tile's logits must take over.
@pytest.mark.cuda
@pytest.mark.parametrize("ramp", ["linear", "step"])
def test_video_flash_cuda_kernel_growing_logits(ramp):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    gen = torch.Generator(device="cuda").manual_seed(7)
    b, f, h, lq, l, dh = 1, 3, 2, 200, 384, 64
    q = torch.randn(b, f, h, lq, dh, generator=gen, device="cuda")
    k = torch.randn(b, f, h, l, dh, generator=gen, device="cuda")
    v = torch.randn(b, f, h, l, dh, generator=gen, device="cuda")
    if ramp == "linear":
        scale = torch.linspace(0.5, 12.0, l, device="cuda")
    else:
        scale = torch.where(torch.arange(l, device="cuda") < 128, 0.1, 100.0)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k * scale[:, None], v))
    _assert_matches_plain(q, k, v, ("first", -1, 0))


# The shard form: q holds a rank's F frames, k/v its Fk = F + halo frames
# (its own, then the halo frames its index set reads on other ranks), the
# slot tables explicit (``ops.shard_kv_tables``).
SHARDS = [  # dtype, b, (global F, ranks, rank), h, l, dh, indices
    (torch.bfloat16, 2, (16, 2, 1), 2, 256, 40, (-1, 0, "first")),
    (torch.bfloat16, 2, (16, 4, 2), 2, 256, 40, (-1, "first")),
    (torch.bfloat16, 1, (16, 2, 1), 2, 200, 80, (-1, 0, "first")),
    (torch.float32, 1, (8, 2, 1), 2, 128, 64, (-1, 0, "first")),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,shard,h,l,dh,indices", SHARDS)
def test_video_flash_cuda_shard_form_matches_plain(dtype, b, shard, h, l, dh, indices):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    from univst_torch.attention.ops import shard_kv_tables

    nf, n, rank = shard
    f = nf // n
    halo, srcs, mult = shard_kv_tables(indices, nf, rank * f, f)
    gen = torch.Generator(device="cuda").manual_seed(l + dh + rank)

    def r(*s):
        return torch.randn(s, generator=gen, device="cuda").to(dtype)

    fk = f + len(halo)
    q, k, v = r(b, f, h, l, dh), r(b, fk, h, l, dh), r(b, fk, h, l, dh)
    _assert_matches_plain(q, k, v, indices, tables=(srcs, mult))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_video_flash_cuda_default_call_is_the_explicit_table_call(dtype):
    """Fk = F with the index set's own tables is the one-device call, bit
    for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    from univst_torch.attention.video_flash import slot_tables

    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(2, 6, 2, 256, 40, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    idx = (-1, 0, "first")
    a = video_flash_attention(q, k, v, idx)
    b = video_flash_attention(q, k, v, idx, tables=slot_tables(idx, 6))
    torch.cuda.synchronize()
    assert torch.equal(a, b)
