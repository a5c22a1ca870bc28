"""The token-major video flash attention CUDA kernel (K2) against its plain
PyTorch version.

Needs a CUDA card (the kernel has no CPU form) and skips without one. Imports
no JAX, so it runs where the port runs; ``--noconftest`` skips
tests/conftest.py, which sets up JAX:

    python -m pytest --noconftest tests/test_torch_video_flash_tokens_cuda.py -m cuda

Shapes: a ragged merged q stream (Lq = L + 45, not a multiple of the 128-row
tile), a context of 90 rows of which 77 are valid (not whole key tiles), and
the no-context form of the SD3.5 dual attention; dh 64 as in SD3, and 32;
then the tile edges of the bf16 kernel (``EDGES``).

Tolerances (those of ``chip_smoke.py``): 1e-5 absolute and relative in fp32
(the same arithmetic up to summation order). In bf16, rtol 2**-6 (two bf16
ulps: both sides round their output to bf16, and the kernel also rounds P
for the PV product) plus atol 0.02 x the plain output's rms, for elements
near zero.
"""

import pytest
import torch

from univst_torch.attention.video_flash import (
    video_flash_attention_tokens, video_flash_attention_tokens_plain,
)

INDEX_SETS = [("first", -1, 0), (-1, "first")]

# b, f, h, lq, l, dh, (lc, ctx_valid) or None, indices
BASE = [(2, 4, 3, 256 + 45, 256, dh, ctx, ind)
        for dh, ctx in [(64, (90, 77)), (64, None), (32, (90, 77))] for ind in INDEX_SETS]
# Tile edges of the bf16 kernel (128 query rows per block; 192-key tiles at
# dh <= 64 and 128-key tiles above; 64-column atoms of dh): Lq below and not
# a multiple of 128, L not a multiple of the key tile, ctx_valid below one
# tile, dh 40/64/80/128, B*F*H = 1.
EDGES = [
    (1, 4, 3, 100, 256, 40, (90, 77), ("first", -1, 0)),
    (1, 4, 2, 333, 200, 64, (20, 5), ("first", -1, 0)),
    (2, 3, 2, 129, 130, 80, None, ("first", -1, 0)),
    (1, 1, 1, 77, 64, 128, (40, 33), ("first", -1, 0)),
    (1, 2, 5, 256, 384, 128, (333, 333), ("first", -1, 0)),
]
CASES = ([(torch.float32, *case) for case in BASE]
         + [(torch.bfloat16, *case) for case in BASE + EDGES])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,f,h,lq,l,dh,ctx,indices", CASES)
def test_video_flash_tokens_cuda_kernel_matches_plain(dtype, b, f, h, lq, l, dh, ctx, indices):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    gen = torch.Generator(device="cuda").manual_seed(lq + dh)

    def r(*s):
        return torch.randn(s, generator=gen, device="cuda").to(dtype)

    q, k, v = r(b, f, lq, h, dh), r(b, f, l, h, dh), r(b, f, l, h, dh)
    kw = {}
    if ctx:
        kw = dict(ctx_k=r(b, f, ctx[0], h, dh), ctx_v=r(b, f, ctx[0], h, dh), ctx_valid=ctx[1])
    before = video_flash_attention_tokens.launches
    got = video_flash_attention_tokens(q, k, v, indices, **kw)
    torch.cuda.synchronize()
    assert video_flash_attention_tokens.launches == before + 1
    assert got.shape == q.shape
    want = video_flash_attention_tokens_plain(q, k, v, indices, **kw).float()
    if dtype == torch.float32:
        atol, rtol = 1e-5, 1e-5
    else:
        atol, rtol = 0.02 * want.pow(2).mean().sqrt().item(), 2.0**-6
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, ctx", [(torch.bfloat16, (90, 77)), (torch.float32, None)])
def test_video_flash_tokens_cuda_shard_form(dtype, ctx):
    """The shard form (k/v of Fk = F + halo frames, explicit slot tables; the
    context stays q's frames') against its plain version, and the default
    call bit for bit the explicit-table call with Fk = F."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    from univst_torch.attention.ops import shard_kv_tables
    from univst_torch.attention.video_flash import slot_tables

    idx, (b, f, h, lq, l, dh) = ("first", -1, 0), (1, 4, 3, 300, 256, 64)
    halo, srcs, mult = shard_kv_tables(idx, 8, 4, f)
    gen = torch.Generator(device="cuda").manual_seed(11)

    def r(*s):
        return torch.randn(s, generator=gen, device="cuda").to(dtype)

    fk = f + len(halo)
    q, k, v = r(b, f, lq, h, dh), r(b, fk, l, h, dh), r(b, fk, l, h, dh)
    kw = dict(ctx_k=r(b, f, ctx[0], h, dh), ctx_v=r(b, f, ctx[0], h, dh),
              ctx_valid=ctx[1]) if ctx else {}
    got = video_flash_attention_tokens(q, k, v, idx, tables=(srcs, mult), **kw)
    want = video_flash_attention_tokens_plain(q, k, v, idx, tables=(srcs, mult), **kw).float()
    if dtype == torch.float32:
        atol, rtol = 1e-5, 1e-5
    else:
        atol, rtol = 0.02 * want.pow(2).mean().sqrt().item(), 2.0**-6
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)
    a = video_flash_attention_tokens(q, k[:, :f].contiguous(), v[:, :f].contiguous(), idx, **kw)
    e = video_flash_attention_tokens(q, k[:, :f].contiguous(), v[:, :f].contiguous(), idx,
                                     tables=slot_tables(idx, f), **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, e)
