"""The token-major video flash attention CUDA kernel (K2) against its plain
PyTorch version.

Needs a CUDA card (the kernel has no CPU form) and skips without one. Imports
no JAX, so it runs where the port runs; ``--noconftest`` skips
tests/conftest.py, which sets up JAX:

    python -m pytest --noconftest tests/test_torch_video_flash_tokens_cuda.py -m cuda

Shapes: a ragged merged q stream (Lq = L + 45, not a multiple of the 64-row
tile), a context of 90 rows of which 77 are valid (not whole key tiles), and
the no-context form of the SD3.5 dual attention; dh 64 as in SD3, and 32.

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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("indices", INDEX_SETS)
@pytest.mark.parametrize("dh,ctx", [(64, True), (64, False), (32, True)])
def test_video_flash_tokens_cuda_kernel_matches_plain(dtype, indices, dh, ctx):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    gen = torch.Generator(device="cuda").manual_seed(dh)

    def r(*s):
        return torch.randn(s, generator=gen, device="cuda").to(dtype)

    b, f, h, l = 2, 4, 3, 256
    q, k, v = r(b, f, l + 45, h, dh), r(b, f, l, h, dh), r(b, f, l, h, dh)
    kw = dict(ctx_k=r(b, f, 90, h, dh), ctx_v=r(b, f, 90, h, dh), ctx_valid=77) if ctx else {}
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
