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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("indices", INDEX_SETS)
def test_video_flash_cuda_kernel_matches_plain(dtype, indices):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def r(*s):
        return torch.randn(s, generator=gen, device="cuda").to(dtype)

    q, k, v = r(1, 4, 2, 200, 40), r(1, 4, 2, 256, 40), r(1, 4, 2, 256, 40)
    ck, cv = r(1, 4, 2, 90, 40), r(1, 4, 2, 90, 40)
    before = video_flash_attention.launches
    got = video_flash_attention(q, k, v, indices, ctx_k=ck, ctx_v=cv, ctx_valid=77)
    torch.cuda.synchronize()
    assert video_flash_attention.launches == before + 1
    want = video_flash_attention_plain(q, k, v, indices, ctx_k=ck, ctx_v=cv,
                                       ctx_valid=77).float()
    if dtype == torch.float32:
        atol, rtol = 1e-5, 1e-5
    else:
        atol, rtol = 0.02 * want.pow(2).mean().sqrt().item(), 2.0**-6
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)
