"""The port's FLOP counter (``univst_torch.utils.flops``) against the JAX
package's jaxpr walk (``univst_tpu.utils.flops``).

Both count matmuls, convolutions and attention products and nothing else.
On the CPU each side runs attention as plain products (JAX: two einsums;
the port: PyTorch's fused CPU attention, which this counter prices as its
CUDA siblings), so a tiny SD UNet forward and a tiny MMDiT forward of the
SD3.5-medium shape (qk RMS norm, a dual-attention block) count alike, held
to 1% (they agree exactly: no op is counted by one side only at these
shapes, where the video flash gates are closed). The JAX side traces with abstract params (``jax.eval_shape``), so
nothing compiles. Known shapes count exactly, as in
``tests/test_tools.py::test_count_matmul_flops_known_shapes``; a video
flash call counts ``video_flash.work``'s FLOPs, on the CPU's plain path as
on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univst_tpu.utils import flops as jflops
from univst_torch.utils import flops as tflops

F = 4


def test_count_matmul_flops_known_shapes():
    a, b = torch.zeros(8, 16), torch.zeros(16, 32)
    # one [8,16]x[16,32] matmul = 2*8*16*32 FLOPs
    assert tflops.count_matmul_flops(lambda x, y: x @ y, a, b) == 2 * 8 * 16 * 32

    def five(x, y):
        return [x @ y for _ in range(5)]

    assert tflops.count_matmul_flops(five, a, b) == 5 * 2 * 8 * 16 * 32
    # conv: 3x3, 4 -> 16 channels at 8x8 = 2 * N*H*W*Cout * (9*Cin)
    x, w = torch.zeros(1, 4, 8, 8), torch.zeros(16, 4, 3, 3)
    assert (tflops.count_matmul_flops(torch.nn.functional.conv2d, x, w, padding=1)
            == 2 * 1 * 8 * 8 * 16 * 9 * 4)


def test_attention_extra_flops_and_state_bytes():
    assert tflops.attention_extra_flops(2, 3, 5, 7, 11) == jflops.attention_extra_flops(
        2, 3, 5, 7, 11)
    lin = torch.nn.Linear(16, 8).to(torch.bfloat16)
    assert tflops.state_bytes(lin) == (16 * 8 + 8) * 2 == tflops.state_bytes(lin.state_dict())


def _jax_count(module, *args):
    """JAX ``count_matmul_flops`` of ``module.apply`` with abstract params."""
    shapes = jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0), *a), *args)
    return jflops.count_matmul_flops(lambda p, *a: module.apply(p, *a), shapes, *args)


def test_tiny_sd_unet_forward_counts_as_jax():
    from univst_tpu.core.config import SD_BASE_FRAME_INDICES
    from univst_tpu.models.layers import VideoCtx as JVideoCtx
    from univst_tpu.models.unet_sd import UNetPseudo3D as JUNet
    from univst_tpu.models.unet_sd import UNetSDConfig as JCfg
    from univst_torch.models.layers import VideoCtx
    from univst_torch.models.unet_sd import UNetPseudo3D, UNetSDConfig

    x, ctx = jnp.zeros((F, 8, 8, 4)), jnp.zeros((1, 77, 32))
    vctx = JVideoCtx(F, SD_BASE_FRAME_INDICES)
    want = _jax_count(JUNet(JCfg.tiny(temporal_identity=True)), x, jnp.asarray(301), ctx, vctx)
    m = UNetPseudo3D(UNetSDConfig.tiny()).eval()
    with torch.no_grad():
        got = tflops.count_matmul_flops(m, torch.zeros(F, 8, 8, 4), 301, torch.zeros(1, 77, 32),
                                        VideoCtx(F, SD_BASE_FRAME_INDICES))
    assert want > 0 and abs(got / want - 1) < 0.01, (got, want)


def test_tiny_mmdit_forward_counts_as_jax():
    from univst_tpu.core.config import SD3_FRAME_INDICES
    from univst_tpu.models.layers import VideoCtx as JVideoCtx
    from univst_tpu.models.mmdit import MMDiT as JMMDiT
    from univst_tpu.models.mmdit import MMDiTConfig as JCfg
    from univst_torch.models.layers import VideoCtx
    from univst_torch.models.mmdit import MMDiT, MMDiTConfig

    form = dict(qk_norm="rms", dual_attention_layers=(0,))
    args = (jnp.zeros((F, 8, 8, 16)), jnp.asarray(500.0), jnp.zeros((1, 10, 64)),
            jnp.zeros((1, 32)), JVideoCtx(F, SD3_FRAME_INDICES))
    want = _jax_count(JMMDiT(JCfg.tiny(**form)), *args)
    m = MMDiT(MMDiTConfig.tiny(**form)).eval()
    with torch.no_grad():
        got = tflops.count_matmul_flops(m, torch.zeros(F, 8, 8, 16), 500.0,
                                        torch.zeros(1, 10, 64), torch.zeros(1, 32),
                                        VideoCtx(F, SD3_FRAME_INDICES))
    assert want > 0 and abs(got / want - 1) < 0.01, (got, want)


@pytest.mark.parametrize("layout", ["heads", "tokens"])
@pytest.mark.parametrize("ctx", [0, 5])
def test_video_flash_call_counts_its_work(layout, ctx):
    """A call on the CPU (the plain version, which also multiplies the
    duplicate slots the kernels skip) counts ``work``'s FLOPs, not the plain
    version's products."""
    from univst_torch.attention import video_flash as vf

    b, f, h, lq, l, dh, lc = 1, 3, 2, 24, 16, 8, 7
    idx = ("first", -1, 0)
    rng = np.random.default_rng(0)

    def r(*s):
        return torch.tensor(rng.standard_normal(s), dtype=torch.float32)

    if layout == "heads":
        fn, q, k, v = vf.video_flash_attention, r(b, f, h, lq, dh), r(b, f, h, l, dh), r(
            b, f, h, l, dh)
        kw = dict(ctx_k=r(b, f, h, lc, dh), ctx_v=r(b, f, h, lc, dh)) if ctx else {}
    else:
        fn, q, k, v = vf.video_flash_attention_tokens, r(b, f, lq, h, dh), r(b, f, l, h, dh), r(
            b, f, l, h, dh)
        kw = dict(ctx_k=r(b, f, lc, h, dh), ctx_v=r(b, f, lc, h, dh)) if ctx else {}
    if ctx:
        kw["ctx_valid"] = ctx
    got = tflops.count_matmul_flops(fn, q, k, v, idx, **kw)
    want = vf.work((b, f, h, lq, l, dh), idx, ctx).flops
    assert got == want
    plain = 4 * b * h * lq * dh * f * (3 * l + ctx)  # what the plain version multiplies
    assert plain > want
