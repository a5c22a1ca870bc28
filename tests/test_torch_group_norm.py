"""``layers.GroupNorm``'s dispatch on the CPU: every call here takes the
eager chain (``models/group_norm.py::group_norm_plain``), bit for bit the
chain the module ran before the CUDA kernel existed (:func:`_chain_before`,
a frozen copy), in fp32, bf16 and float64 and under a frame shard on two
gloo ranks; ``silu=True`` is ``F.silu`` of it. The kernel's planning
(:func:`group_norm.plan`) is shape arithmetic, checked here; the kernel
itself runs on the card (``tests/test_torch_group_norm_cuda.py``)."""

import os
import subprocess
import sys

import _torch_dist as td
import _torch_parity  # noqa: F401  (gives this worker's torch its share of the cores)
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from univst_torch.models import group_norm as gn
from univst_torch.models.layers import GroupNorm
from univst_torch.utils.profiling import SPANS, spans

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chain_before(m, x, num_frames=1, shard=None):
    """``GroupNorm.forward`` as it was before the kernel (frozen copy)."""
    n, c = x.shape[:2]
    g = m.num_groups
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    shard = shard if m.across_frames else None
    if m.across_frames and (num_frames > 1 or shard is not None):
        xg = xf.reshape(n // num_frames, num_frames, g, c // g, -1)
        dims = (1, 3, 4)
    else:
        xg = xf.reshape(n, g, c // g, -1)
        dims = (2, 3)
    if shard is None:
        var, mean = torch.var_mean(xg, dim=dims, unbiased=False, keepdim=True)
    else:
        from univst_torch.distributed.comm import sharded_var_mean

        var, mean = sharded_var_mean(xg, dims, shard, site="group_norm")
    xn = ((xg - mean) * torch.rsqrt(var + m.eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.dim() - 2)
    out = xn * m.weight.to(xf.dtype).reshape(shape) + m.bias.to(xf.dtype).reshape(shape)
    return out.to(x.dtype)


def _module(c, g, across, dtype, seed=0):
    m = GroupNorm(c, g, eps=1e-5, across_frames=across)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        m.weight.copy_(1.0 + 0.5 * torch.randn(c, generator=gen))
        m.bias.copy_(0.5 * torch.randn(c, generator=gen))
    return m.to(dtype)


def _input(shape, dtype, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return (3.0 + 2.0 * torch.randn(shape, generator=gen)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("across,num_frames,shape", [
    (True, 4, (8, 16, 6, 6)),  # frame-spanning, two videos of four frames
    (True, 1, (3, 16, 5, 7)),  # frame-spanning at one frame: per frame
    (False, 4, (8, 16, 6, 6)),  # per frame, num_frames ignored
    (False, 1, (2, 16, 9)),  # tokens [N, C, L]
])
@pytest.mark.parametrize("silu", [False, True])
def test_eager_chain_is_the_chain_before(dtype, across, num_frames, shape, silu):
    m = _module(shape[1], 4, across, dtype)
    x = _input(shape, dtype)
    before = gn.group_norm_cuda.launches, gn.group_norm_cuda.eager_cuda
    with torch.no_grad():
        got = m(x, num_frames, silu=silu)
        want = _chain_before(m, x, num_frames)
    if silu:
        want = F.silu(want)
    assert got.dtype == dtype and torch.equal(got, want)
    # CPU calls count neither as kernel calls nor as CUDA calls of the chain
    assert (gn.group_norm_cuda.launches, gn.group_norm_cuda.eager_cuda) == before


def _sharded_rank(mesh, x, groups: int, num_frames: int):
    """The frame-spanning GroupNorm on this rank's frames of ``x``, through
    the module (``silu`` off and on) and through the frozen chain, each
    gathered."""
    from univst_torch.distributed.comm import FrameShard
    from univst_torch.distributed.mesh import gather_frames

    shard = FrameShard.of(mesh, num_frames)
    m = _module(x.shape[1], groups, True, torch.float32)
    xt = torch.tensor(x).reshape((-1, num_frames) + x.shape[1:])
    local = xt[:, shard.offset:shard.offset + shard.local].reshape((-1,) + x.shape[1:])

    def gathered(out):
        out = out.reshape((-1, shard.local) + x.shape[1:])
        return gather_frames(out, mesh, axis=1).reshape(x.shape)

    with torch.no_grad():
        return [gathered(m(local, shard.local, shard)),
                gathered(m(local, shard.local, shard, silu=True)),
                gathered(_chain_before(m, local, shard.local, shard))]


def test_sharded_frame_spanning_form_is_the_chain_before(tmp_path):
    x = (1000.0 + td.noise(3, 2 * 8, 8, 4, 4)).astype(np.float32)
    for got, silu, want in td.run_ranks(_sharded_rank, 2, tmp_path, x, 4, 8):
        assert torch.equal(got, want) and torch.equal(silu, F.silu(want))


def test_import_and_cpu_forward_need_no_nvcc():
    """The module imports, and a CPU forward runs, with no CUDA toolkit in
    reach and without importing ``univst_torch._build``."""
    code = ("import sys, torch\n"
            "from univst_torch.models import group_norm\n"
            "from univst_torch.models.layers import GroupNorm\n"
            "y = GroupNorm(8, 2)(torch.randn(2, 8, 4, 4), silu=True)\n"
            "assert y.shape == (2, 8, 4, 4)\n"
            "assert 'univst_torch._build' not in sys.modules\n")
    env = dict(os.environ, PATH="/nonexistent", CUDA_HOME="/nonexistent",
               CUDA_PATH="/nonexistent")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_the_kernel_wrapper_refuses_what_it_does_not_take():
    x = torch.zeros(2, 8, 4, 4, dtype=torch.bfloat16)
    w = torch.ones(8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        gn.group_norm_cuda(x, w, w, 2, 1, 1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        gn.group_norm_cuda(x.float(), w, w, 2, 1, 1e-5)


def test_layout_names_what_the_kernel_takes():
    """4-d channels-last (the UNet's and the VAEs' layout) where each 8
    channels lie within two groups; nothing else: a contiguous input takes
    the eager chain."""
    x = torch.zeros(2, 320, 8, 8, dtype=torch.bfloat16)
    assert not gn.fits(x, 32)
    assert gn.fits(x.to(memory_format=torch.channels_last), 32)
    assert gn.fits(x[:, :, :4].to(memory_format=torch.channels_last), 32)
    assert gn.fits(x[:, :, :1, :1].to(memory_format=torch.channels_last), 32)
    assert not gn.fits(x.transpose(2, 3), 32)
    assert not gn.fits(x[:, :, ::2], 32)
    assert not gn.fits(x.to(memory_format=torch.channels_last)[:, :160], 32)
    assert not gn.fits(x.reshape(2, 320, 64).transpose(1, 2), 32)  # 3-d tokens
    # channels a group: 10 and 4 fit; 5 (8 channels over three groups), 2 and
    # widths that are no multiple of 8 do not
    assert gn.rows_fit(320, 32) and gn.rows_fit(128, 32) and gn.rows_fit(32, 8)
    assert not gn.rows_fit(40, 8) and not gn.rows_fit(64, 32) and not gn.rows_fit(36, 4)
    assert not gn.rows_fit(8 * 513, 513)


# (n, c, hw, frames): the SD-1.5 UNet's norms at 512 px (frame-spanning at 32
# frames of two branches and 16 of one, per frame), SD-2.1's and
# AnimateDiff's at 512 px, and the SVD and SD3 decoders' and the VAE
# encoder's
CASES = [(32, 320, 4096, 16), (32, 640, 1024, 16), (32, 2560, 64, 16), (16, 1280, 256, 16),
         (1, 320, 4096, 1), (32, 320, 4096, 1), (8, 128, 262144, 1), (4, 128, 1048576, 1),
         (32, 1280, 64, 1), (16, 320, 4096, 16), (16, 1920, 1024, 16), (2, 960, 4096, 1),
         (32, 640, 256, 16), (16, 2560, 256, 1), (8, 512, 4096, 1), (8, 256, 65536, 1),
         (4, 512, 16384, 1), (16, 128, 262144, 1), (1, 512, 1024, 1)]


@pytest.mark.parametrize("n,c,hw,frames", CASES)
def test_channels_last_plan_covers_every_row_once(n, c, hw, frames):
    p = gn.plan(n, c, hw, frames, 132)
    assert p.videos == n // frames and p.rows == frames * hw
    assert p.chunk % 8 == 0 and (p.slices - 1) * p.chunk < p.rows <= p.slices * p.chunk
    rows_a_round = 512 // (c // 8) * 4  # a block's rows in flight
    assert p.videos * p.slices >= 132 * 4 or p.chunk >= rows_a_round


def test_plan_at_the_main_shape():
    """The UNet's first resnet norm, channels-last as the UNet runs: each of
    the two videos' 65,536 rows in 256 slices of 256 (512 blocks); its
    transformer norm, per frame: 32 videos of 4096 rows in 17 slices of 248
    (544 blocks)."""
    assert gn.plan(32, 320, 4096, 16, 132) == gn.Plan(2, 65536, 256, 256)
    assert gn.plan(32, 320, 4096, 1, 132) == gn.Plan(32, 4096, 17, 248)


def test_root_spans_carry_the_jobs_group_norm_counts(monkeypatch):
    monkeypatch.setattr(gn.group_norm_cuda, "launches", 5)
    monkeypatch.setattr(gn.group_norm_cuda, "eager_cuda", 2)
    with spans(events=True):
        with SPANS.span("decode", device="cpu"):
            with SPANS.span("step", i=0):
                gn.group_norm_cuda.launches += 3
            gn.group_norm_cuda.eager_cuda += 1
    root, = [s for s in SPANS.take() if s.name == "decode"]
    assert root.attrs == {"group_norm_launches": 3, "group_norm_eager_cuda": 1}


def test_root_spans_carry_every_registered_counter(monkeypatch):
    """``profiling.JOB_COUNTERS`` is open to any module: a registered counter
    lands on the root as its change over the job; a nested span gets
    none."""
    from univst_torch.utils import profiling

    box = [7]
    monkeypatch.setitem(profiling.JOB_COUNTERS, "probe", lambda: box[0])
    with spans(events=True):
        with SPANS.span("stylize", device="cpu"):
            with SPANS.span("step", i=0):
                box[0] += 4
    got = {s.name: s.attrs for s in SPANS.take()}
    assert got["stylize"]["probe"] == 4 and "probe" not in got["step"]
