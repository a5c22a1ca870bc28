"""The GroupNorm(+SiLU) CUDA kernel (``univst_torch/csrc/group_norm.cu``)
against a float64 chain, at every shape the SD-1.5 UNet and the SVD and SD3
VAE decoders run.

Needs a CUDA card (the kernel has no CPU form) and skips without one. Imports
no JAX; ``--noconftest`` skips tests/conftest.py, which sets up JAX:

    python -m pytest --noconftest tests/test_torch_group_norm_cuda.py -m cuda -s

The bar: the kernel's output is no further from the float64 chain (the
port's eager chain on a float64 copy of the input, then a float64 SiLU) than
the eager bf16 chain's (fp32 statistics and affine, a bf16 result, then
``F.silu`` in bf16) is, times 1.05, in its largest and in its RMS absolute
error; and two calls give the same bits. Both sides round to bf16 at the
end, so their errors are of that rounding's size; the kernel rounds once
where the chain rounds twice with the SiLU. Inputs have a spread and an
offset: a spread from 1e-3 to 10 for each video's group, so that eps
(1e-5) weighs on some groups, and an offset of up to 5 spreads for each
frame's group:
planting statistics over one frame instead of 16, or eps x 10, fails the
bar. ``-s`` prints the timing table (CUDA events, L2 warm from the previous
launch).
"""

import time

import pytest
import torch
import torch.nn.functional as F

from univst_torch.models import group_norm as gn
from univst_torch.models.group_norm import group_norm_cuda, group_norm_plain

EPS = 1e-5
G = 32
# (C, H*W, frame-spanning) of the SD-1.5 UNet's 61 GroupNorms at 512 px
# (64x64 latents): the 45 frame-spanning ones (resnets, conv_norm_out; each
# followed by SiLU) and the 16 per-frame ones (the transformers' norms), as
# test_one_unet_forward_runs_the_kernel_61_times records them
UNET = [(320, 4096, True), (640, 4096, True), (960, 4096, True), (320, 1024, True),
        (640, 1024, True), (960, 1024, True), (1280, 1024, True), (1920, 1024, True),
        (640, 256, True), (1280, 256, True), (1920, 256, True), (2560, 256, True),
        (1280, 64, True), (2560, 64, True), (320, 4096, False), (640, 1024, False),
        (1280, 256, False), (1280, 64, False)]
# (N, C, H*W) of the decoders' per-frame norms: the SVD temporal decoder at
# 512 px and the SD3 VAE decoder at 1024 px, at the benchmark's decode chunks
DECODERS = ([(8, c, hw) for c, hw in ((512, 4096), (512, 16384), (512, 65536), (256, 65536),
                                      (256, 262144), (128, 262144))]
            + [(4, c, hw) for c, hw in ((512, 16384), (512, 65536), (512, 262144),
                                        (256, 262144), (256, 1048576), (128, 1048576))])
# (N, C, H*W, frames): the kernel's bars at the UNet's shapes for N = 1 (the
# style pre-pass's single frames), 16 (phase 2) and 32 (phase 1's two
# branches), statistics over 16 frames where they span frames (per frame at
# N = 1), and at the decoders'
CASES = ([(n, c, hw, 16 if across and n > 1 else 1) for c, hw, across in UNET
          for n in (1, 16, 32)] + [(n, c, hw, 1) for n, c, hw in DECODERS])


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")


def _data(n, c, hw, frames, seed):
    """bf16 x [n, c, 1, hw], channels-last (the layout the kernel takes),
    with a spread for each (video, group) and an offset of up to 5 spreads
    for each (frame, group), and bf16 weight and bias."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    scale = 10.0 ** (4.0 * torch.rand(n // frames, 1, G, 1, 1, generator=gen, device="cuda") - 3.0)
    offset = scale * (10.0 * torch.rand(n // frames, frames, G, 1, 1, generator=gen,
                                        device="cuda") - 5.0)
    x = torch.randn(n // frames, frames, G, c // G, hw, generator=gen, device="cuda") * scale \
        + offset
    w = 1.0 + 0.5 * torch.randn(c, generator=gen, device="cuda")
    b = 0.5 * torch.randn(c, generator=gen, device="cuda")
    x = x.reshape(n, c, 1, hw).to(torch.bfloat16).to(memory_format=torch.channels_last)
    assert gn.fits(x, G)
    return x, w.to(torch.bfloat16), b.to(torch.bfloat16)


def _errors(y, ref):
    d = (y.double() - ref).abs()
    return d.max().item(), d.square().mean().sqrt().item()


def _reference(x, w, b, frames, silu):
    ref = group_norm_plain(x.double(), w, b, G, EPS, frames)
    return ref * torch.sigmoid(ref) if silu else ref


def _eager(x, w, b, frames, silu):
    out = group_norm_plain(x, w, b, G, EPS, frames)
    return F.silu(out) if silu else out


def _within_bar(got, eager, ref):
    (k_max, k_rms), (e_max, e_rms) = _errors(got, ref), _errors(eager, ref)
    return k_max <= 1.05 * e_max and k_rms <= 1.05 * e_rms, (k_max, k_rms, e_max, e_rms)


@pytest.mark.cuda
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("n,c,hw,frames", CASES)
def test_group_norm_cuda_within_the_bar(n, c, hw, frames, silu):
    _card()
    x, w, b = _data(n, c, hw, frames, seed=n * 7 + c + hw)
    before = group_norm_cuda.launches
    got = group_norm_cuda(x, w, b, G, frames, EPS, silu)
    again = group_norm_cuda(x, w, b, G, frames, EPS, silu)
    torch.cuda.synchronize()
    assert group_norm_cuda.launches == before + 2
    assert got.dtype == torch.bfloat16 and got.shape == x.shape and got.stride() == x.stride()
    assert torch.equal(got, again)
    ok, errs = _within_bar(got, _eager(x, w, b, frames, silu), _reference(x, w, b, frames, silu))
    assert ok, f"kernel max / rms {errs[:2]}, eager chain {errs[2:]}"


@pytest.mark.cuda
def test_fp32_weights_and_ragged_slices():
    """fp32 weight and bias; row counts that no slice size divides, a single
    slice a video, and 8 channels over two groups (C / G = 4 and 12)."""
    _card()
    for n, c, hw, frames in ((4, 256, 49, 2), (2, 512, 3001, 1), (8, 256, 4097, 2),
                             (16, 320, 1024, 16), (3, 128, 5, 3), (2, 384, 100, 1)):
        x, w, b = _data(n, c, hw, frames, seed=c)
        w, b = w.float(), b.float()
        got = group_norm_cuda(x, w, b, G, frames, EPS, True)
        ok, errs = _within_bar(got, _eager(x, w, b, frames, True),
                               _reference(x, w, b, frames, True))
        assert ok, f"{(n, c, hw, frames)}: {errs}"


@pytest.mark.cuda
def test_the_module_takes_the_chain_where_the_kernel_does_not_fit():
    """Contiguous (channels-first), channels-last with 2 channels a group (8
    channels over four groups), channels-last 2 bytes off a 16-byte
    boundary, a non-dense view, fp32: ``layers.GroupNorm`` runs the eager
    chain and counts it."""
    _card()
    from univst_torch.models.layers import GroupNorm

    m = GroupNorm(64, G, across_frames=True).to("cuda", torch.bfloat16)
    x = torch.randn(4, 64, 8, 8, device="cuda", dtype=torch.bfloat16)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")[1:]
    shifted = shifted.as_strided(x.shape, x.to(memory_format=torch.channels_last).stride())
    shifted.copy_(x)
    cases = [x, x.to(memory_format=torch.channels_last), shifted, x[..., ::2], x.float()]
    with torch.inference_mode():
        for xx in cases:
            before = group_norm_cuda.launches, group_norm_cuda.eager_cuda
            got = m.to(xx.dtype)(xx, 2, silu=True)
            want = F.silu(group_norm_plain(xx, m.weight, m.bias, G, m.eps, 2))
            assert torch.equal(got, want)
            assert (group_norm_cuda.launches, group_norm_cuda.eager_cuda) == (before[0],
                                                                              before[1] + 1)


# (N, C, H*W, frames, fault): planted faults at the UNet's main shapes
FAULTS = [(32, 320, 4096, 16, "one_frame"), (32, 320, 4096, 16, "eps"),
          (16, 1280, 256, 16, "one_frame"), (32, 320, 4096, 1, "eps"), (4, 128, 1048576, 1, "eps")]


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,hw,frames,fault", FAULTS)
def test_planted_faults_fail_the_bar(n, c, hw, frames, fault):
    _card()
    x, w, b = _data(n, c, hw, frames, seed=5)
    kw = dict(frames=1, eps=EPS) if fault == "one_frame" else dict(frames=frames, eps=10 * EPS)
    got = group_norm_cuda(x, w, b, G, kw["frames"], kw["eps"], True)
    ok, errs = _within_bar(got, _eager(x, w, b, frames, True), _reference(x, w, b, frames, True))
    assert not ok, f"the planted fault {fault} passed the bar: {errs}"


@pytest.mark.cuda
def test_one_unet_forward_runs_the_kernel_61_times():
    """One SD-1.5 UNet forward at 512 px, 16 frames, bf16 on the card: 61
    GroupNorm calls at the shapes of ``UNET``, 45 with SiLU, each through
    the kernel, none through the eager chain."""
    _card()
    from univst_torch.models.layers import GroupNorm, VideoCtx
    from univst_torch.models.unet_sd import UNetPseudo3D, UNetSDConfig

    with torch.device("cuda"):
        unet = UNetPseudo3D(UNetSDConfig.sd15()).to(torch.bfloat16).eval()
    seen = []
    for m in unet.modules():
        if isinstance(m, GroupNorm):
            m.register_forward_pre_hook(
                lambda mod, args, kwargs: seen.append(
                    (args[0].shape[1], args[0].shape[2] * args[0].shape[3], mod.across_frames,
                     kwargs.get("silu", False))), with_kwargs=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(16, 64, 64, 4, generator=gen, device="cuda")
    ctx = torch.randn(1, 77, 768, generator=gen, device="cuda")
    before = group_norm_cuda.launches, group_norm_cuda.eager_cuda
    with torch.inference_mode():
        eps, _ = unet(x, 500, ctx, VideoCtx(num_frames=16))
    torch.cuda.synchronize()
    assert torch.isfinite(eps.float()).all()
    assert group_norm_cuda.launches - before[0] == 61
    assert group_norm_cuda.eager_cuda - before[1] == 0
    assert len(seen) == 61 and sum(s[3] for s in seen) == 45
    assert {s[:3] for s in seen} == set(UNET)


def _ms(fn, reps=20):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _host_us(fn, reps=200):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


# (N, C, H, W, frames, SiLU): the main shapes, with their roles
MAIN = [(32, 320, 64, 64, 16, True, "UNet resnet, phase 1"),
        (16, 320, 64, 64, 16, True, "UNet resnet, phase 2"),
        (32, 1920, 32, 32, 16, True, "UNet up-block resnet"),
        (32, 1280, 16, 16, 16, True, "UNet 16x16 resnet"),
        (32, 320, 64, 64, 1, False, "UNet transformer norm"),
        (8, 128, 512, 512, 1, True, "SVD decoder conv_norm_out"),
        (4, 128, 1024, 1024, 1, True, "SD3 VAE decoder conv_norm_out")]


@pytest.mark.cuda
def test_group_norm_cuda_timings(capsys):
    """Kernel ms, the eager chain's ms, ``F.group_norm``'s ms (per frame: a
    yardstick only, never called by the port), the bytes bound (x read
    once, y written once: 4 B an element; and 6 B, x read twice) at 3.35
    TB/s, and the host's us a call (kernel wrapper against the chain, on a
    small input the card keeps up with)."""
    _card()
    from univst_torch.models.layers import GroupNorm

    rows = []
    for n, c, h, wd, frames, silu, role in MAIN:
        x, w, b = _data(n, c, h * wd, frames, seed=c)
        x = x.reshape(n, c, h, wd).contiguous(memory_format=torch.channels_last)
        p = gn.plan(n, c, h * wd, frames, gn._sm_count(x.get_device()))
        k = _ms(lambda: group_norm_cuda(x, w, b, G, frames, EPS, silu))
        e = _ms(lambda: _eager(x, w, b, frames, silu))
        lib = _ms(lambda: F.group_norm(x, G, w, b, EPS))
        bound4, bound6 = 4 * x.numel() / 3.35e12 * 1e3, 6 * x.numel() / 3.35e12 * 1e3
        rows.append(dict(shape=(n, c, h, wd), frames=frames, silu=silu, role=role,
                         slices=p.slices,
                         kernel_ms=round(k, 4), eager_ms=round(e, 4), group_norm_ms=round(lib, 4),
                         bound_ms_4B=round(bound4, 4), bound_ms_6B=round(bound6, 4),
                         share_4B=round(100 * bound4 / k, 1), share_6B=round(100 * bound6 / k, 1)))
    m = GroupNorm(320, G, across_frames=True).to("cuda", torch.bfloat16)
    small = torch.randn(16, 320, 8, 8, device="cuda", dtype=torch.bfloat16).to(
        memory_format=torch.channels_last)
    with torch.inference_mode():
        host_module = _host_us(lambda: m(small, 16, silu=True))
        host_launch = _host_us(lambda: gn.launch(small, m.weight, m.bias, G, 16, EPS, True))
        host_eager = _host_us(lambda: F.silu(group_norm_plain(small, m.weight, m.bias, G, EPS,
                                                              16)))
    with capsys.disabled():
        print(f"\n[group_norm] {torch.cuda.get_device_name(0)}")
        for r in rows:
            print("[group_norm]", r)
        print(f"[group_norm] host us a call, channels-last [16, 320, 8, 8]: the module on the "
              f"kernel {host_module:.1f}, the bare launch {host_launch:.1f}, the eager chain "
              f"and F.silu {host_eager:.1f}")
    assert all(r["kernel_ms"] > 0 for r in rows)
