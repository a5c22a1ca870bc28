"""The plain references agree with the port at the tiny size in fp32, and
the frozen FLOP and attention-work counts with the port's own."""

import pytest
import torch

from benchmark import roofline, traffic
from benchmark.run import gaps
from benchmark.tests import tiny

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", sorted(tiny.TINY))
def test_reference_agrees_with_the_port_fp32(name):
    cell = tiny.cell(name)
    cfg, tr, sysmod = cell.config, cell.traffic, cell.system
    system = sysmod.System(cfg, tr, CPU, 21)
    inputs = traffic.input_set(tr, sysmod.latent_channels(cfg), 21, 1, CPU)
    lat = system.stylize(inputs, tr)
    frames = system.decode(lat, tr)
    g = gaps(lat, frames, *sysmod.reference_clip(cfg, tr, inputs, 21, CPU))
    # fp32 rounding over the loop; a uint8 step flips at rounding boundaries
    assert g["latent_gap"] < 2e-5 and g["frames_rms"] < 0.1, g


@pytest.mark.parametrize("name", sorted(tiny.TINY))
def test_clip_flops_match_the_port_count(name):
    """One frame a clip, where no attention slot repeats: the frozen count
    equals ``utils/flops.py::count_matmul_flops`` of the port's timed path."""
    from univst_torch.utils.flops import count_matmul_flops

    cell = tiny.cell(name)
    cfg, tr, sysmod = cell.config, dict(cell.traffic, frames=1), cell.system
    system = sysmod.System(cfg, tr, CPU, 5)
    inputs = traffic.input_set(tr, sysmod.latent_channels(cfg), 5, 0, CPU)
    port = count_matmul_flops(lambda: system.decode(system.stylize(inputs, tr), tr))
    assert sysmod.clip_flops(cfg, tr) == pytest.approx(port, rel=1e-9)


@pytest.mark.parametrize("shape,indices,ctx", [
    ((2, 16, 8, 4096, 4096, 40), (-1, 0, "first"), 0),
    ((2, 16, 8, 4096, 4096, 40), (-1, "first"), 0),
    ((1, 16, 8, 1024, 1024, 80), (-1, 0, "first"), 0),
    ((2, 16, 24, 4429, 4096, 64), ("first", -1, 0), 333),
])
def test_vfa_work_matches_the_port(shape, indices, ctx):
    from univst_torch.attention.video_flash import work

    w = work(shape, indices, ctx)
    flops, nbytes = roofline.vfa_work(*shape, indices, ctx)
    assert (flops, nbytes) == (w.flops, w.bytes)
    assert roofline.vfa_bound_s(flops, nbytes) == max(flops / 989e12, nbytes / 3.35e12)
