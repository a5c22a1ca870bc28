"""Percent of the card's dense bf16 peak: the matmul, convolution and
attention FLOPs of the jobs the untraced window completed, counted once on
the plain reference (``clip_flops``), over the window's length."""

from benchmark.roofline import PEAK_BF16_FLOPS


def read(run):
    if not run.clips or not run.window_s:
        return None
    return 100.0 * run.clips * run.flops_per_clip() / run.window_s / PEAK_BF16_FLOPS
