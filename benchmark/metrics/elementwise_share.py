"""Percent of the device's busy time in PyTorch's elementwise and
reduction kernels (``kernel_category`` 'elementwise'), outside the norm
ranges."""

from benchmark.trace import kernel_category


def read(run):
    t = run.trace
    if t is None or not t.busy_ns():
        return None
    ns = sum(e - s for name, s, e, _, in_norm in t.in_window()
             if not in_norm and kernel_category(name) == "elementwise")
    return 100.0 * ns / t.busy_ns()
