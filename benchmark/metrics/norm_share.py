"""Percent of the device's busy time in normalization: operations launched
inside the program's norm ranges (``annotate_norms``: every module whose
class name ends in ``Norm``), and, outside them, the kernels that
``kernel_category`` names 'norm' (the functional layer norms, such as the
MMDiT's)."""

from benchmark.trace import kernel_category


def read(run):
    t = run.trace
    if t is None or not t.busy_ns():
        return None
    ns = sum(e - s for name, s, e, _, in_norm in t.in_window()
             if in_norm or kernel_category(name) == "norm")
    return 100.0 * ns / t.busy_ns()
