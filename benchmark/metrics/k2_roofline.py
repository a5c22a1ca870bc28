"""Percent of K2's roofline: the frozen bound of each traced call of the
token-major video flash attention (from its recorded shapes, index set and
context length) over the device time of its kernel."""

from benchmark.metrics import _vfa


def read(run):
    return _vfa.roofline(run, "k2")
