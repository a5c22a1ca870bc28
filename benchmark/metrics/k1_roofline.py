"""Percent of K1's roofline: the frozen bound of each traced call of the
head-major video flash attention (from its recorded shapes and index set)
over the device time of its kernel."""

from benchmark.metrics import _vfa


def read(run):
    return _vfa.roofline(run, "k1")
