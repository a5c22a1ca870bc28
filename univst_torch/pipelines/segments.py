"""Phase split of the stylization loop (port of ``phase_segments`` in
``univst_tpu/pipelines/segments.py``).

Past the AdaIN shift window the content/style branches of the stylization
batch are dead compute (StyleShiftConfig.window_end — the reference keeps
only the stylized epsilon chunk, stable_diffusion.py:712), so the loop runs
as a multi-branch phase 1 and a stylized-only phase 2, each one Python loop.
"""

from __future__ import annotations


def phase_segments(n: int, window_end: int):
    """Split the n-step loop at the shift window.

    Returns (phase1_segments, phase2_segments) as lists of (start, length):
    phase 1 covers exactly [0, window_end), phase 2 the rest. window_end >= n
    leaves phase 2 empty.
    """
    k1 = max(0, min(n, window_end))
    phase1 = [(0, k1)] if k1 else []
    phase2 = [(k1, n - k1)] if k1 < n else []
    return phase1, phase2
