"""Shared arithmetic of the two video flash attention rooflines."""

from benchmark.roofline import vfa_bound_s, vfa_work


def roofline(run, which: str):
    """Percent of the bound of ``which``'s (``"k1"``, ``"k2"``) traced calls
    over their kernels' device time."""
    t = run.trace
    calls = None if t is None else t.vfa_calls.get(which)
    if not calls:
        return None
    bound, dev = 0.0, 0
    for (q, k, indices, ctx), ns in calls:
        if which == "k1":  # q [B, F, H, Lq, dh], k [B, F, H, L, dh]
            b, f, h, lq, dh = q
            l = k[3]
        else:  # q [B, F, Lq, H, dh], k [B, F, L, H, dh]
            b, f, lq, h, dh = q
            l = k[2]
        bound += vfa_bound_s(*vfa_work(b, f, h, lq, l, dh, indices, ctx))
        dev += ns
    return 100.0 * bound / (dev / 1e9)
