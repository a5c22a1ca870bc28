"""Collective census of frame-parallel runs — the counterpart of
``univst_tpu/distributed/hlo_census.py::collect_collectives``.

The JAX package reads its collectives out of the partitioned HLO; the port
makes each collective an explicit call of ``distributed.comm``, which
records ``(op, payload_bytes, site, host_seconds)``. :func:`collect_collectives` opens a
census over a block of code, :func:`summarize` sums it by op, and
:func:`profiler_collectives` counts the collectives a ``torch.profiler``
trace saw (the ``nccl:*`` / ``gloo:*`` ranges PyTorch's process groups
emit), and :func:`profiler_ops` sums them by the census' op names
(``all_gather``, ``all_to_all``, ``broadcast``, ``all_reduce``: the names
after the backend's prefix), a cross-check, op by op, that no collective
bypassed the comm layer.
"""

from __future__ import annotations

import contextlib
from collections import Counter
from typing import Dict, Iterator, List, Tuple

from univst_torch.distributed import comm

Record = Tuple[str, int, str, float]


@contextlib.contextmanager
def collect_collectives() -> Iterator[List[Record]]:
    """``with collect_collectives() as recs:`` — ``recs`` fills with one
    ``(op, payload_bytes, site, host_seconds)`` per collective issued in
    the block."""
    recs: List[Record] = []
    comm._sinks.append(recs)
    try:
        yield recs
    finally:
        comm._sinks.remove(recs)


def summarize(records: List[Record], by_site: bool = False) -> Dict[str, dict]:
    """``{op: {"count": n, "mb": payload MB, "host_ms": ms}}`` over
    ``records`` (keys ``"op:site"`` with ``by_site``)."""
    out: Dict[str, dict] = {}
    for op, nbytes, site, seconds in records:
        s = out.setdefault(f"{op}:{site}" if by_site else op,
                           {"count": 0, "mb": 0.0, "host_ms": 0.0})
        s["count"] += 1
        s["mb"] += nbytes / 1e6
        s["host_ms"] += seconds * 1e3
    return out


def profiler_collectives(prof) -> Counter:
    """Collectives by name in a finished ``torch.profiler.profile``: its
    host-side ``nccl:<op>`` or ``gloo:<op>`` ranges, one per collective
    call. A trace with CUDA activity also holds each NCCL range's copy on
    the device timeline (a GPU user annotation), which is not counted."""
    from torch.autograd import DeviceType

    return Counter(e.name for e in prof.events()
                   if e.name.startswith(("nccl:", "gloo:")) and e.device_type == DeviceType.CPU)


def profiler_ops(prof) -> Counter:
    """:func:`profiler_collectives` by op, the backend prefix dropped: the
    census' op names (``Counter(op for op, *_ in records)`` of the same
    block, when no collective bypassed ``distributed.comm``)."""
    out: Counter = Counter()
    for name, n in profiler_collectives(prof).items():
        out[name.split(":", 1)[1]] += n
    return out
