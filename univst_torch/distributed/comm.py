"""The collectives of frame-parallel inference, explicit and counted.

XLA's partitioner derived these for the JAX package from the shardings;
here each is one call of this module:

  * :func:`frame_halo`: the K/V of the source frames of a rank's targets
    that live on other ranks (frame 0 and the frame before the shard for
    the SD index sets), one all-to-all that moves only those frames;
  * :func:`sharded_var_mean`: statistics over a frame axis that spans
    ranks, each rank's own ``var_mean`` combined with Chan's parallel
    formula (not E[x^2] - E[x]^2, which cancels on large means);
  * :func:`halo_1d`: the +/-1 frame of a 3-tap temporal conv, zero at the
    clip's ends;
  * :func:`ulysses_to_tokens` / :func:`ulysses_to_frames`: the all-to-all
    pair that swaps the sharded frame axis onto the token axis and back;
  * :func:`all_gather_cat`, :func:`broadcast_`: whole-tensor gathers (the
    outputs) and replication (weights, inputs);
  * :func:`all_reduce_`: the sum over the tensor axis after a row-parallel
    linear (:mod:`univst_torch.distributed.tp`), staged through fp32.

The frame collectives run over the mesh's ``data_group``, whose ranks are
the data ranks (so a frame's owner, :meth:`FrameShard.owner`, is the
group-local rank the all-to-all splits address; on a ``tensor=M`` mesh each
of the M data groups exchanges among the ranks of one tensor rank); the
all-reduce over the ``tensor_group``; a broadcast over the whole mesh.

The backend decides how tensors travel: NCCL takes device tensors; gloo,
which has no CUDA all-to-all, takes CPU tensors, so under gloo every
collective stages a CUDA tensor through host memory. Every call records
``(op, payload_bytes, site, host_seconds)`` into the open censuses
(:mod:`univst_torch.distributed.census`). ``payload_bytes`` is what the
call brings into this rank from the others (a broadcast: the tensor's
bytes); ``host_seconds`` the host clock around the call, staging included.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

from univst_torch.distributed.mesh import Mesh

# open censuses: lists that every call appends (op, payload_bytes, site,
# host_seconds) to
_sinks: List[list] = []


def _record(op: str, nbytes: int, site: str, seconds: float) -> None:
    for sink in _sinks:
        sink.append((op, int(nbytes), site, seconds))


@dataclasses.dataclass(frozen=True, eq=False)
class FrameShard:
    """Where a rank's frames sit in the clip: ``num_frames`` global frames,
    this rank's first at ``offset``, ``num_frames / mesh.n_data`` of them."""

    mesh: Mesh
    num_frames: int
    offset: int

    @property
    def local(self) -> int:
        return self.num_frames // self.mesh.n_data

    def owner(self, frame: int) -> int:
        """The data rank that holds ``frame``: the rank of the data group
        (the ranks of this rank's tensor rank) that the exchanges address."""
        return frame // self.local

    @classmethod
    def of(cls, mesh: Mesh, num_frames: int) -> "FrameShard":
        if num_frames % mesh.n_data:
            raise ValueError(f"{num_frames} frames do not split over {mesh.n_data} ranks")
        return cls(mesh, num_frames, mesh.data_rank * (num_frames // mesh.n_data))


def _staged(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """``x``, contiguous, where the backend takes it: on the host for gloo."""
    x = x.contiguous()
    return x.cpu() if mesh.backend == "gloo" and x.device.type != "cpu" else x


def all_gather_cat(x: torch.Tensor, mesh: Mesh, dim: int, site: str) -> torch.Tensor:
    """Every data rank's ``x`` concatenated along ``dim`` in data-rank order."""
    t0 = time.perf_counter()
    xs = _staged(mesh, x)
    parts = [torch.empty_like(xs) for _ in range(mesh.n_data)]
    dist.all_gather(parts, xs, group=mesh.data_group)
    out = torch.cat(parts, dim=dim).to(x.device)
    _record("all_gather", xs.numel() * xs.element_size() * (mesh.n_data - 1), site,
            time.perf_counter() - t0)
    return out


def broadcast_(x: torch.Tensor, mesh: Mesh, site: str) -> torch.Tensor:
    """Rank 0's ``x`` into every rank's ``x``, both axes (in place)."""
    t0 = time.perf_counter()
    xs = _staged(mesh, x)
    dist.broadcast(xs, src=0 if mesh.group is None else dist.get_global_rank(mesh.group, 0),
                   group=mesh.group)
    if xs.data_ptr() != x.data_ptr():
        x.copy_(xs)
    _record("broadcast", x.numel() * x.element_size(), site, time.perf_counter() - t0)
    return x


def all_reduce_(x: torch.Tensor, mesh: Mesh, site: str) -> torch.Tensor:
    """The sum of every tensor rank's ``x`` into ``x`` (in place), over the
    tensor group. The sum runs in fp32 and is cast back once, so gloo and
    NCCL add alike and the sum itself adds no bf16 rounding (the partial
    sums it takes were rounded by the caller). ``payload_bytes``: the fp32
    partial sums of the other tensor ranks."""
    t0 = time.perf_counter()
    xs = x.float() if x.dtype != torch.float32 else x.contiguous()
    xs = xs.cpu() if mesh.backend == "gloo" and xs.device.type != "cpu" else xs
    dist.all_reduce(xs, group=mesh.tensor_group)
    if xs.data_ptr() != x.data_ptr():
        x.copy_(xs)
    _record("all_reduce", xs.numel() * xs.element_size() * (mesh.n_tensor - 1), site,
            time.perf_counter() - t0)
    return x


def _exchange(sends: Sequence[torch.Tensor], recv_counts: Sequence[int], mesh: Mesh,
              site: str) -> torch.Tensor:
    """One all-to-all over the data group along dim 0: ``sends[j]`` goes to
    data rank j, and data rank i's ``recv_counts[i]`` rows arrive,
    concatenated in rank order."""
    t0 = time.perf_counter()
    ref = sends[0]
    send = _staged(mesh, torch.cat(list(sends)))
    rest = tuple(ref.shape[1:])
    recv = torch.empty((sum(recv_counts),) + rest, dtype=send.dtype, device=send.device)
    dist.all_to_all_single(recv, send, output_split_sizes=list(recv_counts),
                           input_split_sizes=[int(s.shape[0]) for s in sends],
                           group=mesh.data_group)
    out = recv.to(ref.device)
    row = recv.element_size()
    for s in rest:
        row *= s
    _record("all_to_all", (sum(recv_counts) - recv_counts[mesh.data_rank]) * row, site,
            time.perf_counter() - t0)
    return out


def frame_halo(x: torch.Tensor, shard: FrameShard, needs: Sequence[Tuple[int, ...]],
               site: str = "halo") -> torch.Tensor:
    """The frames of other ranks that this rank reads.

    ``x`` is this rank's ``[B, f, ...]`` (frames on axis 1); ``needs[r]`` the
    sorted global frames, outside its own shard, that rank r reads. Returns
    ``[B, len(needs[rank]), ...]`` in that order: one all-to-all in which
    each rank sends each other rank the frames it owns and that rank
    reads, and nothing else."""
    me, off = shard.mesh.data_rank, shard.offset
    xt = x.transpose(0, 1)  # frames first: the all-to-all splits dim 0
    sends = []
    for r in range(shard.mesh.n_data):
        mine = [g - off for g in needs[r] if shard.owner(g) == me] if r != me else []
        sends.append(xt[torch.as_tensor(mine, dtype=torch.long, device=x.device)])
    counts = [sum(1 for g in needs[me] if shard.owner(g) == r) for r in range(shard.mesh.n_data)]
    return _exchange(sends, counts, shard.mesh, site).transpose(0, 1)


def halo_1d(x: torch.Tensor, shard: FrameShard, dim: int, site: str = "halo_1d") -> torch.Tensor:
    """``x`` with one frame more on each side along ``dim``: the frame before
    the shard and the one after it, from the neighbour ranks, zeros at the
    clip's first and last frame (the zero padding of a 3-tap temporal
    conv)."""
    n, f, off = shard.mesh.n_data, shard.local, shard.offset
    needs = tuple(tuple(g for g in (r * f - 1, (r + 1) * f) if 0 <= g < shard.num_frames)
                  for r in range(n))
    xm = x.movedim(dim, 1)
    got = frame_halo(xm, shard, needs, site)
    zero = torch.zeros_like(xm[:, :1])
    prev = got[:, :1] if off > 0 else zero
    nxt = got[:, -1:] if off + f < shard.num_frames else zero
    return torch.cat([prev, xm, nxt], dim=1).movedim(1, dim)


def sharded_var_mean(x: torch.Tensor, dims: Sequence[int], shard: FrameShard,
                     site: str = "var_mean") -> Tuple[torch.Tensor, torch.Tensor]:
    """``torch.var_mean(x, dims, unbiased=False, keepdim=True)`` where one of
    ``dims`` is a frame axis split over the ranks. Each rank reduces its own
    frames (``var_mean``, two-pass, and its mean once more with a float64
    sum); an all-gather of every rank's (count, mean, variance) and Chan's
    parallel formula combine them in float64:
    mean = sum n_i m_i / n, M2 = sum n_i v_i + sum n_i (m_i - mean)^2.
    The float64 means keep the cross term exact where the mean is large
    against the spread (a float32 mean of ~1e3 is off by ~3e-5)."""
    var, _ = torch.var_mean(x, dim=tuple(dims), unbiased=False, keepdim=True)
    count = 1
    for d in dims:
        count *= x.shape[d]
    mean = x.sum(dim=tuple(dims), keepdim=True, dtype=torch.float64) / count
    stats = torch.stack([torch.full_like(mean, float(count)), mean, var.double()])
    allst = all_gather_cat(stats[None], shard.mesh, 0, site)  # [N, 3, ...]
    n_i, m_i, v_i = allst[:, 0], allst[:, 1], allst[:, 2]
    n = n_i.sum(0)
    mean = (n_i * m_i).sum(0) / n
    m2 = (n_i * v_i).sum(0) + (n_i * (m_i - mean).square()).sum(0)
    return (m2 / n).to(x.dtype), mean.to(x.dtype)


def ulysses_to_tokens(x: torch.Tensor, shard: FrameShard, site: str = "ulysses") -> torch.Tensor:
    """``[B*f, L, D]`` (this rank's frames, every token) -> ``[B*F, L/N, D]``
    (every frame, this rank's slice of the tokens): one all-to-all. A token
    count that does not divide the mesh gathers the frames instead
    (``[B*F, L, D]`` on every rank, one all-gather), as the JAX package's
    motion modules do (unet_ad.py:199)."""
    n, f = shard.mesh.n_data, shard.local
    bf, l, d = x.shape
    b = bf // f
    if l % n:
        return all_gather_cat(x.reshape(b, f, l, d), shard.mesh, 1,
                              site + "_gather").reshape(b * n * f, l, d)
    parts = x.reshape(b, f, n, l // n, d).permute(2, 0, 1, 3, 4)  # [N, B, f, L/N, D]
    # [N (source rank), B, f, L/N, D]
    got = _exchange([p[None] for p in parts], [1] * n, shard.mesh, site)
    return got.transpose(0, 1).reshape(b * n * f, l // n, d)


def ulysses_to_frames(x: torch.Tensor, shard: FrameShard, tokens: int,
                      site: str = "ulysses") -> torch.Tensor:
    """The inverse of :func:`ulysses_to_tokens` for ``tokens`` = L tokens a
    frame: ``[B*F, L/N, D]`` -> ``[B*f, L, D]`` (one all-to-all), or, where
    the frames were gathered, this rank's frames of ``[B*F, L, D]``."""
    n, f = shard.mesh.n_data, shard.local
    bF, lt, d = x.shape
    b = bF // (n * f)
    if tokens % n:
        x = x.reshape(b, n * f, lt, d)[:, shard.offset:shard.offset + f]
        return x.reshape(b * f, lt, d)
    parts = x.reshape(b, n, f, lt, d).transpose(0, 1)  # [N (target rank), B, f, L/N, D]
    # [N (token slice), B, f, L/N, D]
    got = _exchange([p[None] for p in parts], [1] * n, shard.mesh, site)
    return got.permute(1, 2, 0, 3, 4).reshape(b * f, n * lt, d)
