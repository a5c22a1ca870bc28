"""The device mesh on ``torch.distributed`` — port of
``univst_tpu/distributed/mesh.py``.

One process per rank (``torchrun``), each on its own device. Mesh axis
``data`` shards the frame axis (and the branch x frame batch of
stylization): rank ``r`` holds frames ``[r * F / N, (r + 1) * F / N)`` of
every frame-axis tensor, and the modules exchange what crosses shards
through :mod:`univst_torch.distributed.comm` (the K/V halo of the
sparse-causal attention, GroupNorm statistics, the temporal convs' +/-1
frame, the motion modules' all-to-all). Mesh axis ``tensor`` (the SD3
MMDiT's tensor parallelism) is not ported yet: ``n_tensor`` is 1.

Every rank holds the whole input (each reads the same files); a pipeline
under a mesh takes its rank's slice (:func:`shard_frames`) and gathers
the outputs (:func:`gather_frames`).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

TENSOR_NOT_PORTED = "not ported yet (SD3 tensor parallelism: next slice)"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A ('data', 'tensor') mesh of ``n_data`` ranks, each on ``device``.
    ``group`` is the process group (None: the default group). The backend
    decides how the collectives move tensors (``comm``): NCCL takes device
    tensors, gloo stages CUDA tensors through host memory."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    n_data: int
    n_tensor: int = 1
    group: Optional[dist.ProcessGroup] = None

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_tensor


def make_mesh(n_data: Optional[int] = None, group=None, device=None) -> Mesh:
    """The mesh over an initialized process group (the default one unless
    ``group`` is given): every rank of the group on the data axis, each on
    ``device`` (default: ``cuda:LOCAL_RANK`` when CUDA is available, else
    the CPU)."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized (init_from_env, or "
                           "init_process_group)")
    world = dist.get_world_size(group)
    if n_data is None:
        n_data = world
    if n_data != world:
        raise ValueError(f"mesh data={n_data} needs {n_data} ranks; the group has {world}")
    if device is None:
        device = (torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
                  if torch.cuda.is_available() else torch.device("cpu"))
    return Mesh(rank=dist.get_rank(group), world_size=world, device=torch.device(device),
                backend=str(dist.get_backend(group)), n_data=n_data, group=group)


def init_from_env(device=None, timeout_s: float = 600.0) -> Mesh:
    """Initialize the default process group from ``torchrun``'s environment
    (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR/PORT) and
    return the mesh of all ranks; the counterpart of
    ``maybe_init_distributed`` (univst_tpu/distributed/mesh.py:28-48).

    On CUDA (the default) each rank takes ``cuda:LOCAL_RANK`` and the group
    uses NCCL; a host with more local ranks than cards is refused, never
    shared silently. ``device='cpu'`` runs the ranks on the CPU over gloo.
    A default group that is initialized already is reused."""
    if not dist.is_initialized():
        for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
            if key not in os.environ:
                raise RuntimeError(f"{key} is not set: launch the ranks with torchrun "
                                   "(torchrun --nproc_per_node N -m ...)")
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", 1)))
    cpu = device is not None and torch.device(device).type == "cpu"
    if cpu:
        backend, dev = "gloo", torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device found; pass device='cpu' (or --platform cpu) "
                               "to run the ranks on the CPU")
        if local_world > torch.cuda.device_count():
            raise RuntimeError(f"{local_world} ranks on this host but {torch.cuda.device_count()} "
                               "CUDA devices: one rank per card")
        backend, dev = "nccl", torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]),
                                timeout=datetime.timedelta(seconds=timeout_s))
    return make_mesh(device=dev)


class MeshAxes(NamedTuple):
    n_data: Optional[int]
    n_tensor: int
    n_hosts: Optional[int]


def parse_mesh_axes(spec: Optional[str]) -> Optional[MeshAxes]:
    """The ``--mesh`` grammar of the JAX package (mesh.py:180-218):
    ``data=N[,tensor=M][,hosts=H]`` or a bare rank count ``N``; None or ''
    -> None. An unknown axis raises; so does ``tensor=M`` with M > 1, which
    is not ported yet."""
    if not spec:
        return None
    n_data: Optional[int] = None
    n_tensor = 1
    n_hosts: Optional[int] = None
    for part in spec.split(","):
        k, _, v = part.strip().partition("=")
        if not v:
            n_data = int(k)
        elif k == "data":
            n_data = int(v)
        elif k == "tensor":
            n_tensor = int(v)
        elif k == "hosts":
            n_hosts = int(v)
        else:
            raise ValueError(f"unknown mesh axis {k!r} (use data=N[,tensor=M][,hosts=H])")
    if n_tensor > 1:
        raise ValueError(f"mesh axis tensor={n_tensor}: {TENSOR_NOT_PORTED}")
    return MeshAxes(n_data, n_tensor, n_hosts)


def parse_mesh_spec(spec: Optional[str], device=None) -> Optional[Mesh]:
    """Parse the CLI ``--mesh`` flag (:func:`parse_mesh_axes`) and return
    the mesh of the ``torchrun`` ranks (:func:`init_from_env`); None or ''
    -> None. ``data=N`` must equal the world size; ``hosts=H`` must equal
    WORLD_SIZE / LOCAL_WORLD_SIZE, the hosts torchrun started."""
    axes = parse_mesh_axes(spec)
    if axes is None:
        return None
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", 1)))
    if axes.n_hosts is not None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if world % local or world // local != axes.n_hosts:
            raise ValueError(f"hosts={axes.n_hosts}, but torchrun started {world} ranks, "
                             f"{local} a host")
    if axes.n_data is not None and axes.n_data != world:
        raise ValueError(f"--mesh data={axes.n_data} needs {axes.n_data} ranks; launch them "
                         f"with torchrun --nproc_per_node {axes.n_data} (WORLD_SIZE={world})")
    return init_from_env(device)


def shard_frames(x, mesh: Optional[Mesh], axis: int = 0):
    """The rank's slice of ``x``'s frame axis; ``x`` itself where the axis
    does not divide the mesh (replicated, as mesh.py:170-177 does for the
    ``[N+1, 1, ...]`` singleton style trajectory) or without a mesh."""
    if mesh is None or x is None or mesh.n_data == 1:
        return x
    n = x.shape[axis]
    if n % mesh.n_data:
        return x
    local = n // mesh.n_data
    return x.narrow(axis, mesh.data_rank * local, local)


def gather_frames(x, mesh: Optional[Mesh], axis: int = 0, site: str = "gather"):
    """The whole frame axis from every rank's slice (an all-gather);
    ``x`` itself without a mesh."""
    if mesh is None or x is None or mesh.n_data == 1:
        return x
    from univst_torch.distributed.comm import all_gather_cat

    return all_gather_cat(x, mesh, axis, site)


@torch.no_grad()
def replicate(module: torch.nn.Module, mesh: Optional[Mesh]) -> torch.nn.Module:
    """Broadcast every parameter and buffer of ``module`` from rank 0, so
    that ranks which drew random weights agree; in place."""
    if mesh is None or mesh.n_data == 1:
        return module
    from univst_torch.distributed.comm import broadcast_

    for t in list(module.parameters()) + list(module.buffers()):
        broadcast_(t.data, mesh, site="replicate")
    return module


def shard_input(mesh: Optional[Mesh], x, axis: int = 0):
    """Pipeline input helper: :func:`shard_frames`, a no-op without a mesh."""
    return shard_frames(x, mesh, axis)


def replicate_input(mesh: Optional[Mesh], x):
    """Pipeline input helper: rank 0's ``x`` on every rank (a broadcast); a
    no-op without a mesh."""
    if mesh is None or x is None or mesh.n_data == 1:
        return x
    from univst_torch.distributed.comm import broadcast_

    x = x.contiguous().clone()
    broadcast_(x, mesh, site="replicate_input")
    return x
