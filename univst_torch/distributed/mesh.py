"""The device mesh on ``torch.distributed`` — port of
``univst_tpu/distributed/mesh.py``.

One process per rank (``torchrun``), each on its own device, laid out as a
``('data', 'tensor')`` grid: rank ``r`` is ``data_rank * n_tensor +
tensor_rank``, so the tensor ranks of one data shard are adjacent (on one
host), as the JAX package lays its mesh out (mesh.py:67-121).

Mesh axis ``data`` shards the frame axis (and the branch x frame batch of
stylization): data rank ``d`` holds frames ``[d * F / N, (d + 1) * F / N)``
of every frame-axis tensor, and the modules exchange what crosses shards
through :mod:`univst_torch.distributed.comm` over the ``data_group`` (the
K/V halo of the sparse-causal attention, GroupNorm statistics, the temporal
convs' +/-1 frame, the motion modules' all-to-all). Mesh axis ``tensor``
splits the SD3 MMDiT's attention and MLP linears
(:mod:`univst_torch.distributed.tp`); their all-reduces run over the
``tensor_group``. The tensor ranks of a data shard hold the same frames.

Every rank holds the whole input (each reads the same files); a pipeline
under a mesh takes its data rank's slice (:func:`shard_frames`) and gathers
the outputs (:func:`gather_frames`).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A ('data', 'tensor') mesh of ``n_data x n_tensor`` ranks, each on
    ``device``. ``group`` is the whole process group (None: the default
    group); ``data_group`` the ranks that share this rank's tensor rank
    (None when ``n_data == 1``), ``tensor_group`` the ranks of its data
    shard (None when ``n_tensor == 1``), each ordered by its axis' rank. The
    backend decides how the collectives move tensors (``comm``): NCCL takes
    device tensors, gloo stages CUDA tensors through host memory."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    n_data: int
    n_tensor: int = 1
    group: Optional[dist.ProcessGroup] = None
    data_group: Optional[dist.ProcessGroup] = None
    tensor_group: Optional[dist.ProcessGroup] = None

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_tensor

    @property
    def tensor_rank(self) -> int:
        return self.rank % self.n_tensor


def make_mesh(n_data: Optional[int] = None, n_tensor: int = 1, group=None,
              device=None) -> Mesh:
    """The ``n_data x n_tensor`` mesh over an initialized process group (the
    default one unless ``group`` is given), each rank on ``device``
    (default: ``cuda:LOCAL_RANK``; with no CUDA this raises: the CPU only
    when asked for, ``device='cpu'``).
    Every rank of the group must call it: it creates the subgroups of both
    axes (``dist.new_group`` is collective)."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized (init_from_env, or "
                           "init_process_group)")
    world = dist.get_world_size(group)
    if world % n_tensor:
        raise ValueError(f"mesh tensor={n_tensor} does not divide the group's {world} ranks")
    if n_data is None:
        n_data = world // n_tensor
    if n_data * n_tensor != world:
        raise ValueError(f"mesh data={n_data},tensor={n_tensor} needs {n_data * n_tensor} "
                         f"ranks; the group has {world}")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device found; pass device='cpu' to run the "
                               "ranks on the CPU")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    key = (n_data, n_tensor, group, str(device))
    if key in _MESHES:  # the subgroups of a mesh are made once per process
        return _MESHES[key]
    rank = dist.get_rank(group)

    def glob(r):
        return r if group is None else dist.get_global_rank(group, r)

    data_group = group if n_tensor == 1 else None
    tensor_group = None
    if n_tensor > 1:
        # every rank creates every subgroup, in one order
        for t in range(n_tensor):
            g = dist.new_group([glob(d * n_tensor + t) for d in range(n_data)])
            if rank % n_tensor == t:
                data_group = g
        for d in range(n_data):
            g = dist.new_group([glob(d * n_tensor + t) for t in range(n_tensor)])
            if rank // n_tensor == d:
                tensor_group = g
    _MESHES[key] = Mesh(rank=rank, world_size=world, device=torch.device(device),
                        backend=str(dist.get_backend(group)), n_data=n_data,
                        n_tensor=n_tensor, group=group,
                        data_group=data_group if n_data > 1 else None,
                        tensor_group=tensor_group)
    return _MESHES[key]


# the meshes made in this process, by (n_data, n_tensor, group, device)
_MESHES: dict = {}


def init_from_env(device=None, timeout_s: float = 600.0, n_tensor: int = 1) -> Mesh:
    """Initialize the default process group from ``torchrun``'s environment
    (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR/PORT) and
    return the mesh of all ranks (``n_tensor`` of them on the tensor axis);
    the counterpart of
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
        _MESHES.clear()  # the groups of an earlier process group are gone
        dist.init_process_group(backend, rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]),
                                timeout=datetime.timedelta(seconds=timeout_s))
    return make_mesh(n_tensor=n_tensor, device=dev)


class MeshAxes(NamedTuple):
    n_data: Optional[int]
    n_tensor: int
    n_hosts: Optional[int]


def parse_mesh_axes(spec: Optional[str]) -> Optional[MeshAxes]:
    """The ``--mesh`` grammar of the JAX package (mesh.py:180-218):
    ``data=N[,tensor=M][,hosts=H]`` or a bare rank count ``N``; None or ''
    -> None. An unknown axis raises."""
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
    return MeshAxes(n_data, n_tensor, n_hosts)


def parse_mesh_spec(spec: Optional[str], device=None) -> Optional[Mesh]:
    """Parse the CLI ``--mesh`` flag (:func:`parse_mesh_axes`) and return
    the mesh of the ``torchrun`` ranks (:func:`init_from_env`); None or ''
    -> None. ``data=N`` times ``tensor=M`` must equal the world size (a
    missing ``data`` takes the rest); the tensor axis must divide the ranks
    of one host (LOCAL_WORLD_SIZE: its all-reduces stay within a host, as
    univst_tpu/distributed/mesh.py:106-110 requires); ``hosts=H`` must
    equal WORLD_SIZE / LOCAL_WORLD_SIZE, the hosts torchrun started."""
    axes = parse_mesh_axes(spec)
    if axes is None:
        return None
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", 1)))
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if axes.n_hosts is not None and (world % local or world // local != axes.n_hosts):
        raise ValueError(f"hosts={axes.n_hosts}, but torchrun started {world} ranks, "
                         f"{local} a host")
    n_data = world // axes.n_tensor if axes.n_data is None else axes.n_data
    if n_data * axes.n_tensor != world:
        want = n_data * axes.n_tensor
        raise ValueError(f"--mesh {spec} needs {want} ranks; launch them with torchrun "
                         f"--nproc_per_node {want} (WORLD_SIZE={world})")
    if local % axes.n_tensor:
        raise ValueError(f"tensor={axes.n_tensor} must divide the {local} ranks of one host "
                         "(tensor-parallel all-reduces stay within a host)")
    return init_from_env(device, n_tensor=axes.n_tensor)


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
    """The whole frame axis from every data rank's slice (an all-gather over
    the data group); ``x`` itself without a mesh."""
    if mesh is None or x is None or mesh.n_data == 1:
        return x
    from univst_torch.distributed.comm import all_gather_cat

    return all_gather_cat(x, mesh, axis, site)


@torch.no_grad()
def replicate(module: torch.nn.Module, mesh: Optional[Mesh]) -> torch.nn.Module:
    """Broadcast every parameter and buffer of ``module`` from rank 0 to the
    whole mesh (both axes), so that ranks which drew random weights agree;
    in place."""
    if mesh is None or mesh.world_size == 1:
        return module
    from univst_torch.distributed.comm import broadcast_

    for t in list(module.parameters()) + list(module.buffers()):
        broadcast_(t.data, mesh, site="replicate")
    return module


def shard_input(mesh: Optional[Mesh], x, axis: int = 0):
    """Pipeline input helper: :func:`shard_frames`, a no-op without a mesh."""
    return shard_frames(x, mesh, axis)


def replicate_input(mesh: Optional[Mesh], x):
    """Pipeline input helper: rank 0's ``x`` on every rank of the mesh (a
    broadcast); a no-op without a mesh."""
    if mesh is None or x is None or mesh.world_size == 1:
        return x
    from univst_torch.distributed.comm import broadcast_

    x = x.contiguous().clone()
    broadcast_(x, mesh, site="replicate_input")
    return x
