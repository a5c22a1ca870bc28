"""Tensor parallelism of the SD3 / SD3.5 MMDiT — port of
``univst_tpu/distributed/tp.py``.

The JAX package states Megatron-style rules as NamedShardings and lets XLA
insert the sums; here each rule splits an ``nn.Linear`` in place and each
sum is one counted ``comm.all_reduce_`` over the mesh's tensor group:

  * column-parallel (the output features split, so the heads split): the
    attention's ``to_q`` / ``to_k`` / ``to_v`` and ``add_q/k/v_proj``, the
    MLPs' first linear (``ff.net.0.proj``, ``ff_context.net.0.proj``);
  * row-parallel (the input features split; the partial products summed
    over the tensor ranks, then the bias added once): ``to_out.0``,
    ``to_add_out``, the MLPs' second linear (``ff.net.2``,
    ``ff_context.net.2``);
  * replicated: everything else (norms, modulation linears, embedders, the
    output head).

Every split is of whole units, near-even: tensor rank ``r`` of ``M`` takes
``n // M + (r < n % M)`` of ``n`` units (:func:`share`), its units after
those of the ranks before it. The attention linears' unit is a head
(``head_dim`` rows or columns), the MLPs' one hidden feature. So a tensor
rank computes its own heads' attention, ``H // M`` or one more (SD3.5-large's
38 on ``tensor=4``: 10, 10, 9, 9), and its share of each MLP's hidden
features (9728 / 4 exactly); the activations between blocks are whole and
equal on every tensor rank, bit for bit, after each all-reduce. The per-head
q/k RMS norms and the SD3 AdaIN shift reduce within a head and need no
collective. :func:`check_heads` refuses what the JAX package cannot place
(a tensor axis that does not divide the q/k/v columns) and an axis with
more ranks than heads, where a rank would hold no whole head (XLA would
split a head at a column boundary; K2 takes whole heads).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from univst_torch.distributed import comm
from univst_torch.distributed.mesh import Mesh
from univst_torch.models.mmdit import DualSelfAttention, JointAttention

COLUMN = ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj",
          "ff.net.0.proj", "ff_context.net.0.proj")
ROW = ("to_out.0", "to_add_out", "ff.net.2", "ff_context.net.2")
MLP = ("ff.net.0.proj", "ff_context.net.0.proj", "ff.net.2", "ff_context.net.2")


def _matches(name: str, suffixes) -> bool:
    return any(name == s or name.endswith("." + s) for s in suffixes)


def role(name: str) -> str:
    """The split of the MMDiT linear at module path ``name`` (its state-dict
    prefix): 'column', 'row' or 'replicated'
    (univst_tpu/distributed/tp.py:6-23)."""
    for kind, suffixes in (("column", COLUMN), ("row", ROW)):
        if _matches(name, suffixes):
            return kind
    return "replicated"


def share(n: int, parts: int, index: int) -> slice:
    """Part ``index`` of ``n`` whole units split over ``parts`` as evenly as
    they go: the first ``n % parts`` parts take one unit more."""
    base, extra = divmod(n, parts)
    start = index * base + min(index, extra)
    return slice(start, start + base + (index < extra))


def local_heads(num_heads: int, mesh: Mesh) -> int:
    """The heads tensor rank ``mesh.tensor_rank`` computes."""
    part = share(num_heads, mesh.n_tensor, mesh.tensor_rank)
    return part.stop - part.start


def _part(n: int, mesh: Mesh, unit: int) -> slice:
    """This tensor rank's features of ``n``, split in whole ``unit``s."""
    part = share(n // unit, mesh.n_tensor, mesh.tensor_rank)
    return slice(part.start * unit, part.stop * unit)


class ColumnParallelLinear(nn.Module):
    """This tensor rank's rows of a linear's weight and bias (its share of
    the output features, in order, in whole ``unit``s): no collective."""

    def __init__(self, linear: nn.Linear, mesh: Mesh, unit: int = 1):
        super().__init__()
        part = _part(linear.out_features, mesh, unit)
        self.weight = nn.Parameter(linear.weight.data[part].clone(), requires_grad=False)
        self.bias = (None if linear.bias is None
                     else nn.Parameter(linear.bias.data[part].clone(), requires_grad=False))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class RowParallelLinear(nn.Module):
    """This tensor rank's columns of a linear's weight (its share of the
    input features, which the column-parallel layer before it produced);
    each rank's partial product is computed in the working type (so in
    bf16 it is rounded once before the sum), the partial products are
    summed over the tensor group in fp32 (``comm.all_reduce_``), the bias,
    held whole, is added once to the sum, and the sum is rounded to the
    working type: M + 1 roundings where the one-card GEMM rounds once."""

    def __init__(self, linear: nn.Linear, mesh: Mesh, site: str, unit: int = 1):
        super().__init__()
        self.mesh, self.site = mesh, site
        part = _part(linear.in_features, mesh, unit)
        self.weight = nn.Parameter(linear.weight.data[:, part].clone(), requires_grad=False)
        self.bias = (None if linear.bias is None
                     else nn.Parameter(linear.bias.data.clone(), requires_grad=False))

    def forward(self, x):
        y = comm.all_reduce_(F.linear(x, self.weight).float(), self.mesh, self.site)
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype)


def check_heads(num_heads: int, n_tensor: int, head_dim: int = 64) -> None:
    """Refuse a tensor axis the JAX package cannot place: one that does not
    divide the q/k/v columns, ``num_heads * head_dim``, which its column
    splits need (univst_tpu/distributed/tp.py:25-33; the MLPs' width, 4x
    that, then divides too); and one with more ranks than heads, where a
    rank would hold no whole head."""
    cols = num_heads * head_dim
    why = (f"{cols} q/k/v columns" if cols % n_tensor
           else "a rank would hold no whole head" if n_tensor > num_heads else None)
    if why:
        raise ValueError(f"tensor={n_tensor} does not divide the MMDiT's {num_heads} heads of "
                         f"{head_dim}: {why} (e.g. tensor=2 or 4 for SD3.5-large's 38)")


@torch.no_grad()
def shard_mmdit(mmdit: nn.Module, mesh: Optional[Mesh]) -> nn.Module:
    """Split ``mmdit``'s linears by :func:`role` over ``mesh``'s tensor axis,
    in place (weights as loaded; replicate them first), the attention
    linears in whole heads and the MLPs' in features, and give each
    attention the rank's head count (:func:`local_heads`). A no-op without
    a tensor axis."""
    if mesh is None or mesh.n_tensor == 1:
        return mmdit
    cfg = mmdit.cfg
    check_heads(cfg.num_heads, mesh.n_tensor, cfg.head_dim)
    for name, module in list(mmdit.named_modules()):
        if not isinstance(module, nn.Linear) or role(name) == "replicated":
            continue
        parent_name, _, leaf = name.rpartition(".")
        parent = mmdit.get_submodule(parent_name)
        unit = 1 if _matches(name, MLP) else cfg.head_dim
        new = (ColumnParallelLinear(module, mesh, unit) if role(name) == "column"
               else RowParallelLinear(module, mesh, _site(name), unit))
        if isinstance(parent, nn.ModuleList):
            parent[int(leaf)] = new
        else:
            setattr(parent, leaf, new)
    for module in mmdit.modules():
        if isinstance(module, (JointAttention, DualSelfAttention)):
            module.num_heads = local_heads(cfg.num_heads, mesh)
    return mmdit


def _site(name: str) -> str:
    """A row-parallel linear's census site: its path within the block
    (``attn.to_out``, ``attn2.to_out``, ``attn.to_add_out``, ``ff``,
    ``ff_context``)."""
    within = name.split(".", 2)[-1] if name.startswith("transformer_blocks.") else name
    for tail in (".0", ".net.2"):
        if within.endswith(tail):
            return within[:-len(tail)]
    return within
