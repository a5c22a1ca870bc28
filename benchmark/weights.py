"""Seeded weights and inputs, made by the benchmark on the device.

The weights are drawn for a list of parameter names and shapes (the
reference's, in name order) from one ``torch.Generator`` in a few large
``randn`` calls of about ``CHUNK`` values each, in bfloat16, and written into
whichever tensors the caller gives for those names: the program's
parameters, or the reference's. The same seed gives the same values on both
sides, whatever their dtype.

The init family: a matrix or kernel ``N(0, 1 / fan_in)``; a norm scale
``1 + 0.05 N``; a bias ``0.05 N``; the temporal decoder's blend factors
``0.5 + 0.05 N``.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterable, Tuple

import torch

CHUNK = 1 << 28  # values a randn call draws, at least (about 0.5 GB in bf16)


def sub_seed(seed: int, *tags) -> int:
    """A seed for one stream of a run (weights, one input set, the sample),
    from the run's seed."""
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def _value(name: str, x: torch.Tensor) -> torch.Tensor:
    if x.dim() >= 2:
        return x * (x[0].numel() ** -0.5)
    if name.endswith("mix_factor"):
        return 0.5 + 0.05 * x
    if name.endswith("weight"):
        return 1.0 + 0.05 * x
    return 0.05 * x


@torch.no_grad()
def fill(targets: Dict[str, torch.Tensor], seed: int, device) -> None:
    """Write the seeded values of every name in ``targets`` into its
    tensor, in place."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    names = sorted(targets)
    i = 0
    while i < len(names):
        group, n = [], 0
        while i < len(names) and (not group or n < CHUNK):
            group.append(names[i])
            n += targets[names[i]].numel()
            i += 1
        buf = torch.randn(n, generator=gen, device=device, dtype=torch.bfloat16)
        off = 0
        for name in group:
            t = targets[name]
            t.copy_(_value(name, buf[off:off + t.numel()].view(t.shape)))
            off += t.numel()
        del buf


def spec(named: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, tuple]:
    return {k: tuple(v.shape) for k, v in named}


def check_spec(want: Dict[str, tuple], got: Dict[str, tuple], what: str) -> None:
    """The program's parameters have exactly the reference's names and
    shapes; raises naming the differences."""
    if want == got:
        return
    missing = sorted(set(want) - set(got))[:5]
    extra = sorted(set(got) - set(want))[:5]
    shapes = [(k, want[k], got[k]) for k in sorted(set(want) & set(got)) if want[k] != got[k]][:5]
    raise ValueError(f"{what}: the program's parameters differ from the reference's: "
                     f"missing {missing}, extra {extra}, shapes {shapes}")
