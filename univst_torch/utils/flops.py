"""Matmul, convolution and attention FLOPs of one call — port of
``univst_tpu/utils/flops.py``.

The JAX package walks a traced jaxpr and counts ``dot_general`` and
``conv_general_dilated``; here :class:`torch.utils.flop_counter.FlopCounterMode`
counts the same families as they run: ``mm`` / ``addmm`` / ``bmm`` /
``baddbmm``, ``convolution`` and the fused attention ops (4 * B * H * Lq *
Lk * dh each). Elementwise and normalization FLOPs are not counted, the MFU
convention of both packages.

What each side sees:
  * The K1 / K2 video flash attention kernels are custom ops to the counter,
    as ``pallas_call`` is opaque to the jaxpr walk: each call adds
    ``univst_torch.attention.video_flash.work`` FLOPs (the formula
    registered there), the count the kernel table's bound uses, on the CPU's
    plain path as on the card. The jaxpr walk does not see the Pallas
    kernels at all; the JAX package's callers add ``attention_extra_flops``.
  * PyTorch registers no formula for the CPU's fused attention
    (``aten._scaled_dot_product_flash_attention_for_cpu``); this module adds
    the one of its CUDA siblings, so attention counts on both devices. The
    JAX package on the CPU runs attention as two einsums, counted alike.
"""

from __future__ import annotations

from typing import Mapping, Union

import torch
from torch import nn
from torch.utils.flop_counter import (
    FlopCounterMode,
    flop_registry,
    register_flop_formula,
    sdpa_flop_count,
)

import univst_torch.attention.video_flash  # noqa: F401  (registers the K1 / K2 formulas)

_CPU_SDPA = torch.ops.aten._scaled_dot_product_flash_attention_for_cpu
if _CPU_SDPA not in flop_registry:
    @register_flop_formula(_CPU_SDPA)
    def _cpu_sdpa_flops(query_shape, key_shape, value_shape, *args, out_shape=None,
                        **kwargs) -> int:
        return sdpa_flop_count(query_shape, key_shape, value_shape)


def count_matmul_flops(fn, *args, **kwargs) -> float:
    """Total matmul, conv and attention FLOPs of one call of
    ``fn(*args, **kwargs)`` (the call runs)."""
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def attention_extra_flops(batch: int, heads: int, lq: int, lk: int, dh: int) -> float:
    """QK^T + PV FLOPs of one attention (for a path the counter can't see)."""
    return 4.0 * batch * heads * lq * lk * dh


def state_bytes(module_or_state_dict: Union[nn.Module, Mapping[str, torch.Tensor]]) -> int:
    """Bytes held by a module's parameters and buffers, or by a state dict's
    tensors."""
    sd = (module_or_state_dict.state_dict() if isinstance(module_or_state_dict, nn.Module)
          else module_or_state_dict)
    return int(sum(t.numel() * t.element_size() for t in sd.values()))
