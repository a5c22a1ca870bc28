"""Live LoRA adapters — port of ``univst_tpu/models/lora.py``.

The reference merges a webui-format LoRA into the checkpoint at load
(``W <- W + alpha * up @ down``, :func:`univst_torch.models.convert_ldm.merge_lora`);
its "live" attention processors are dead code (no CLI builds them, and their
``nn.Conv1d`` adapter would mix tokens, video_diffusion_sd/models/lora.py:28-137).
The live path here keeps the merge path's semantics: the LoRA becomes, once,
a state-dict **delta** (alpha = 1) under the port's own key names (the
diffusers keys), and :func:`apply_lora` gives the adapted weights as
``base + scale * delta`` for any scale, leaving the module's weights as they
are. At the same alpha the adapted weights equal the merge path's.

:func:`apply_lora` returns a state dict for :func:`torch.func.functional_call`
rather than patching the module in a context manager: like the JAX
package's pure ``apply_lora(params, delta, scale)``, it never writes the
module, so a failure half-way leaves nothing to restore and two scales can
be used side by side on one module.

:class:`LoRALinearLayer` is the rank-factorized module form (zero-init up,
the standard LoRA init) for models that want the adapter in the forward.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from univst_torch.models.convert_ldm import merge_lora


class LoRALinearLayer(nn.Module):
    """Rank-factorized adapter: ``delta(x) = up(down(x))``.

    ``up`` is zero-initialized so the adapter is exactly inert at init
    (reference lora.py:47); ``down`` is drawn normal with std 1 / rank
    (lora.py:44). The rank is clamped to the smaller of the two widths.
    """

    def __init__(self, in_features: int, features: int, rank: int = 4):
        super().__init__()
        rank = min(rank, min(in_features, features))
        self.down = nn.Linear(in_features, rank, bias=False)
        self.up = nn.Linear(rank, features, bias=False)
        nn.init.normal_(self.down.weight, std=1.0 / rank)
        nn.init.zeros_(self.up.weight)

    def forward(self, x):
        return self.up(self.down(x))


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def lora_delta_state_dict(base_sd: Mapping, lora_sd: Mapping) -> Dict[str, torch.Tensor]:
    """A webui-format LoRA as an fp32 delta over the keys it changes (alpha
    = 1): ``merge_lora(base, lora, 1) - base``. ``base_sd`` is the target
    module's state dict (diffusers keys, tensors or arrays)."""
    base = {k: _numpy(v).astype(np.float32) for k, v in base_sd.items()}
    lora = {k: _numpy(v) for k, v in lora_sd.items()}
    merged = merge_lora(base, lora, alpha=1.0)
    return {k: torch.from_numpy(merged[k] - base[k]) for k in merged
            if merged[k] is not base[k]}


def apply_lora(module: nn.Module, delta: Mapping[str, torch.Tensor],
               scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """The adapted weights ``base + scale * delta`` (in fp32, cast back to
    each weight's type) for the keys in ``delta``, as a state dict for
    ``torch.func.functional_call(module, adapted, args)``. The module's own
    weights are not touched; call again with another ``scale`` to re-weight
    the adapter."""
    own = module.state_dict()
    out = {}
    for k, d in delta.items():
        if k not in own:
            raise KeyError(f"LoRA delta key {k!r} is not in the module's state dict")
        p = own[k]
        out[k] = (p.float() + scale * d.to(p.device, torch.float32)).to(p.dtype)
    return out
