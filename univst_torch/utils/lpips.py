"""LPIPS perceptual distance (Zhang et al. 2018), AlexNet trunk — port of
``univst_tpu/utils/lpips.py``.

As ``lpips.LPIPS(net='alex')`` computes it:
  * inputs in [-1, 1], normalized with the fixed shift / scale the original
    hardcodes (its ScalingLayer);
  * torchvision AlexNet ``features``; the activations are tapped after each
    of the five ReLUs (max pools after taps 0 and 1 feed the later taps);
  * per tap: unit-normalize over channels (eps 1e-10), squared difference,
    a learned non-negative 1x1 conv ("lin" head) to one channel, spatial
    mean; the distance is the sum over the five taps.

The module's keys are the two released files': ``features.{0,3,6,8,10}``
of torchvision's ``alexnet-owt-*.pth`` and ``lin{i}.model.1.weight`` of the
lpips release's ``alex.pth``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

# (out_ch, kernel, stride, pad) of the torchvision AlexNet features convs
_ALEX_CONVS = ((64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1))
_FEATURE_INDEX = (0, 3, 6, 8, 10)  # the convs' indices in AlexNet.features
_POOL_AFTER = (0, 1)  # max pool 3x3 / 2 after these taps (the final pool feeds nothing)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class _Lin(nn.Module):
    """An lpips "lin" head: ``model.1`` is the 1x1 conv (``model.0`` is a
    dropout in the original, the identity at inference)."""

    def __init__(self, ch: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(ch, 1, 1, bias=False))


class LPIPS(nn.Module):
    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for i, (cout, k, stride, pad) in enumerate(_ALEX_CONVS):
            layers += [nn.Conv2d(cin, cout, k, stride=stride, padding=pad), nn.ReLU()]
            if i in _POOL_AFTER:
                layers.append(nn.MaxPool2d(3, 2))
            cin = cout
        self.features = nn.Sequential(*layers)
        for i, (cout, *_) in enumerate(_ALEX_CONVS):
            setattr(self, f"lin{i}", _Lin(cout))
        self.register_buffer("shift", torch.tensor(_SHIFT).reshape(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).reshape(1, 3, 1, 1), persistent=False)

    def taps(self, x):
        """The five ReLU outputs of the trunk on normalized NCHW input."""
        out = []
        for layer in self.features:
            x = layer(x)
            if isinstance(layer, nn.ReLU):
                out.append(x)
        return out

    def forward(self, a, b):
        """``a``, ``b``: NHWC RGB in [-1, 1] -> the distances ``[N]``, fp32."""
        def prep(x):
            return (x.float().permute(0, 3, 1, 2) - self.shift) / self.scale

        def unit(x):
            return x / (torch.linalg.vector_norm(x, dim=1, keepdim=True) + 1e-10)

        dist = 0.0
        for i, (ta, tb) in enumerate(zip(self.taps(prep(a)), self.taps(prep(b)))):
            lin = getattr(self, f"lin{i}").model[1]
            dist = dist + lin((unit(ta) - unit(tb)) ** 2).mean(dim=(1, 2, 3))
        return dist


@torch.inference_mode()
def lpips_distance(model: LPIPS, a, b):
    """LPIPS distance per batch element: NHWC RGB in [-1, 1] (uint8 frames
    map with x / 127.5 - 1) -> ``[N]`` fp32."""
    return model(a, b)


def lpips_params_from_torch(alexnet_sd: Mapping, lin_sd: Mapping) -> LPIPS:
    """An :class:`LPIPS` loaded strictly from the two torch state dicts.

    ``alexnet_sd``: a torchvision AlexNet state dict; its ``features.*``
    entries must be exactly the five convs' weights and biases (the
    ``classifier.*`` head is not part of LPIPS and is ignored).
    ``lin_sd``: the lpips heads, in the release layout ``lin{i}.model.1.weight``
    or as ``lins.{i}.model.1.weight`` or ``{i}.weight``, each ``[1, C, 1, 1]``;
    every key must be one of these."""
    sd = {k: v for k, v in alexnet_sd.items() if k.startswith("features.")}
    for k, v in lin_sd.items():
        for i in range(len(_ALEX_CONVS)):
            if k in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight", f"{i}.weight"):
                sd[f"lin{i}.model.1.weight"] = v
                break
        else:
            raise KeyError(f"lin state dict key {k!r} is no lin head")
    model = LPIPS()
    model.load_state_dict({k: torch.as_tensor(v).float() for k, v in sd.items()}, strict=True)
    return model.eval()


def load_lpips_params(alexnet_path: str, lin_path: str) -> LPIPS:
    """:func:`lpips_params_from_torch` on the two checkpoint files."""
    alex = torch.load(alexnet_path, map_location="cpu", weights_only=True)
    lin = torch.load(lin_path, map_location="cpu", weights_only=True)
    return lpips_params_from_torch(alex, lin)


def random_lpips_params(seed: int = 0) -> LPIPS:
    """Random weights for offline tests: the same numpy draws, in the same
    order, as the JAX package's ``random_lpips_params(seed)``."""
    rng = np.random.default_rng(seed)
    alex, lin = {}, {}
    cin = 3
    for i, (cout, k, _, _) in enumerate(_ALEX_CONVS):
        w = rng.normal(0, 0.05, (k, k, cin, cout)).astype(np.float32)  # HWIO
        alex[f"features.{_FEATURE_INDEX[i]}.weight"] = w.transpose(3, 2, 0, 1)
        alex[f"features.{_FEATURE_INDEX[i]}.bias"] = rng.normal(0, 0.01, (cout,)).astype(np.float32)
        cin = cout
        head = np.abs(rng.normal(0, 0.1, (cout, 1))).astype(np.float32)
        lin[f"lin{i}.model.1.weight"] = head.T[:, :, None, None]
    return lpips_params_from_torch(alex, {k: np.ascontiguousarray(v) for k, v in lin.items()})
