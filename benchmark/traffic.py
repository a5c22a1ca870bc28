"""The one generator of the benchmark's traffic: it reads a traffic file's
parameters and draws the input sets of a run on the device.

The traffic file's ``"kind"`` names the module under ``benchmark/kinds/``
that draws one job's inputs from those parameters; this module seeds it. A
run draws ``pool`` distinct sets from its seed in set-up and cycles them, so
no job reuses the one before it.
"""

from __future__ import annotations

import importlib
from typing import List

import torch

from benchmark.weights import sub_seed


def input_set(traffic: dict, latent_channels: int, seed: int, index: int, device) -> dict:
    """Input set ``index`` of a run with ``seed``."""
    kind = importlib.import_module("benchmark.kinds." + traffic["kind"])
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "inputs", index))
    return kind.input_set(traffic, latent_channels, gen, device)


def pool(traffic: dict, latent_channels: int, seed: int, device) -> List[dict]:
    return [input_set(traffic, latent_channels, seed, i, device) for i in range(traffic["pool"])]
