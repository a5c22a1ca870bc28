"""A stylization job: one clip, with content and style trajectories from an
inversion already made (``steps + 1`` latents a frame, index i the latent
step i starts from; the style in its single-frame form), the initial
latents and a ``uniform > 0.5`` mask at pixel size — the inputs
``univst_torch/bench.py::synthetic_inputs`` draws, copied here."""

import torch


def input_set(traffic: dict, latent_channels: int, gen, device) -> dict:
    f, n, size = traffic["frames"], traffic["steps"], traffic["size"]
    h = size // traffic["latent_downsample"]

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)

    content = normal(n + 1, f, h, h, latent_channels)
    style = normal(n + 1, 1, h, h, latent_channels)
    init = normal(f, h, h, latent_channels)
    mask = (torch.rand((f, size, size), generator=gen, device=device) > 0.5).float()
    return dict(content=content, style=style, init=init, mask=mask)
