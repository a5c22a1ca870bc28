"""RAFT-large optical flow (port of ``univst_tpu/models/raft.py``; the
reference smoother uses torchvision's RAFT, src/cal_optica_flow.py:4,51-54).

The princeton-vl architecture, NCHW, under princeton-vl's key names
(``fnet.* / cnet.* / update_block.*``): feature and context encoders
(residual CNNs at 1/8 resolution; instance norm in ``fnet``, batch norm in
``cnet``, which stays a real ``BatchNorm2d`` in eval mode so checkpoint
running statistics load as they are), an all-pairs 4-level correlation
pyramid with radius-4 bilinear lookups, and a recurrent SepConvGRU update
block with convex 8x upsampling. ``models.convert.load_raft`` loads the
princeton-vl and the torchvision ``Raft_Large_Weights`` layouts.

Two layouts follow princeton-vl / torchvision exactly, because the learned
weights depend on them:
  * the correlation window's (2r+1)^2 channels enumerate the x offset
    slowest (their CorrBlock adds the slow axis of an 'ij' meshgrid to x);
  * ``mask_conv2``'s 576 output channels are read as ``(9, 8, 8)``:
    neighbor first, then the row and column inside the 8x8 cell
    (torchvision ``upsample_flow``: ``view(b, 1, 9, 8, 8, h, w)``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class RAFTConfig:
    hidden_dim: int = 128
    context_dim: int = 128
    corr_levels: int = 4
    corr_radius: int = 4
    iters: int = 12
    encoder_dims: Tuple[int, ...] = (64, 64, 96, 128)  # stem + 3 stages
    encoder_out: int = 256

    @staticmethod
    def tiny(**kw) -> "RAFTConfig":
        return RAFTConfig(hidden_dim=16, context_dim=16, corr_levels=2, corr_radius=2,
                          iters=2, encoder_dims=(8, 8, 12, 16), encoder_out=32, **kw)


def _norm(kind: str, ch: int) -> nn.Module:
    # InstanceNorm2d has no parameters and no running statistics (affine and
    # track_running_stats off, as in RAFT's encoders)
    return nn.InstanceNorm2d(ch) if kind == "instance" else nn.BatchNorm2d(ch)


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1, norm: str = "instance"):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride=stride, padding=1)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.norm1, self.norm2 = _norm(norm, cout), _norm(norm, cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride=stride),
                                            _norm(norm, cout))

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """fnet / cnet: 7x7 stride-2 stem, three residual stages (strides 1, 2,
    2), 1x1 output conv."""

    def __init__(self, cfg: RAFTConfig, out_ch: int, norm: str = "instance"):
        super().__init__()
        d = cfg.encoder_dims
        self.conv1 = nn.Conv2d(3, d[0], 7, stride=2, padding=3)
        self.norm1 = _norm(norm, d[0])
        cin = d[0]
        for si, (ch, stride) in enumerate(((d[1], 1), (d[2], 2), (d[3], 2))):
            setattr(self, f"layer{si + 1}", nn.Sequential(ResidualBlock(cin, ch, stride, norm),
                                                          ResidualBlock(ch, ch, 1, norm)))
            cin = ch
        self.conv2 = nn.Conv2d(d[3], out_ch, 1)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)


def _corr_pyramid(fmap1, fmap2, levels: int):
    """All-pairs correlation and its 2x2 average-pooling pyramid.
    fmap ``[B, D, h, w]`` -> list of ``[B*h*w, 1, h_l, w_l]`` volumes."""
    b, d, h, w = fmap1.shape
    corr = torch.matmul(fmap1.reshape(b, d, h * w).transpose(1, 2).float(),
                        fmap2.reshape(b, d, h * w).float()) / float(d) ** 0.5
    pyramid = [corr.reshape(b * h * w, 1, h, w)]
    for _ in range(levels - 1):
        pyramid.append(F.avg_pool2d(pyramid[-1], 2, stride=2))
    return pyramid


def _corr_lookup(pyramid, coords, radius: int):
    """Bilinear (2r+1)^2 window lookup at every level, as princeton-vl's
    CorrBlock does it: ``grid_sample`` of each ``[B*h*w, 1, h_l, w_l]``
    volume at pixel positions, out-of-range corners reading 0. coords
    ``[B, 2, h, w]`` (x, y) at 1/8 resolution -> ``[B, L*(2r+1)^2, h, w]``,
    the x offset the slow axis of each window. The positions are normalized
    for ``align_corners=False`` (pixel x at (2x + 1) / w - 1), which samples
    the same points as princeton's ``align_corners=True`` and keeps the call
    off cuDNN's sampler, which refuses batches of B*h*w volumes at 512 px."""
    b, _, h, w = coords.shape
    side = 2 * radius + 1
    d = torch.linspace(-radius, radius, side, device=coords.device)
    delta = torch.stack(torch.meshgrid(d, d, indexing="ij"), dim=-1)  # [..., 0] goes to x
    centroid = coords.permute(0, 2, 3, 1).reshape(b * h * w, 1, 1, 2)
    out = []
    for lvl, vol in enumerate(pyramid):
        hl, wl = vol.shape[-2:]
        pos = centroid / 2.0**lvl + delta[None]
        grid = torch.stack([(2.0 * pos[..., 0] + 1.0) / wl - 1.0,
                            (2.0 * pos[..., 1] + 1.0) / hl - 1.0], dim=-1)
        out.append(F.grid_sample(vol, grid, mode="bilinear", padding_mode="zeros",
                                 align_corners=False).reshape(b, h, w, side * side))
    return torch.cat(out, dim=-1).permute(0, 3, 1, 2)


class SepConvGRU(nn.Module):
    def __init__(self, hidden: int, cin: int):
        super().__init__()
        for a, k, p in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for gate in ("z", "r", "q"):
                setattr(self, f"conv{gate}{a}", nn.Conv2d(hidden + cin, hidden, k, padding=p))

    def forward(self, h, x):
        for a in ("1", "2"):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, f"convz{a}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{a}")(hx))
            q = torch.tanh(getattr(self, f"convq{a}")(torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class MotionEncoder(nn.Module):
    def __init__(self, corr_ch: int):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_ch, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(192 + 64, 128 - 2, 3, padding=1)

    def forward(self, flow, corr):
        co = F.relu(self.convc2(F.relu(self.convc1(corr))))
        fl = F.relu(self.convf2(F.relu(self.convf1(flow))))
        return torch.cat([F.relu(self.conv(torch.cat([co, fl], dim=1))), flow], dim=1)


class FlowHead(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.conv1 = nn.Conv2d(hidden, 256, 3, padding=1)
        self.conv2 = nn.Conv2d(256, 2, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class UpdateBlock(nn.Module):
    def __init__(self, cfg: RAFTConfig):
        super().__init__()
        self.encoder = MotionEncoder(cfg.corr_levels * (2 * cfg.corr_radius + 1) ** 2)
        self.gru = SepConvGRU(cfg.hidden_dim, cfg.context_dim + 128)
        self.flow_head = FlowHead(cfg.hidden_dim)
        self.mask = nn.Sequential(nn.Conv2d(cfg.hidden_dim, 256, 3, padding=1),
                                  nn.ReLU(inplace=True), nn.Conv2d(256, 64 * 9, 1))

    def forward(self, h, inp, corr, flow):
        x = torch.cat([inp, self.encoder(flow, corr)], dim=1)
        h = self.gru(h, x)
        # the upsampling mask is scaled by .25, as the reference does
        return h, self.flow_head(h), 0.25 * self.mask(h)


def _convex_upsample(flow, mask):
    """8x convex upsampling (torchvision ``upsample_flow``): each output
    pixel a softmax-weighted combination of its 3x3 coarse neighborhood.
    flow ``[B, 2, h, w]``, mask ``[B, 576, h, w]`` read as (9, 8, 8)."""
    b, _, h, w = flow.shape
    m = torch.softmax(mask.reshape(b, 1, 9, 8, 8, h, w), dim=2)
    neigh = F.unfold(8.0 * flow, kernel_size=3, padding=1).reshape(b, 2, 9, 1, 1, h, w)
    up = (m * neigh).sum(dim=2)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(b, 2, 8 * h, 8 * w)


class RAFT(nn.Module):
    """``forward(img1, img2)`` on ``[B, 3, H, W]`` in [0, 1] (H, W divisible
    by 8) -> the full-resolution flow ``[B, 2, H, W]`` (x, y)."""

    def __init__(self, cfg: RAFTConfig = RAFTConfig()):
        super().__init__()
        self.cfg = cfg
        self.fnet = BasicEncoder(cfg, cfg.encoder_out, "instance")
        self.cnet = BasicEncoder(cfg, cfg.hidden_dim + cfg.context_dim, "batch")
        self.update_block = UpdateBlock(cfg)

    def forward(self, img1, img2):
        c = self.cfg
        img1, img2 = 2.0 * img1 - 1.0, 2.0 * img2 - 1.0
        # instance norm is per sample: both images in one batch
        f1, f2 = self.fnet(torch.cat([img1, img2])).chunk(2)
        h, inp = self.cnet(img1).split([c.hidden_dim, c.context_dim], dim=1)
        h, inp = torch.tanh(h), F.relu(inp)
        pyramid = _corr_pyramid(f1, f2, c.corr_levels)
        b, _, hh, ww = f1.shape
        gy, gx = torch.meshgrid(torch.arange(hh, dtype=torch.float32, device=img1.device),
                                torch.arange(ww, dtype=torch.float32, device=img1.device),
                                indexing="ij")
        coords0 = torch.stack([gx, gy])[None].expand(b, -1, -1, -1)
        coords1 = coords0
        mask = None
        for _ in range(c.iters):
            corr = _corr_lookup(pyramid, coords1, c.corr_radius)
            h, delta, mask = self.update_block(h, inp, corr, coords1 - coords0)
            coords1 = coords1 + delta
        return _convex_upsample(coords1 - coords0, mask)


def make_raft_flow(model: RAFT):
    """``model`` (put in eval mode) as a ``flow_fn(img1, img2) -> flow`` of
    ``univst_torch.methods.flow``: ``[H, W, C]`` or ``[N, H, W, C]`` images
    in [0, 1] -> ``[H, W, 2]`` or ``[N, H, W, 2]``, computed in fp32 on the
    model's device."""
    model.eval()
    device = next(model.parameters()).device

    @torch.inference_mode()
    def flow_fn(img1, img2):
        single = img1.dim() == 3
        if single:
            img1, img2 = img1[None], img2[None]

        def nchw(x):
            return x.to(device=device, dtype=torch.float32).permute(0, 3, 1, 2)

        flow = model(nchw(img1), nchw(img2)).float().permute(0, 2, 3, 1).to(img1.device)
        return flow[0] if single else flow

    return flow_fn
