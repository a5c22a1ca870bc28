"""KL autoencoder with the SVD temporal decoder — port of
``univst_tpu/models/vae.py``.

The SD runners pair the SD UNet with the stable-video-diffusion VAE
(src/sd/run_content_inversion_sd.py:41-42, diffusers
``AutoencoderKLTemporalDecoder``): a standard KL encoder and a decoder whose
resnets mix a frame-axis resnet in through a learned alpha blender. SD3
uses the plain ``AutoencoderKL`` (no frame mixing) with 16 latent channels.

Attribute names follow the diffusers keys. Public tensors keep the JAX
layout: pixels and latents ``[F, H, W, C]`` (frames as batch); inside, the
modules run NCHW.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from univst_torch.models.layers import GroupNorm


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    shift_factor: float = 0.0
    temporal_decoder: bool = False  # SVD-style decoder (frame mixing)

    @staticmethod
    def svd(**kw) -> "VAEConfig":
        """stabilityai/stable-video-diffusion-img2vid `vae` subfolder config."""
        return VAEConfig(temporal_decoder=True, **kw)

    @staticmethod
    def sd3(**kw) -> "VAEConfig":
        return VAEConfig(latent_channels=16, scaling_factor=1.5305, shift_factor=0.0609, **kw)

    @staticmethod
    def tiny(**kw) -> "VAEConfig":
        return VAEConfig(block_out_channels=(16, 32), layers_per_block=1, norm_num_groups=4, **kw)


def _to_5d(x, num_frames: int):
    """[B*F, C, H, W] -> [B, C, F, H, W]."""
    n, c, h, w = x.shape
    return x.reshape(n // num_frames, num_frames, c, h, w).transpose(1, 2)


def _from_5d(x):
    b, c, f, h, w = x.shape
    return x.transpose(1, 2).reshape(b * f, c, h, w)


def _time_conv(conv: nn.Conv3d, x, shard=None):
    """A (3,1,1) conv over ``[B, C, F, H, W]``; under a frame ``shard`` the
    +/-1 frame from the neighbour ranks (``comm.halo_1d``) replaces its zero
    padding on the frame axis."""
    if shard is None:
        return conv(x)
    from univst_torch.distributed.comm import halo_1d

    return F.conv3d(halo_1d(x, shard, dim=2, site="vae_halo"), conv.weight, conv.bias)


class VAEResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, groups: int):
        super().__init__()
        self.norm1 = GroupNorm(in_ch, groups, eps=1e-6)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = GroupNorm(out_ch, groups, eps=1e-6)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x):
        h = self.conv1(self.norm1(x, silu=True))
        h = self.conv2(self.norm2(h, silu=True))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class TemporalResnetBlock(nn.Module):
    """Frame-axis resnet with (3,1,1) convs (diffusers TemporalResnetBlock);
    per-frame GroupNorm, as in the JAX package."""

    def __init__(self, in_ch: int, out_ch: int, groups: int):
        super().__init__()
        self.norm1 = GroupNorm(in_ch, groups, eps=1e-6)
        self.conv1 = nn.Conv3d(in_ch, out_ch, (3, 1, 1), padding=(1, 0, 0))
        self.norm2 = GroupNorm(out_ch, groups, eps=1e-6)
        self.conv2 = nn.Conv3d(out_ch, out_ch, (3, 1, 1), padding=(1, 0, 0))
        self.conv_shortcut = nn.Conv3d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x, num_frames: int, shard=None):
        h = _from_5d(_time_conv(self.conv1, _to_5d(self.norm1(x, silu=True), num_frames), shard))
        h = _from_5d(_time_conv(self.conv2, _to_5d(self.norm2(h, silu=True), num_frames), shard))
        if self.conv_shortcut is not None:
            x = _from_5d(self.conv_shortcut(_to_5d(x, num_frames)))
        return x + h


class AlphaBlender(nn.Module):
    """Learned spatial/temporal mix (diffusers AlphaBlender, 'learned')."""

    def __init__(self):
        super().__init__()
        self.mix_factor = nn.Parameter(torch.tensor(0.5))

    def forward(self, x_spatial, x_temporal):
        alpha = torch.sigmoid(self.mix_factor.float()).to(x_spatial.dtype)
        return alpha * x_spatial + (1.0 - alpha) * x_temporal


class SpatioTemporalResBlock(nn.Module):
    """Spatial resnet + temporal resnet + alpha blend, applied at every frame
    count (a zero-padded temporal conv over one frame is not the identity)."""

    def __init__(self, in_ch: int, out_ch: int, groups: int):
        super().__init__()
        self.spatial_res_block = VAEResnetBlock(in_ch, out_ch, groups)
        self.temporal_res_block = TemporalResnetBlock(out_ch, out_ch, groups)
        self.time_mixer = AlphaBlender()

    def forward(self, x, num_frames: int, shard=None):
        h = self.spatial_res_block(x)
        return self.time_mixer(h, self.temporal_res_block(h, num_frames, shard))


class VAEAttention(nn.Module):
    """Single-head self-attention at the bottleneck (diffusers Attention)."""

    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(ch, groups, eps=1e-6)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch)])

    def forward(self, x):
        n, c, hh, ww = x.shape
        tokens = self.group_norm(x).flatten(2).transpose(1, 2)
        out = F.scaled_dot_product_attention(
            self.to_q(tokens)[:, None], self.to_k(tokens)[:, None], self.to_v(tokens)[:, None])
        out = self.to_out[0](out[:, 0])
        return x + out.transpose(1, 2).reshape(n, c, hh, ww)


class _Conv(nn.Module):
    """Holds the diffusers ``{down,up}samplers.0.conv`` key."""

    def __init__(self, ch: int, stride: int, padding: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=stride, padding=padding)


class _Block(nn.Module):
    def __init__(self, resnets, sampler: Optional[nn.Module], up: bool):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if sampler is not None:
            setattr(self, "upsamplers" if up else "downsamplers", nn.ModuleList([sampler]))


class _Mid(nn.Module):
    def __init__(self, resnets, attn):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList([attn])


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        g, boc = cfg.norm_num_groups, cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.in_channels, boc[0], 3, padding=1)
        blocks, prev = [], boc[0]
        for i, ch in enumerate(boc):
            res = [VAEResnetBlock(prev if j == 0 else ch, ch, g)
                   for j in range(cfg.layers_per_block)]
            # torch pads (0,1,0,1) before the stride-2 conv (diffusers Downsample2D)
            blocks.append(_Block(res, _Conv(ch, 2, 0) if i < len(boc) - 1 else None, up=False))
            prev = ch
        self.down_blocks = nn.ModuleList(blocks)
        ch = boc[-1]
        self.mid_block = _Mid([VAEResnetBlock(ch, ch, g), VAEResnetBlock(ch, ch, g)],
                              VAEAttention(ch, g))
        self.conv_norm_out = GroupNorm(ch, g, eps=1e-6)
        self.conv_out = nn.Conv2d(ch, 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for blk in self.down_blocks:
            for res in blk.resnets:
                x = res(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0].conv(F.pad(x, (0, 1, 0, 1)))
        x = self.mid_block.resnets[0](x)
        x = self.mid_block.attentions[0](x)
        x = self.mid_block.resnets[1](x)
        return self.conv_out(self.conv_norm_out(x, silu=True))


class Decoder(nn.Module):
    """KL decoder; with ``temporal_decoder`` every resnet is a
    SpatioTemporalResBlock and a (3,1,1) time conv ends the stack
    (diffusers TemporalDecoder)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        g = cfg.norm_num_groups
        self.temporal = cfg.temporal_decoder

        def res(cin, cout):
            return (SpatioTemporalResBlock if self.temporal else VAEResnetBlock)(cin, cout, g)

        rev = list(reversed(cfg.block_out_channels))
        ch = rev[0]
        self.conv_in = nn.Conv2d(cfg.latent_channels, ch, 3, padding=1)
        self.mid_block = _Mid([res(ch, ch), res(ch, ch)], VAEAttention(ch, g))
        blocks, prev = [], ch
        for i, ch in enumerate(rev):
            rs = [res(prev if j == 0 else ch, ch) for j in range(cfg.layers_per_block + 1)]
            blocks.append(_Block(rs, _Conv(ch, 1, 1) if i < len(rev) - 1 else None, up=True))
            prev = ch
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = GroupNorm(rev[-1], g, eps=1e-6)
        self.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1)
        if self.temporal:
            self.time_conv_out = nn.Conv3d(cfg.out_channels, cfg.out_channels, (3, 1, 1),
                                           padding=(1, 0, 0))

    def _res(self, blk, x, num_frames, shard):
        return blk(x, num_frames, shard) if self.temporal else blk(x)

    def forward(self, z, num_frames: int = 1, shard=None):
        """``shard`` (a ``comm.FrameShard``): ``z`` holds this rank's
        ``num_frames`` frames; the temporal convs read the neighbours'."""
        x = self.conv_in(z)
        x = self._res(self.mid_block.resnets[0], x, num_frames, shard)
        x = self.mid_block.attentions[0](x)
        x = self._res(self.mid_block.resnets[1], x, num_frames, shard)
        for blk in self.up_blocks:
            for r in blk.resnets:
                x = self._res(r, x, num_frames, shard)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0].conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))
        x = self.conv_out(self.conv_norm_out(x, silu=True))
        if self.temporal:
            x = _from_5d(_time_conv(self.time_conv_out, _to_5d(x, num_frames), shard))
        return x


class AutoencoderKL(nn.Module):
    """``encode`` -> (mean, logvar); ``decode(z)`` -> pixels, both on
    ``[F, H, W, C]``. The caller applies the scaling factor, as the
    reference does."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)
        if not cfg.temporal_decoder:
            self.post_quant_conv = nn.Conv2d(cfg.latent_channels, cfg.latent_channels, 1)

    @property
    def dtype(self):
        return self.quant_conv.weight.dtype

    def encode(self, x):
        moments = self.quant_conv(self.encoder(x.to(self.dtype).permute(0, 3, 1, 2)))
        mean, logvar = moments.permute(0, 2, 3, 1).chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def decode(self, z, num_frames: int = 1, shard=None):
        z = z.to(self.dtype).permute(0, 3, 1, 2)
        if not self.cfg.temporal_decoder:
            z = self.post_quant_conv(z)
        return self.decoder(z, num_frames, shard).permute(0, 2, 3, 1)


def sample_latent(mean, logvar, generator: Optional[torch.Generator] = None, noise=None):
    """Reparameterized sample from the posterior (DiagonalGaussian.sample).
    ``noise`` (standard normal, the shape of ``mean``) overrides the draw
    from ``generator``."""
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                            dtype=torch.float32)
    return mean + torch.exp(0.5 * logvar) * noise.to(mean.device, mean.dtype)
