"""SD3 / SD3.5 MMDiT with video (cross-frame) attention — port of
``univst_tpu/models/mmdit.py``.

Rebuild of the model the reference drives through diffusers
(CustomSD3Transformer2DModel, backbones/video_diffusion_sd3/models/
transformer_3D_model.py:12-113) plus its video attention processors
(backbones/video_diffusion_sd3/pnp_utils.py:9-271):

  * patchify (p=2) + fixed 2D sin-cos positional embedding, center-cropped
    from a ``pos_embed_max_size`` grid;
  * joint transformer blocks: AdaLayerNormZero on both streams, joint
    attention over [image tokens | context tokens], gated residuals,
    gelu-tanh MLPs; the last block is context_pre_only;
  * video lives in the attention: the image-token K/V of the frames
    ``frame_indices`` selects are attended after the q/k norms, and the
    AdaIN style shift applies per head before that, both explicit arguments
    (:class:`~univst_torch.models.layers.VideoCtx` / ``StyleCtx``);
  * feature capture: hidden tokens after block ``capture_block`` reshaped to
    ``[F, h/p, w/p, D]`` (transformer_3D_model.py:76-83).

Module attribute names follow diffusers' ``SD3Transformer2DModel`` keys, so
one strict ``load_state_dict`` serves the tests and real checkpoints.
Tensors keep the JAX layout: latents ``[B*F, h, w, C]`` (frames as batch),
tokens ``[B*F, L, D]``, attention heads token-major ``[B*F, L, H, dh]``.
Capture and injection of the style branch's K/V replace Flax's
``sow("pnp_kv")``: a capture-mode forward records each block's ``(k, v)``
in ``StyleCtx.captured`` (:func:`extract_mmdit_style_kv` orders them), and
an injected forward takes them in ``StyleCtx.style_kv``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from univst_torch.attention.ops import (
    apply_style_shift_sd3,
    apply_style_shift_sd3_injected,
    joint_video_attention_tokens,
)
from univst_torch.models.layers import StyleCtx, TimestepEmbedMLP, VideoCtx, timestep_embedding


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    patch_size: int = 2
    in_channels: int = 16
    out_channels: int = 16
    num_layers: int = 24
    num_heads: int = 24
    head_dim: int = 64
    joint_attention_dim: int = 4096  # context input width (T5 / padded CLIP)
    pooled_projection_dim: int = 2048
    pos_embed_max_size: int = 192
    qk_norm: Optional[str] = None  # None (SD3.0) | 'rms' (SD3.5)
    # blocks with an extra image-stream self-attention (SD3.5-medium)
    dual_attention_layers: Tuple[int, ...] = ()
    capture_block: Optional[int] = None

    @property
    def hidden(self) -> int:
        return self.num_heads * self.head_dim

    @staticmethod
    def sd3_medium(**kw) -> "MMDiTConfig":
        return MMDiTConfig(**kw)

    @staticmethod
    def sd35_large(**kw) -> "MMDiTConfig":
        return MMDiTConfig(num_layers=38, num_heads=38, qk_norm="rms", **kw)

    @staticmethod
    def sd35_medium(**kw) -> "MMDiTConfig":
        # the reference CLIs' default checkpoint (stabilityai/stable-diffusion-
        # 3.5-medium, src/sd3/run_content_inversion_sd3.py:103): 24 layers,
        # qk RMS norm, dual attention in blocks 0..12
        return MMDiTConfig(qk_norm="rms", dual_attention_layers=tuple(range(13)), **kw)

    @staticmethod
    def tiny(**kw) -> "MMDiTConfig":
        base = dict(num_layers=2, num_heads=2, head_dim=16, joint_attention_dim=64,
                    pooled_projection_dim=32, pos_embed_max_size=16)
        base.update(kw)
        return MMDiTConfig(**base)


def extract_mmdit_style_kv(captured: Dict[str, Tuple[torch.Tensor, torch.Tensor]]) -> dict:
    """The ``(k, v)`` a capture-mode forward recorded, as ``{"joint": tuple
    over blocks, "dual": tuple over dual-attention blocks}`` — the
    ``StyleCtx.style_kv`` layout the injected SD3 shift consumes."""
    joint = {int(k[5:]): v for k, v in captured.items() if k.startswith("slot_")}
    dual = {int(k[5:]): v for k, v in captured.items() if k.startswith("dual_")}
    return {"joint": tuple(joint[i] for i in range(len(joint))),
            "dual": tuple(dual[i] for i in range(len(dual)))}


def sincos_pos_embed_2d(dim: int, grid_h: int, grid_w: int) -> np.ndarray:
    """Fixed 2D sin-cos positional embedding (diffusers get_2d_sincos_pos_embed).

    Channel-half order: diffusers names its first half "emb_h" but feeds it
    the W coordinate (meshgrid(grid_w, grid_h)[0]), so pretrained SD3
    weights expect ``[w-embedding | h-embedding]``; that order is kept.
    """
    def one_axis(d, pos):
        omega = 1.0 / 10000 ** (np.arange(d // 2, dtype=np.float64) / (d / 2.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid = np.meshgrid(np.arange(grid_w, dtype=np.float64), np.arange(grid_h, dtype=np.float64))
    emb_w = one_axis(dim // 2, grid[0])
    emb_h = one_axis(dim // 2, grid[1])
    return np.concatenate([emb_w, emb_h], axis=1).astype(np.float32)


class RMSNorm(nn.Module):
    """RMS norm over the last axis (the per-head q/k norms of SD3.5),
    computed in fp32."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        xf = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + self.eps)
        return (xf * self.weight.float()).to(x.dtype)


class AdaLNZero(nn.Module):
    """silu(temb) -> Linear -> ``n_chunks`` modulation vectors ``[B, 1, D]``
    (diffusers' zero init is replaced by the random init: real checkpoints
    overwrite it, and random-weight runs stay structurally live)."""

    def __init__(self, dim: int, n_chunks: int):
        super().__init__()
        self.n_chunks = n_chunks
        self.linear = nn.Linear(dim, n_chunks * dim)

    def forward(self, temb):
        return self.linear(F.silu(temb))[:, None, :].chunk(self.n_chunks, dim=-1)


def _ln(x):
    """LayerNorm without affine params, eps 1e-6 (diffusers block norms), fp32."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=1e-6).to(x.dtype)


class GELUProj(nn.Module):
    """diffusers ``GELU(approximate='tanh')``: a projection and the tanh gelu."""

    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner)

    def forward(self, x):
        return F.gelu(self.proj(x), approximate="tanh")


class GeluMLP(nn.Module):
    """diffusers FeedForward (gelu-approximate); ``net`` keeps its indices
    (0: GELU, 1: dropout, 2: out)."""

    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GELUProj(dim, dim * 4), nn.Identity(), nn.Linear(dim * 4, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


def _video_indices(video_ctx: VideoCtx):
    video = video_ctx.is_video or video_ctx.shard is not None
    return tuple(video_ctx.frame_indices) if video and video_ctx.frame_indices else ()


def _style(q, k, v, style_ctx: Optional[StyleCtx], kind: str, slot: int, num_frames: int):
    """The style modes of one attention: capture (record k, v), injected
    shift, or 3-branch shift; returns the q, k, v to attend."""
    if style_ctx is None:
        return q, k, v
    if style_ctx.capture:
        style_ctx.captured[f"{'slot' if kind == 'joint' else 'dual'}_{slot}"] = (k, v)
        return q, k, v
    if style_ctx.style_kv is not None:
        sk, sv = style_ctx.style_kv[kind][slot]
        return apply_style_shift_sd3_injected(q, k, v, sk, sv, style_ctx.step_idx, style_ctx.cfg,
                                              num_frames, token_major=True)
    if style_ctx.cfg is not None:
        return apply_style_shift_sd3(q, k, v, style_ctx.step_idx, style_ctx.cfg, num_frames,
                                     token_major=True)
    return q, k, v


class JointAttention(nn.Module):
    """Joint attention over image + context tokens with video semantics.
    ``num_heads`` is the heads this module computes: all of them, or a
    tensor rank's share once ``distributed.tp.shard_mmdit`` split its
    projections. Under a frame shard (``video_ctx.shard``) the image K/V
    of the source frames on other ranks arrive through the halo
    exchange of ``joint_video_attention_tokens``."""

    def __init__(self, cfg: MMDiTConfig, context_pre_only: bool, slot: int):
        super().__init__()
        d = cfg.hidden
        self.cfg, self.context_pre_only, self.slot = cfg, context_pre_only, slot
        self.num_heads = cfg.num_heads
        for name in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj"):
            setattr(self, name, nn.Linear(d, d))
        self.to_out = nn.ModuleList([nn.Linear(d, d)])
        if not context_pre_only:
            self.to_add_out = nn.Linear(d, d)
        if cfg.qk_norm == "rms":
            for name in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
                setattr(self, name, RMSNorm(cfg.head_dim))

    def forward(self, x, ctx, video_ctx: VideoCtx, style_ctx: Optional[StyleCtx]):
        c = self.cfg
        bf, n, _ = x.shape
        d = self.num_heads * c.head_dim

        # token-major per-head layout [bf, L, H, dh]: a free view of the
        # projection output; the video kernel takes it without a transpose
        def split(y):
            return y.reshape(bf, -1, self.num_heads, c.head_dim)

        q, k, v = split(self.to_q(x)), split(self.to_k(x)), split(self.to_v(x))
        if c.qk_norm == "rms":
            q, k = self.norm_q(q), self.norm_k(k)
        # AdaIN shift on the image-token q/k/v (sd3 pnp_utils.py:181-194)
        q, k, v = _style(q, k, v, style_ctx, "joint", self.slot, video_ctx.num_frames)
        cq, ck, cv = split(self.add_q_proj(ctx)), split(self.add_k_proj(ctx)), split(self.add_v_proj(ctx))
        if c.qk_norm == "rms":
            cq, ck = self.norm_added_q(cq), self.norm_added_k(ck)
        # joint attention over [img*slots | ctx] (sd3 pnp_utils.py:53-84)
        idx = _video_indices(video_ctx)
        out = joint_video_attention_tokens(q, k, v, video_ctx.num_frames if idx else 1, idx,
                                           cq=cq, ck=ck, cv=cv, shard=video_ctx.shard)
        out = out.reshape(bf, -1, d)
        x_out = self.to_out[0](out[:, :n])
        if self.context_pre_only:
            return x_out, None
        return x_out, self.to_add_out(out[:, n:])


class DualSelfAttention(nn.Module):
    """The extra image-stream self-attention of SD3.5-medium dual blocks
    (diffusers attn2 with use_dual_attention). The reference's video
    processors sit on every attention (sd3 pnp_utils.py:276-286), so the
    cross-frame K/V and the style shift apply here too."""

    def __init__(self, cfg: MMDiTConfig, slot: int):
        super().__init__()
        d = cfg.hidden
        self.cfg, self.slot = cfg, slot
        self.num_heads = cfg.num_heads  # as JointAttention's
        for name in ("to_q", "to_k", "to_v"):
            setattr(self, name, nn.Linear(d, d))
        self.to_out = nn.ModuleList([nn.Linear(d, d)])
        if cfg.qk_norm == "rms":
            self.norm_q, self.norm_k = RMSNorm(cfg.head_dim), RMSNorm(cfg.head_dim)

    def forward(self, x, video_ctx: VideoCtx, style_ctx: Optional[StyleCtx]):
        c = self.cfg
        bf = x.shape[0]

        def split(y):
            return y.reshape(bf, -1, self.num_heads, c.head_dim)

        q, k, v = split(self.to_q(x)), split(self.to_k(x)), split(self.to_v(x))
        if c.qk_norm == "rms":
            q, k = self.norm_q(q), self.norm_k(k)
        q, k, v = _style(q, k, v, style_ctx, "dual", self.slot, video_ctx.num_frames)
        idx = _video_indices(video_ctx)
        out = joint_video_attention_tokens(q, k, v, video_ctx.num_frames if idx else 1, idx,
                                           shard=video_ctx.shard)
        return self.to_out[0](out.reshape(bf, -1, self.num_heads * c.head_dim))


class JointBlock(nn.Module):
    def __init__(self, cfg: MMDiTConfig, context_pre_only: bool, slot: int,
                 dual_slot: Optional[int] = None):
        super().__init__()
        d = cfg.hidden
        self.context_pre_only = context_pre_only
        self.dual_attention = dual_slot is not None
        # SD35AdaLayerNormZeroX carries 9 modulation chunks
        self.norm1 = AdaLNZero(d, 9 if self.dual_attention else 6)
        # AdaLayerNormContinuous (2 chunks) on the context of the last block
        self.norm1_context = AdaLNZero(d, 2 if context_pre_only else 6)
        self.attn = JointAttention(cfg, context_pre_only, slot)
        if self.dual_attention:
            self.attn2 = DualSelfAttention(cfg, dual_slot)
        self.ff = GeluMLP(d)
        if not context_pre_only:
            self.ff_context = GeluMLP(d)

    def forward(self, x, ctx, temb, video_ctx, style_ctx):
        if self.dual_attention:
            sm, scm, gm, smlp, sclp, gmlp, sm2, scm2, gm2 = self.norm1(temb)
        else:
            sm, scm, gm, smlp, sclp, gmlp = self.norm1(temb)
        x_ln = _ln(x)
        xh = x_ln * (1 + scm) + sm
        if self.context_pre_only:
            css, cs = self.norm1_context(temb)  # (scale, shift) order
        else:
            cs, css, cgm, csmlp, csclp, cglp = self.norm1_context(temb)
        ch = _ln(ctx) * (1 + css) + cs
        attn_x, attn_c = self.attn(xh, ch, video_ctx, style_ctx)
        if self.dual_attention:
            # both attentions read the pre-block hidden state, each with its
            # own modulation (diffusers SD35AdaLayerNormZeroX)
            attn_x2 = self.attn2(x_ln * (1 + scm2) + sm2, video_ctx, style_ctx)
        x = x + gm * attn_x
        if self.dual_attention:
            x = x + gm2 * attn_x2
        x = x + gmlp * self.ff(_ln(x) * (1 + sclp) + smlp)
        if self.context_pre_only:
            return x, None
        ctx = ctx + cgm * attn_c
        ctx = ctx + cglp * self.ff_context(_ln(ctx) * (1 + csclp) + csmlp)
        return x, ctx


class PatchEmbed(nn.Module):
    """Patchify conv + the center-cropped fixed sin-cos table. ``pos_embed``
    is persisted, as diffusers does, but the table is the formula's: a
    loaded value is replaced by it (the JAX package's converter discards
    the checkpoint's buffer the same way)."""

    def __init__(self, cfg: MMDiTConfig):
        super().__init__()
        self.max_size = cfg.pos_embed_max_size
        self.proj = nn.Conv2d(cfg.in_channels, cfg.hidden, cfg.patch_size, stride=cfg.patch_size)
        table = sincos_pos_embed_2d(cfg.hidden, self.max_size, self.max_size)
        self.register_buffer("pos_embed",
                             torch.as_tensor(table, device=self.proj.weight.device)[None])

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        key = prefix + "pos_embed"
        if key in state_dict:
            if tuple(state_dict[key].shape) != tuple(self.pos_embed.shape):
                raise ValueError(f"{key}: shape {tuple(state_dict[key].shape)}, "
                                 f"want {tuple(self.pos_embed.shape)}")
            state_dict[key] = self.pos_embed
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x):
        """``[B*F, h, w, C]`` -> tokens ``[B*F, gh*gw, D]`` + position."""
        tokens = self.proj(x.permute(0, 3, 1, 2))
        gh, gw = tokens.shape[2:]
        tokens = tokens.flatten(2).transpose(1, 2)
        top, left = (self.max_size - gh) // 2, (self.max_size - gw) // 2
        pos = self.pos_embed.reshape(self.max_size, self.max_size, -1)[top:top + gh, left:left + gw]
        return tokens + pos.reshape(1, gh * gw, -1).to(tokens.dtype)


class _TimeTextEmbed(nn.Module):
    def __init__(self, cfg: MMDiTConfig):
        super().__init__()
        self.timestep_embedder = TimestepEmbedMLP(256, cfg.hidden)
        self.text_embedder = TimestepEmbedMLP(cfg.pooled_projection_dim, cfg.hidden)


class _NormOut(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.linear = nn.Linear(dim, 2 * dim)


class MMDiT(nn.Module):
    """forward(x, timestep, context, pooled, video_ctx, style_ctx=None):
      x ``[B*F, h, w, C]`` latents; timestep a scalar or ``[B*F]``;
      context ``[B, L, joint_attention_dim]``; pooled ``[B, pooled_dim]``.
    Returns (velocity ``[B*F, h, w, C]``, captured feature or None)."""

    def __init__(self, cfg: MMDiTConfig):
        super().__init__()
        d = cfg.hidden
        self.cfg = cfg
        self.pos_embed = PatchEmbed(cfg)
        self.time_text_embed = _TimeTextEmbed(cfg)
        self.context_embedder = nn.Linear(cfg.joint_attention_dim, d)
        duals = sorted(cfg.dual_attention_layers)
        self.transformer_blocks = nn.ModuleList([
            JointBlock(cfg, i == cfg.num_layers - 1, slot=i,
                       dual_slot=duals.index(i) if i in duals else None)
            for i in range(cfg.num_layers)])
        self.norm_out = _NormOut(d)
        self.proj_out = nn.Linear(d, cfg.patch_size**2 * cfg.out_channels)

    @property
    def dtype(self):
        return self.proj_out.weight.dtype

    def forward(self, x, timestep, context, pooled, video_ctx: VideoCtx,
                style_ctx: Optional[StyleCtx] = None):
        c = self.cfg
        dt = self.dtype
        p = c.patch_size
        bf, hh, ww, _ = x.shape
        gh, gw = hh // p, ww // p
        tokens = self.pos_embed(x.to(dt))

        t = torch.as_tensor(timestep, device=x.device).float().reshape(-1).expand(bf)
        tte = self.time_text_embed
        temb = tte.timestep_embedder(timestep_embedding(t, 256).to(dt))
        f = video_ctx.num_frames
        pooled_r = pooled if pooled.shape[0] == bf else pooled.repeat_interleave(f, dim=0)
        temb = temb + tte.text_embedder(pooled_r.to(dt))
        ctx = self.context_embedder(
            (context if context.shape[0] == bf else context.repeat_interleave(f, dim=0)).to(dt))

        captured = None
        for i, block in enumerate(self.transformer_blocks):
            tokens, ctx = block(tokens, ctx, temb, video_ctx, style_ctx)
            if i == c.capture_block:
                # reference saves hidden.view(B, h/2, w/2, -1)
                # (transformer_3D_model.py:82); frames are the batch here
                captured = tokens.reshape(bf, gh, gw, -1)

        # AdaLayerNormContinuous output head, (scale, shift) order
        scale, shift = self.norm_out.linear(F.silu(temb))[:, None, :].chunk(2, dim=-1)
        out = self.proj_out(_ln(tokens) * (1 + scale) + shift)
        out = out.reshape(bf, gh, gw, p, p, c.out_channels).permute(0, 1, 3, 2, 4, 5)
        return out.reshape(bf, gh * p, gw * p, c.out_channels), captured
