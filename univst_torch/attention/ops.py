"""Functional attention building blocks (PyTorch port of the SD half of
``univst_tpu/attention/ops.py``).

The reference implements its method by patching ``attn1.forward`` on selected
decoder blocks (video_diffusion_sd/pnp_utils.py:104-111). Here the same math
is a set of plain functions over (q, k, v) that take the step index and a
:class:`~univst_torch.core.config.StyleShiftConfig`.

Layouts (as in the JAX package):
  * pre-head tensors: ``[B, L, D]`` with ``B = branches * frames``
  * per-head tensors: ``[B, heads, N, Dh]``
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from univst_torch.core.adain import attention_adain
from univst_torch.core.config import FrameIndex, StyleShiftConfig


def resolve_frame_indices(
    indices: Sequence[FrameIndex], num_frames: int
) -> Tuple[np.ndarray, ...]:
    """Per-entry source-frame maps, each int32 ``[num_frames]``.

    Reference index semantics (video_diffusion_sd/models/attention.py:388-410):
    'first'/'last'/'mid' broadcast one frame to all; ints are relative offsets
    clipped to [0, F-1].
    """
    out = []
    for index in indices:
        if isinstance(index, str):
            if index == "first":
                fi = np.zeros(num_frames, np.int32)
            elif index == "last":
                fi = np.full(num_frames, num_frames - 1, np.int32)
            elif index in ("mid", "middle"):
                fi = np.full(num_frames, (num_frames - 1) // 2, np.int32)
            else:
                raise ValueError(f"unknown frame index {index!r}")
        else:
            fi = np.clip(np.arange(num_frames, dtype=np.int32) + int(index), 0, num_frames - 1)
        out.append(fi)
    return tuple(out)


def cross_frame_kv(x: torch.Tensor, num_frames: int, indices: Sequence[FrameIndex]):
    """Sparse-causal KV expansion: each frame's K/V tokens become the
    concatenation of the tokens of the frames selected by ``indices``.

    ``x`` is ``[B * F, L, D]``; returns ``[B * F, L * len(indices), D]``.
    """
    if not indices:
        return x
    bf, l, d = x.shape
    xv = x.reshape(bf // num_frames, num_frames, l, d)
    gathers = [xv[:, torch.as_tensor(m, dtype=torch.long, device=x.device)]
               for m in resolve_frame_indices(indices, num_frames)]
    return torch.cat(gathers, dim=2).reshape(bf, l * len(indices), d)


def _shift(q_cnt, q_sty, k_sty, v_sty, k_style, v_style, beta: float, cfg: StyleShiftConfig):
    q_new = cfg.gamma * (cfg.alpha * q_cnt + (1.0 - cfg.alpha) * q_sty)
    # fp32 blend of the adain output (rounded to the working type first, as
    # the JAX package's dtype promotion does)
    k_new = beta * attention_adain(k_sty, k_style).float() + (1.0 - beta) * k_style.float()
    v_new = beta * attention_adain(v_sty, v_style).float() + (1.0 - beta) * v_style.float()
    return q_new.to(q_sty.dtype), k_new.to(k_sty.dtype), v_new.to(v_sty.dtype)


def apply_style_shift(q, k, v, step_idx: int, cfg: StyleShiftConfig, num_frames: int):
    """AdaIN-guided attention shift on pre-head ``[3F, L, D]`` tensors.

    Branch layout along the batch axis is [content | style | stylized]
    (reference batching: stable_diffusion.py:704). Inside the step window the
    stylized chunk becomes
      q'  = gamma * (alpha * q_cnt + (1-alpha) * q_sty)
      k'  = beta * adain(k_sty, k_style) + (1-beta) * k_style     (v likewise)
    (reference: video_diffusion_sd/pnp_utils.py:47-57).
    """
    if not cfg.window_gate(step_idx):
        return q, k, v
    f = num_frames
    q_out, k_out, v_out = _shift(q[:f], q[2 * f:], k[2 * f:], v[2 * f:], k[f:2 * f],
                                 v[f:2 * f], cfg.beta(step_idx), cfg)
    return (torch.cat([q[:2 * f], q_out]), torch.cat([k[:2 * f], k_out]),
            torch.cat([v[:2 * f], v_out]))


def apply_style_shift_injected(q, k, v, style_k, style_v, step_idx: int,
                               cfg: StyleShiftConfig, num_frames: int):
    """2-branch AdaIN shift on pre-head ``[2F, L, D]`` tensors.

    Batch layout is [content | stylized]; the style branch's projected K/V
    arrive precomputed as ``style_k`` / ``style_v`` of shape ``[1, L, D]``
    (style frames are identical, so the style branch runs once as a single
    frame). The math is :func:`apply_style_shift` with the style chunk
    broadcast from one frame.
    """
    if not cfg.window_gate(step_idx):
        return q, k, v
    f = num_frames
    q_out, k_out, v_out = _shift(q[:f], q[f:], k[f:], v[f:], style_k, style_v,
                                 cfg.beta(step_idx), cfg)
    return (torch.cat([q[:f], q_out]), torch.cat([k[:f], k_out]), torch.cat([v[:f], v_out]))


def video_mha(q, k, v, num_heads: int, num_frames: int,
              frame_indices: Sequence[FrameIndex], scale: Optional[float] = None):
    """Sparse-causal video attention on pre-head ``[B*F, L, D]`` tensors.

    The gate is the JAX package's (ops.py:335-341): the video flash kernel
    when an index set is given, L >= 1024 and L % 128 == 0 — the 64x64 and
    32x32 levels at 512 px — and the expanded-KV path otherwise. The kernel
    wrapper runs its plain version on CPU tensors.
    """
    bf, l, d = q.shape
    dh = d // num_heads
    f = num_frames
    if frame_indices and l >= 1024 and l % 128 == 0:
        from univst_torch.attention.video_flash import video_flash_attention

        b = bf // f

        def split(x):
            return x.reshape(b, f, l, num_heads, dh).permute(0, 1, 3, 2, 4).contiguous()

        dt = torch.float32 if q.dtype == torch.float32 else torch.bfloat16
        out = video_flash_attention(
            split(q).to(dt), split(k).to(dt), split(v).to(dt), tuple(frame_indices),
            sm_scale=float(dh**-0.5 if scale is None else scale),
        ).to(q.dtype)
        return out.permute(0, 1, 3, 2, 4).reshape(bf, l, d)
    if frame_indices:
        k = cross_frame_kv(k, f, frame_indices)
        v = cross_frame_kv(v, f, frame_indices)
    return mha(q, k, v, num_heads, scale)


def mha(q, k, v, num_heads: int, scale: Optional[float] = None):
    """Multi-head attention over pre-head ``[B, L, D]`` tensors -> ``[B, L, D]``."""
    b, tq, d = q.shape
    dh = d // num_heads
    s = k.shape[1]

    def split(x, t):
        return x.reshape(b, t, num_heads, dh).transpose(1, 2)

    # the JAX package's mha/heads_attention call a library TPU flash kernel;
    # the counterpart is PyTorch's fused attention
    out = F.scaled_dot_product_attention(split(q, tq), split(k, s), split(v, s), scale=scale)
    return out.transpose(1, 2).reshape(b, tq, d)
