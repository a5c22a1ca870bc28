"""Functional attention building blocks (PyTorch port of
``univst_tpu/attention/ops.py``).

The reference implements its method by patching ``attn1.forward`` on selected
decoder blocks (video_diffusion_sd/pnp_utils.py:104-111). Here the same math
is a set of plain functions over (q, k, v) that take the step index and a
:class:`~univst_torch.core.config.StyleShiftConfig`.

Layouts (as in the JAX package):
  * pre-head tensors: ``[B, L, D]`` with ``B = branches * frames``
  * per-head tensors: ``[B, heads, N, Dh]``, or token-major
    ``[B, N, heads, Dh]`` (SD3; a free view of the projection output)
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from univst_torch.core.adain import (
    attention_adain, attention_adain_sd3, attention_adain_sd3_tm,
)
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


@functools.lru_cache(maxsize=256)
def shard_kv_tables(indices: Tuple[FrameIndex, ...], num_frames: int, offset: int, local: int):
    """The K/V tables of a rank that holds global frames ``[offset, offset +
    local)`` of a ``num_frames`` clip.

    Returns ``(halo, srcs, mult)``: ``halo`` the sorted global frames, outside
    the shard, that its frames read (what ``comm.frame_halo`` fetches);
    ``srcs`` int32 ``[local, S]``, each slot's source in the rank's
    extended K/V ``[own frames | halo frames]`` (``Fk = local + len(halo)``
    frames); ``mult`` int32 ``[local, S]``, each slot's multiplicity from the
    global sources (the first occurrence of a source keeps the count of its
    duplicates, later ones 0), so the duplicate elision of frame 0, where
    ``-1``, ``0`` and ``'first'`` name one frame, holds on every rank.
    """
    glob = np.stack(resolve_frame_indices(indices, num_frames), axis=1)[offset:offset + local]
    halo = tuple(sorted({int(g) for g in glob.ravel()} - set(range(offset, offset + local))))
    pos = {g: g - offset for g in range(offset, offset + local)}
    pos.update({g: local + i for i, g in enumerate(halo)})
    srcs = np.vectorize(pos.__getitem__, otypes=[np.int32])(glob)
    mult = np.zeros_like(srcs)
    for fi in range(glob.shape[0]):
        for sj in range(glob.shape[1]):
            if not (glob[fi, :sj] == glob[fi, sj]).any():
                mult[fi, sj] = int((glob[fi] == glob[fi, sj]).sum())
    return halo, srcs, mult


def shard_halo_needs(indices: Tuple[FrameIndex, ...], num_frames: int, n_ranks: int):
    """Per rank, the halo frames of :func:`shard_kv_tables` (what each rank
    reads from the others)."""
    local = num_frames // n_ranks
    return tuple(shard_kv_tables(indices, num_frames, r * local, local)[0]
                 for r in range(n_ranks))


def extend_kv(x: torch.Tensor, shard, indices: Sequence[FrameIndex]):
    """This rank's ``[B, f, ...]`` K/V (frames on axis 1) extended by the
    halo frames the index set reads on other ranks: ``([B, Fk, ...],
    srcs, mult)`` with the tables of :func:`shard_kv_tables`."""
    from univst_torch.distributed.comm import frame_halo

    indices = tuple(indices)
    f = x.shape[1]
    halo, srcs, mult = shard_kv_tables(indices, shard.num_frames, shard.offset, f)
    needs = shard_halo_needs(indices, shard.num_frames, shard.mesh.n_data)
    if any(needs):
        x = torch.cat([x, frame_halo(x, shard, needs, site="kv_halo")], dim=1)
    return x, srcs, mult


def cross_frame_kv(x: torch.Tensor, num_frames: int, indices: Sequence[FrameIndex],
                   shard=None):
    """Sparse-causal KV expansion: each frame's K/V tokens become the
    concatenation of the tokens of the frames selected by ``indices``.

    ``x`` is ``[B * F, L, D]``; returns ``[B * F, L * len(indices), D]``.
    With ``shard`` (a ``comm.FrameShard``), ``x`` holds this rank's frames,
    the index set is resolved in global frame numbers and the sources on
    other ranks arrive through ``comm.frame_halo``.
    """
    if not indices:
        return x
    bf, l, d = x.shape
    if shard is not None:
        xe, srcs, _ = extend_kv(x.reshape(bf // num_frames, num_frames, l, d), shard, indices)
        gathered = xe[:, torch.as_tensor(srcs, dtype=torch.long, device=x.device)]
        return gathered.reshape(bf, l * len(indices), d)
    xv = x.reshape(bf // num_frames, num_frames, l, d)
    gathers = [xv[:, torch.as_tensor(m, dtype=torch.long, device=x.device)]
               for m in resolve_frame_indices(indices, num_frames)]
    return torch.cat(gathers, dim=2).reshape(bf, l * len(indices), d)


def cross_frame_kv_heads(x: torch.Tensor, num_frames: int, indices: Sequence[FrameIndex]):
    """Sparse-causal KV expansion on per-head ``[B*F, H, N, Dh]`` tensors
    (the SD3 layout; reference sd3 pnp_utils.py:53-78 gathers after the
    head split). Returns ``[B*F, H, N * len(indices), Dh]``."""
    if not indices:
        return x
    bf, h, n, dh = x.shape
    xv = x.reshape(bf // num_frames, num_frames, h, n, dh)
    gathers = [xv[:, torch.as_tensor(m, dtype=torch.long, device=x.device)]
               for m in resolve_frame_indices(indices, num_frames)]
    return torch.cat(gathers, dim=3).reshape(bf, h, n * len(indices), dh)


def _shift(q_cnt, q_sty, k_sty, v_sty, k_style, v_style, beta: float, cfg: StyleShiftConfig,
           adain=attention_adain):
    q_new = cfg.gamma * (cfg.alpha * q_cnt + (1.0 - cfg.alpha) * q_sty)
    # fp32 blend of the adain output (rounded to the working type first, as
    # the JAX package's dtype promotion does)
    k_new = beta * adain(k_sty, k_style).float() + (1.0 - beta) * k_style.float()
    v_new = beta * adain(v_sty, v_style).float() + (1.0 - beta) * v_style.float()
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
    arrive precomputed as ``style_k`` / ``style_v``: ``[1, L, D]`` on the
    style-singleton path (identical style frames: the style branch ran once
    as a single frame, broadcast here), or ``[F, L, D]`` from a capture
    forward of all F style frames (capture-and-inject). The math is
    :func:`apply_style_shift` with that style chunk.
    """
    if not cfg.window_gate(step_idx):
        return q, k, v
    f = num_frames
    q_out, k_out, v_out = _shift(q[:f], q[f:], k[f:], v[f:], style_k, style_v,
                                 cfg.beta(step_idx), cfg)
    return (torch.cat([q[:f], q_out]), torch.cat([k[:f], k_out]), torch.cat([v[:f], v_out]))


def apply_style_shift_sd3(q, k, v, step_idx: int, cfg: StyleShiftConfig, num_frames: int,
                          token_major: bool = False):
    """SD3 variant of :func:`apply_style_shift` on per-head ``[3F, heads, N,
    Dh]`` tensors after the q/k norms (reference: video_diffusion_sd3/
    pnp_utils.py:181-194). ``token_major`` takes ``[3F, N, heads, Dh]``
    tensors and switches the AdaIN reduction axes; the rest is axis-0
    slicing and elementwise math, the same in both layouts."""
    if not cfg.window_gate(step_idx):
        return q, k, v
    f = num_frames
    adain = attention_adain_sd3_tm if token_major else attention_adain_sd3
    q_out, k_out, v_out = _shift(q[:f], q[2 * f:], k[2 * f:], v[2 * f:], k[f:2 * f],
                                 v[f:2 * f], cfg.beta(step_idx), cfg, adain)
    return (torch.cat([q[:2 * f], q_out]), torch.cat([k[:2 * f], k_out]),
            torch.cat([v[:2 * f], v_out]))


def apply_style_shift_sd3_injected(q, k, v, style_k, style_v, step_idx: int,
                                   cfg: StyleShiftConfig, num_frames: int,
                                   token_major: bool = False):
    """SD3 2-branch variant on per-head ``[2F, heads, N, Dh]`` tensors
    ([content | stylized]) with the style branch's K/V injected as ``[1,
    heads, N, Dh]`` (identical style frames run once); ``token_major``: see
    :func:`apply_style_shift_sd3`."""
    if not cfg.window_gate(step_idx):
        return q, k, v
    f = num_frames
    adain = attention_adain_sd3_tm if token_major else attention_adain_sd3
    q_out, k_out, v_out = _shift(q[:f], q[f:], k[f:], v[f:], style_k, style_v,
                                 cfg.beta(step_idx), cfg, adain)
    return (torch.cat([q[:f], q_out]), torch.cat([k[:f], k_out]), torch.cat([v[:f], v_out]))


def video_mha(q, k, v, num_heads: int, num_frames: int,
              frame_indices: Sequence[FrameIndex], scale: Optional[float] = None, shard=None):
    """Sparse-causal video attention on pre-head ``[B*F, L, D]`` tensors.

    The gate is the JAX package's (ops.py:335-341): the video flash kernel
    when an index set is given, L >= 1024 and L % 128 == 0 — the 64x64 and
    32x32 levels at 512 px — and the expanded-KV path otherwise. The kernel
    wrapper runs its plain version on CPU tensors.

    With ``shard`` (a ``comm.FrameShard``) the tensors hold this rank's
    ``F = shard.local`` frames: the index set is resolved in global frame
    numbers, the K/V of the sources on other ranks arrive through one
    ``comm.frame_halo``, and the kernel reads the extended K/V of ``Fk =
    F + halo`` frames through explicit slot tables
    (:func:`shard_kv_tables`); the expanded path gathers from the same
    extended K/V.
    """
    bf, l, d = q.shape
    dh = d // num_heads
    f = num_frames
    if frame_indices and l >= 1024 and l % 128 == 0:
        from univst_torch.attention.video_flash import video_flash_attention

        b = bf // f

        def split(x):
            return x.reshape(b, x.shape[1], l, num_heads, dh).permute(0, 1, 3, 2, 4).contiguous()

        tables = None
        if shard is not None:
            kv, srcs, mult = extend_kv(torch.cat([k, v]).reshape(2 * b, f, l, d), shard,
                                       frame_indices)
            k, v = kv.chunk(2)
            tables = (srcs, mult)
        else:
            k, v = k.reshape(b, f, l, d), v.reshape(b, f, l, d)
        dt = torch.float32 if q.dtype == torch.float32 else torch.bfloat16
        out = video_flash_attention(
            split(q.reshape(b, f, l, d)).to(dt), split(k).to(dt), split(v).to(dt),
            tuple(frame_indices), sm_scale=float(dh**-0.5 if scale is None else scale),
            tables=tables,
        ).to(q.dtype)
        return out.permute(0, 1, 3, 2, 4).reshape(bf, l, d)
    if frame_indices:
        if shard is not None:
            kv = cross_frame_kv(torch.cat([k.reshape(-1, f, l, d), v.reshape(-1, f, l, d)])
                                .reshape(-1, l, d), f, frame_indices, shard)
            k, v = kv.chunk(2)
        else:
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


def joint_video_attention_tokens(q, k, v, num_frames: int, frame_indices: Sequence[FrameIndex],
                                 cq=None, ck=None, cv=None, scale: Optional[float] = None,
                                 shard=None):
    """SD3/MMDiT joint attention with sparse-causal video K/V on token-major
    per-head tensors ``[B*F, L, H, dh]`` (a free view of the projection
    output ``[B*F, L, H*dh]``), plus optional context streams
    ``[B*F, Lc, H, dh]``.

    Reference semantics (sd3 pnp_utils.py:53-84): expand the image K/V by
    gathering the ``frame_indices`` frames, append the context K/V, and run
    attention over the joint ``[img*slots | ctx]`` sequence for the joint
    ``[img | ctx]`` queries. On a CUDA tensor, under the JAX package's gate
    (an index set, n >= 1024, n % 128 == 0, B*F a multiple of F), this is
    one launch of the token-major video flash kernel (K2): image and context
    queries go as one ``[img | ctx]`` stream against the unexpanded image
    K/V and the frame's own context K/V, and nothing is expanded. The
    kernel masks the ragged last q tile and the partial context tile
    itself, so unlike the TPU route no pad rows exist. Elsewhere (the CPU
    and the short sequences) the head-major expand + concat path runs, with
    PyTorch's fused attention.

    With ``shard`` (a ``comm.FrameShard``) the tensors hold this rank's
    ``F = shard.local`` frames: the index set is resolved in global frame
    numbers and the image K/V of the sources on other ranks (frame 0 and
    the frame before the shard for ``SD3_FRAME_INDICES``) arrive through
    one ``comm.frame_halo`` over the data group; K2 reads the extended K/V
    of ``Fk = F + halo`` frames through explicit slot tables
    (:func:`shard_kv_tables`), and the expanded path gathers from the same
    extended K/V. The context K/V is per frame and crosses no rank.

    Returns ``[B*F, L(+Lc), H, dh]`` (context rows appended when ``cq`` is
    given).
    """
    bf, n, nh, dh = q.shape
    f = num_frames
    has_ctx = cq is not None
    tables = None
    if frame_indices and shard is not None:
        kv, srcs, mult = extend_kv(torch.cat([k, v]).reshape(2 * (bf // f), f, n, nh, dh),
                                   shard, frame_indices)
        k, v = kv.chunk(2)  # [B, Fk, L, H, dh]
        tables = (srcs, mult)
    if q.device.type == "cuda" and frame_indices and n >= 1024 and n % 128 == 0 and bf % f == 0:
        from univst_torch.attention.video_flash import video_flash_attention_tokens

        b = bf // f
        dt = torch.float32 if q.dtype == torch.float32 else torch.bfloat16

        def r5(x):
            return x.reshape(b, -1, x.shape[-3], nh, dh).to(dt).contiguous()

        qj = torch.cat([q, cq], dim=1) if has_ctx else q
        ctx_kw = dict(ctx_k=r5(ck), ctx_v=r5(cv), ctx_valid=ck.shape[1]) if has_ctx else {}
        out = video_flash_attention_tokens(
            r5(qj), r5(k), r5(v), tuple(frame_indices),
            sm_scale=float(dh**-0.5 if scale is None else scale), tables=tables, **ctx_kw)
        return out.reshape(bf, qj.shape[1], nh, dh).to(q.dtype)

    def hm(x):
        return x.transpose(1, 2)

    if tables is not None:
        # each target frame's slots from the extended K/V, slot-major as
        # cross_frame_kv_heads lays them: [B*F, H, S*L, dh]
        ixs = torch.as_tensor(tables[0], dtype=torch.long, device=q.device)

        def expand(x):
            return x[:, ixs].permute(0, 1, 4, 2, 3, 5).reshape(bf, nh, -1, dh)

        kx, vx = expand(k), expand(v)
    else:
        kx = cross_frame_kv_heads(hm(k), f, frame_indices)
        vx = cross_frame_kv_heads(hm(v), f, frame_indices)
    qh = hm(q)
    if has_ctx:
        qh = torch.cat([qh, hm(cq)], dim=2)
        kx = torch.cat([kx, hm(ck)], dim=2)
        vx = torch.cat([vx, hm(cv)], dim=2)
    # the JAX package's heads_attention calls a library TPU flash kernel; the
    # counterpart is PyTorch's fused attention
    return F.scaled_dot_product_attention(qh, kx, vx, scale=scale).transpose(1, 2)
