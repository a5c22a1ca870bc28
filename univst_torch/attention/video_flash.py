"""Sparse-causal video flash attention: the CUDA kernels' wrappers and their
plain PyTorch versions, in two layouts.

* :func:`video_flash_attention` (K1) replaces the Pallas TPU kernel
  ``univst_tpu/attention/pallas_attention.py::video_flash_attention`` on
  head-major ``[B, F, H, L, dh]`` tensors (the SD UNet's attn1).
* :func:`video_flash_attention_tokens` (K2) replaces
  ``pallas_attention.py::video_flash_attention_folded`` on token-major
  ``[B, F, L, H, dh]`` tensors, free views of the projection output
  ``[B*F, L, H*dh]`` (the SD3 MMDiT's joint attention), with the output in
  the same layout: no head transpose on either side.

Each target frame attends the concatenation of the K/V of its source frames
(``resolve_frame_indices``), read unexpanded. Two kinds of operation bound
it on the H100, not bytes (:func:`work` counts all three): the tensor
cores' 4 * Lq * dh FLOPs per key, and one exponential per key and query.
The MUFU makes 16 exponentials per clock per SM; alone it would be the
floor at dh = 40 (SD-1.5's 64x64 level) and come within 8% of the tensor
cores at dh = 64 (SD3). With part of the exponentials on the FMA pipe the
tensor cores are the floor at both. Each block keeps
its query tile and running softmax on chip and streams the source tiles
past it, so no expanded K/V and no logits reach device memory. bf16 runs on
Hopper's tensor cores (TMA loads into a ring of K/V tiles, wgmma, fp32
accumulation, the softmax of one warpgroup overlapping the products of the
other), with dh padded to the MMA depth on chip only; fp32 keeps exact fp32
arithmetic on the CUDA cores. Duplicate slots are skipped and their mass
folded into the kept slot's multiplicity, which cuts the work of the first
two frames. Both kernels are one templated body in
``univst_torch/csrc/video_flash_attention.cu`` that differs only in
addressing, with a C entry point each.

On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises. ``video_flash_attention.launches`` and
``video_flash_attention_tokens.launches`` count kernel launches, apart.

Each wrapper calls a PyTorch custom op (``univst::video_flash_attention``,
``univst::video_flash_attention_tokens``), whose body runs the plain version
or the launch. The op is one unit to PyTorch's dispatcher: the profiler
names it, and ``torch.utils.flop_counter.FlopCounterMode`` counts it with
the formula registered here (:func:`work`'s FLOPs) instead of the plain
version's matmuls, which run duplicate slots that the kernels skip.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from univst_torch.attention.ops import resolve_frame_indices

_KERNEL = "video_flash_attention"
_fns = {}


def slot_tables(frame_indices: Sequence, num_frames: int):
    """``(srcs, mult)``, int32 ``[F, S]``: the source frame of each (target
    frame, slot), and the slot's multiplicity — the first occurrence of a
    source keeps the count of its duplicates, later ones get 0 (the JAX
    package's table, pallas_attention.py:300-310)."""
    srcs = np.stack(resolve_frame_indices(tuple(frame_indices), num_frames), axis=1)
    mult = np.zeros_like(srcs)
    for fi in range(num_frames):
        for sj in range(srcs.shape[1]):
            if not (srcs[fi, :sj] == srcs[fi, sj]).any():
                mult[fi, sj] = int((srcs[fi] == srcs[fi, sj]).sum())
    return srcs.astype(np.int32), mult.astype(np.int32)


class Work(NamedTuple):
    """What one call needs: tensor-core FLOPs, exponentials, bytes moved."""

    flops: float
    exps: float
    bytes: float


def work(shape: Sequence[int], frame_indices: Sequence, ctx_valid: int = 0,
         itemsize: int = 2, tables=None) -> Work:
    """The work of one call, from shapes alone, for either layout.

    ``shape`` is ``(B, F, H, Lq, L, dh)``. Each query meets the keys of its
    frame's kept slots (duplicates are elided) and ``ctx_valid`` context
    keys: 4 * dh FLOPs (Q K^T and P V) and one exponential per meeting. Bytes
    count q read and the output written once, the K/V of every frame that is
    some frame's source, and the valid context rows, each read once.
    ``tables`` (``(srcs, mult)``, the explicit slot tables of a call on
    extended K/V, e.g. a frame shard's) replaces the index set's own: the
    frames read are then the distinct ``srcs``, halo frames included.
    """
    b, f, h, lq, l, dh = (int(x) for x in shape)
    srcs, mult = tables if tables is not None else slot_tables(frame_indices, f)
    keys = l * int((np.asarray(mult) > 0).sum()) + ctx_valid * f  # summed over target frames
    exps = float(b * h * lq) * keys
    used = len(np.unique(srcs))  # source frames whose K/V is read
    nbytes = itemsize * b * h * dh * (2 * f * lq + 2 * used * l + 2 * f * ctx_valid)
    return Work(4.0 * dh * exps, exps, float(nbytes))


def encode_tables(srcs, mult) -> str:
    """Explicit slot tables as the custom ops take them: ``"srcs;mult"``,
    each row-major and comma-separated."""
    return ";".join(",".join(str(int(x)) for x in np.asarray(t).ravel()) for t in (srcs, mult))


def decode_tables(tables: str, num_frames: int):
    """``(srcs, mult)``, int32 ``[F, S]``, from :func:`encode_tables`."""
    srcs, mult = (np.asarray([int(x) for x in t.split(",")], np.int32).reshape(num_frames, -1)
                  for t in tables.split(";"))
    return srcs, mult


def _tables(frame_indices, num_frames: int, tables: Optional[str]):
    """``(srcs, mult)`` of a call: its explicit tables, else the index set's."""
    if tables is None:
        return slot_tables(frame_indices, num_frames)
    return decode_tables(tables, num_frames)


@functools.lru_cache(maxsize=64)
def _device_tables(frame_indices: tuple, num_frames: int, tables: Optional[str],
                   device: torch.device):
    srcs, mult = _tables(frame_indices, num_frames, tables)
    return (torch.from_numpy(srcs).to(device), torch.from_numpy(mult).to(device))


def _check(q, k, v, frame_indices, sm_scale, ctx_k, ctx_v, ctx_valid, seq_axis: int = 3,
           tables=None):
    """Shapes, types, devices, contiguity and scale the kernels take;
    ``seq_axis`` is 3 head-major (``[B, F, H, L, dh]``) and 2 token-major
    (``[B, F, L, H, dh]``). With explicit ``tables`` k/v may hold another
    frame count ``Fk`` than q, and every source must lie in ``[0, Fk)``."""
    if not frame_indices:
        raise ValueError("video flash attention needs a non-empty frame index set")
    if sm_scale is not None and not sm_scale > 0:
        raise ValueError(f"sm_scale must be positive, got {sm_scale}")
    if q.dim() != 5 or k.dim() != 5 or k.shape != v.shape:
        raise ValueError(f"want 5-d q and k/v of one shape; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    other = 5 - seq_axis  # the head axis: 2 head-major, 3 token-major

    def same(a, b, frames=True):  # every axis but the sequence axis
        return a.shape[0] == b.shape[0] and (not frames or a.shape[1] == b.shape[1]) \
            and a.shape[other] == b.shape[other] and a.shape[4] == b.shape[4]

    if not same(q, k, frames=tables is None):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if tables is not None:
        srcs, mult = tables
        want = (q.shape[1], len(frame_indices))
        if srcs.shape != want or mult.shape != want:
            raise ValueError(f"slot tables {srcs.shape}, {mult.shape}; want {want}")
        if srcs.min() < 0 or srcs.max() >= k.shape[1]:
            raise ValueError(f"slot sources outside the {k.shape[1]} K/V frames")
    dh = q.shape[4]
    if dh > 128 or dh % 8:
        raise ValueError(f"head_dim must be a multiple of 8 and <= 128, got {dh}")
    tensors = [q, k, v] + ([ctx_k, ctx_v] if ctx_k is not None else [])
    if (ctx_k is None) != (ctx_v is None):
        raise ValueError("ctx_k and ctx_v go together")
    if ctx_k is not None:
        if ctx_k.shape != ctx_v.shape or not same(q, ctx_k):
            raise ValueError(f"ctx k/v {tuple(ctx_k.shape)} do not match q {tuple(q.shape)}")
        if not 1 <= ctx_valid <= ctx_k.shape[seq_axis]:
            raise ValueError(f"ctx_valid={ctx_valid} outside [1, {ctx_k.shape[seq_axis]}]")
    for t in tensors:
        if t.dtype not in (torch.float32, torch.bfloat16) or t.dtype != q.dtype:
            raise TypeError(f"want one dtype of float32/bfloat16, got {[x.dtype for x in tensors]}")
        if t.device != q.device:
            raise ValueError("all inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")


def video_flash_attention_plain(q, k, v, frame_indices: Sequence, sm_scale: Optional[float] = None,
                                ctx_k=None, ctx_v=None, ctx_valid: Optional[int] = None,
                                tables=None):
    """Plain PyTorch version: gather each target frame's source-frame K/V,
    concatenate them (duplicates included, plus the valid context), and run
    an fp32 softmax. One (b, f) row at a time, so the logits stay
    ``[H, Lq, S*L + Lc]``. ``tables`` as for :func:`video_flash_attention`
    (its ``srcs`` index k/v's frames)."""
    b, f, h, lq, dh = q.shape
    srcs, _ = tables if tables is not None else slot_tables(frame_indices, f)
    scale = float(dh**-0.5 if sm_scale is None else sm_scale)
    out = torch.empty_like(q)
    for bi in range(b):
        for fi in range(f):
            ks = [k[bi, s] for s in srcs[fi]]
            vs = [v[bi, s] for s in srcs[fi]]
            if ctx_k is not None:
                ks.append(ctx_k[bi, fi, :, :ctx_valid])
                vs.append(ctx_v[bi, fi, :, :ctx_valid])
            kk = torch.cat(ks, dim=1).float()
            vv = torch.cat(vs, dim=1).float()
            p = torch.softmax(torch.matmul(q[bi, fi].float(), kk.transpose(1, 2)) * scale, dim=-1)
            out[bi, fi] = torch.matmul(p, vv).to(q.dtype)
    return out


def _kernel_fn(symbol: str):
    fn = _fns.get(symbol)
    if fn is None:
        from univst_torch._build import load_library

        fn = getattr(load_library(_KERNEL), symbol)
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def _launch(symbol: str, q, k, v, frame_indices, sm_scale, ctx_k, ctx_v, ctx_valid,
            h: int, lq: int, l: int, lc: int, tables: Optional[str] = None):
    """Launch one kernel on q's current stream; ``out`` is q's layout. k/v
    hold ``Fk = k.shape[1]`` frames (q's F unless ``tables`` is given)."""
    b, f, dh, fk = q.shape[0], q.shape[1], q.shape[4], k.shape[1]
    scale = float(dh**-0.5 if sm_scale is None else sm_scale)
    fn = _kernel_fn(symbol)
    srcs, mult = _device_tables(tuple(frame_indices), f, tables, q.device)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 ctx_k.data_ptr() if ctx_k is not None else None,
                 ctx_v.data_ptr() if ctx_v is not None else None,
                 out.data_ptr(), srcs.data_ptr(), mult.data_ptr(),
                 b, f, fk, h, lq, l, lc, ctx_valid or 0, dh, srcs.shape[1], scale,
                 int(q.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error {err}")
    return out


def _encode_indices(frame_indices: Sequence) -> str:
    """A frame index set as the custom ops take it, e.g. ``"first,-1,0"``."""
    return ",".join(str(i) for i in frame_indices)


def _decode_indices(frame_indices: str) -> tuple:
    return tuple(int(i) if i.lstrip("-").isdigit() else i for i in frame_indices.split(","))


def _op_args(sm_scale, ctx_valid):
    return (None if sm_scale is None else float(sm_scale),
            None if ctx_valid is None else int(ctx_valid))


@torch.library.custom_op("univst::video_flash_attention", mutates_args=())
def _video_flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              frame_indices: str, sm_scale: Optional[float],
                              ctx_k: Optional[torch.Tensor], ctx_v: Optional[torch.Tensor],
                              ctx_valid: Optional[int],
                              tables: Optional[str] = None) -> torch.Tensor:
    idx = _decode_indices(frame_indices)
    if q.device.type == "cpu":
        return video_flash_attention_plain(q, k, v, idx, sm_scale, ctx_k, ctx_v, ctx_valid,
                                           None if tables is None
                                           else decode_tables(tables, q.shape[1]))
    out = _launch("univst_video_flash_attention", q, k, v, idx, sm_scale, ctx_k,
                  ctx_v, ctx_valid, h=q.shape[2], lq=q.shape[3], l=k.shape[3],
                  lc=ctx_k.shape[3] if ctx_k is not None else 0, tables=tables)
    video_flash_attention.launches += 1
    return out


@register_flop_formula(torch.ops.univst.video_flash_attention)
def _video_flash_attention_flops(q, k, v, frame_indices, sm_scale=None, ctx_k=None, ctx_v=None,
                                 ctx_valid=None, tables=None, *args, out_shape=None,
                                 **kwargs) -> int:
    b, f, h, lq, dh = q
    return int(work((b, f, h, lq, k[3], dh), _decode_indices(frame_indices), ctx_valid or 0,
                    tables=None if tables is None else decode_tables(tables, f)).flops)


def video_flash_attention(q, k, v, frame_indices: Sequence, sm_scale: Optional[float] = None,
                          ctx_k=None, ctx_v=None, ctx_valid: Optional[int] = None, tables=None):
    """Attention where each frame's KV is the concatenation of the frames
    selected by ``frame_indices``, computed without expanding K/V.

    Args:
      q: ``[B, F, H, Lq, dh]`` (Lq may differ from L).
      k, v: ``[B, F, H, L, dh]``, or ``[B, Fk, H, L, dh]`` with ``tables``.
      frame_indices: sparse-causal index set, e.g. ``(-1, 'first')``.
      ctx_k, ctx_v: optional ``[B, F, H, Lc, dh]`` per-frame context K/V that
        every query of the frame also attends, limited to the first
        ``ctx_valid`` (default Lc) tokens.
      tables: optional explicit slot tables ``(srcs, mult)``, int ``[F, S]``
        (S = len(frame_indices)): slot s of target frame f reads k/v frame
        ``srcs[f, s]`` with multiplicity ``mult[f, s]`` (0 skips it). A
        frame shard's form (``ops.shard_kv_tables``): k/v hold the rank's
        frames and the halo frames they read. Without it the tables are
        the index set's own (:func:`slot_tables`) and ``Fk = F``.
    Returns ``[B, F, H, Lq, dh]`` in the input dtype (float32 or bfloat16).
    """
    if ctx_k is not None and ctx_valid is None:
        ctx_valid = ctx_k.shape[3]
    _check(q, k, v, frame_indices, sm_scale, ctx_k, ctx_v, ctx_valid, tables=tables)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"video_flash_attention runs on CPU or CUDA, not {q.device}")
    sm_scale, ctx_valid = _op_args(sm_scale, ctx_valid)
    return _video_flash_attention_op(q, k, v, _encode_indices(frame_indices), sm_scale, ctx_k,
                                     ctx_v, ctx_valid,
                                     None if tables is None else encode_tables(*tables))


video_flash_attention.launches = 0


def _head_major(x):
    return None if x is None else x.transpose(2, 3)


def video_flash_attention_tokens_plain(q, k, v, frame_indices: Sequence,
                                       sm_scale: Optional[float] = None, ctx_k=None,
                                       ctx_v=None, ctx_valid: Optional[int] = None,
                                       tables=None):
    """Plain PyTorch version of :func:`video_flash_attention_tokens`: the
    head-major plain version on transposed views, transposed back."""
    out = video_flash_attention_plain(
        _head_major(q), _head_major(k), _head_major(v), frame_indices, sm_scale,
        _head_major(ctx_k), _head_major(ctx_v), ctx_valid, tables)
    return out.transpose(2, 3).contiguous()


@torch.library.custom_op("univst::video_flash_attention_tokens", mutates_args=())
def _video_flash_attention_tokens_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                     frame_indices: str, sm_scale: Optional[float],
                                     ctx_k: Optional[torch.Tensor],
                                     ctx_v: Optional[torch.Tensor],
                                     ctx_valid: Optional[int],
                                     tables: Optional[str] = None) -> torch.Tensor:
    idx = _decode_indices(frame_indices)
    if q.device.type == "cpu":
        return video_flash_attention_tokens_plain(
            q, k, v, idx, sm_scale, ctx_k, ctx_v, ctx_valid,
            None if tables is None else decode_tables(tables, q.shape[1]))
    out = _launch("univst_video_flash_attention_tokens", q, k, v, idx, sm_scale,
                  ctx_k, ctx_v, ctx_valid, h=q.shape[3], lq=q.shape[2], l=k.shape[2],
                  lc=ctx_k.shape[2] if ctx_k is not None else 0, tables=tables)
    video_flash_attention_tokens.launches += 1
    return out


@register_flop_formula(torch.ops.univst.video_flash_attention_tokens)
def _video_flash_attention_tokens_flops(q, k, v, frame_indices, sm_scale=None, ctx_k=None,
                                        ctx_v=None, ctx_valid=None, tables=None, *args,
                                        out_shape=None, **kwargs) -> int:
    b, f, lq, h, dh = q
    return int(work((b, f, h, lq, k[2], dh), _decode_indices(frame_indices), ctx_valid or 0,
                    tables=None if tables is None else decode_tables(tables, f)).flops)


def video_flash_attention_tokens(q, k, v, frame_indices: Sequence,
                                 sm_scale: Optional[float] = None, ctx_k=None, ctx_v=None,
                                 ctx_valid: Optional[int] = None, tables=None):
    """:func:`video_flash_attention` on token-major tensors, the layout of
    ``pallas_attention.py::video_flash_attention_folded``.

    Args:
      q: ``[B, F, Lq, H, dh]`` (Lq may differ from L and need not be a
        multiple of the kernel's 64-row tile).
      k, v: ``[B, F, L, H, dh]``, or ``[B, Fk, L, H, dh]`` with ``tables``
        (as for :func:`video_flash_attention`).
      frame_indices: sparse-causal index set, e.g. ``('first', -1, 0)``.
      ctx_k, ctx_v: optional ``[B, F, Lc, H, dh]`` per-frame context K/V that
        every query of the frame also attends, limited to the first
        ``ctx_valid`` (default Lc) tokens.
    Returns ``[B, F, Lq, H, dh]`` in the input dtype (float32 or bfloat16).
    """
    if ctx_k is not None and ctx_valid is None:
        ctx_valid = ctx_k.shape[2]
    _check(q, k, v, frame_indices, sm_scale, ctx_k, ctx_v, ctx_valid, seq_axis=2,
           tables=tables)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"video_flash_attention_tokens runs on CPU or CUDA, not {q.device}")
    sm_scale, ctx_valid = _op_args(sm_scale, ctx_valid)
    return _video_flash_attention_tokens_op(q, k, v, _encode_indices(frame_indices), sm_scale,
                                            ctx_k, ctx_v, ctx_valid,
                                            None if tables is None else encode_tables(*tables))


video_flash_attention_tokens.launches = 0
