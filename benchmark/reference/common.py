"""Plain PyTorch building blocks of the benchmark's references.

Nothing here imports the program under test. The layers are ``nn.Module``
classes only so that their parameter names (the diffusers / transformers
checkpoint keys) and shapes come out of ``named_parameters``: the benchmark
draws the weights for those names (``benchmark/weights.py``) and hands the
same values to the program and to the reference.

Precision. A module computes in the dtype of its weights; norms, softmax
statistics, AdaIN and the schedulers run in float32 (``in_stats``). Two
controls put the precision below the configuration's in the reference:
``set_fp8(model)`` rounds every matmul and convolution input, weights
included, and every attention q / k / v through float8 e4m3 with a
per-tensor scale first (below the bfloat16 products);
``stats_dtype(torch.bfloat16)`` runs the norms, AdaIN and the schedulers'
arithmetic in bfloat16 (below their float32).
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

F8_MAX = 448.0  # largest finite float8_e4m3fn
_STATS = [torch.float32]  # the dtype of norms, AdaIN and the schedulers


def in_stats(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the precision of norms, AdaIN and the schedulers' arithmetic:
    float32, or what ``stats_dtype`` sets."""
    return x.to(_STATS[0])


@contextlib.contextmanager
def stats_dtype(dtype):
    """While active, ``in_stats`` gives ``dtype``: the control of the float32
    statistics."""
    prev = _STATS[0]
    _STATS[0] = dtype
    try:
        yield
    finally:
        _STATS[0] = prev


def q8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through float8 e4m3 with a per-tensor scale."""
    s = t.detach().abs().amax().float().clamp(min=1e-30) / F8_MAX
    return ((t.float() / s).to(torch.float8_e4m3fn).float() * s).to(t.dtype)


class Lowp(nn.Module):
    """A module whose products can be switched to the float8 control."""

    fp8 = False

    def cast(self, *xs):
        return tuple(q8(x) if self.fp8 else x for x in xs)


def set_fp8(model: nn.Module, on: bool = True) -> nn.Module:
    for m in model.modules():
        if isinstance(m, Lowp):
            m.fp8 = on
    return model


CONTROLS = ("fp8", "bf16_stats")


def control(model: nn.Module, name=None):
    """Switches the control ``name`` (one of ``CONTROLS``, or None for the
    reference itself) on in ``model``; returns the context to compute in."""
    if name is not None and name not in CONTROLS:
        raise ValueError(f"unknown control {name!r}: {CONTROLS}")
    set_fp8(model, name == "fp8")
    return stats_dtype(torch.bfloat16) if name == "bf16_stats" else contextlib.nullcontext()


class Linear(Lowp):
    def __init__(self, din: int, dout: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dout, din))
        self.bias = nn.Parameter(torch.empty(dout)) if bias else None

    def forward(self, x):
        x, w = self.cast(x.to(self.weight.dtype), self.weight)
        return F.linear(x, w, self.bias)


class Conv(Lowp):
    """2-d (``k`` an int) or 3-d (``k`` a triple) convolution."""

    def __init__(self, cin: int, cout: int, k, stride: int = 1, padding=0):
        super().__init__()
        ks = (k, k) if isinstance(k, int) else tuple(k)
        self.weight = nn.Parameter(torch.empty(cout, cin, *ks))
        self.bias = nn.Parameter(torch.empty(cout))
        self.stride, self.padding = stride, padding

    def forward(self, x):
        x, w = self.cast(x.to(self.weight.dtype), self.weight)
        conv = F.conv2d if w.dim() == 4 else F.conv3d
        return conv(x, w, self.bias, self.stride, self.padding)


class Norm(nn.Module):
    """Affine parameters of a group / layer norm; the statistics in fp32."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))

    def group(self, x, groups: int, eps: float):
        """``F.group_norm`` over dim 1; a 5-d ``[B, C, F, H, W]`` input takes
        its statistics over frames too."""
        return F.group_norm(in_stats(x), groups, in_stats(self.weight), in_stats(self.bias),
                            eps).to(x.dtype)

    def layer(self, x, eps: float):
        return F.layer_norm(in_stats(x), (x.shape[-1],), in_stats(self.weight), in_stats(self.bias),
                            eps).to(x.dtype)


class Embedding(nn.Module):
    def __init__(self, n: int, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, d))


def attention(q, k, v, heads: int, fp8: bool = False, causal: bool = False, bias=None):
    """Multi-head attention on ``[N, Lq, D]`` / ``[N, Lk, D]`` tensors;
    ``bias`` ``[Lk]`` is added to every query's logits."""
    if fp8:
        q, k, v = q8(q), q8(k), q8(v)
    n, lq, d = q.shape

    def split(x):
        return x.reshape(n, x.shape[1], heads, d // heads).transpose(1, 2)

    mask = None if bias is None else bias.to(q.dtype)[None, None, None, :]
    o = F.scaled_dot_product_attention(split(q), split(k), split(v), attn_mask=mask,
                                       is_causal=causal)
    return o.transpose(1, 2).reshape(n, lq, d)


def frame_sources(indices: Sequence, f: int) -> List[Tuple[Tuple[int, ...], Tuple[int, ...]]]:
    """Each frame's distinct source frames under a sparse-causal index set
    (``'first'`` is frame 0, an int a relative offset clipped to the clip)
    and how often the set names each: attending the concatenated K/V of the
    set's frames is attending each distinct source once with its keys'
    weights multiplied by that count."""
    out = []
    for i in range(f):
        named = [0 if idx == "first" else min(max(i + int(idx), 0), f - 1) for idx in indices]
        src = tuple(dict.fromkeys(named))
        out.append((src, tuple(named.count(s) for s in src)))
    return out


def video_attention(q, k, v, heads: int, f: int, indices: Sequence, fp8: bool = False, ctx=None):
    """Sparse-causal attention on ``[B*F, L, D]`` tensors: each query of
    frame i attends the keys of the frames the index set names for it (a
    frame named twice weighs twice) and, with ``ctx`` (``(cq, ck, cv)``,
    each ``[B*F, Lc, D]``), the frame's own context tokens, whose queries
    attend the same keys. Returns ``[B*F, L(+Lc), D]``. Frames are grouped by
    their number of sources and counts."""
    bf, l, d = q.shape
    b = bf // f
    src = frame_sources(indices, f)
    q5, k5, v5 = (x.reshape(b, f, x.shape[1], d) for x in (q, k, v))
    if ctx is not None:
        cq, ck, cv = (x.reshape(b, f, x.shape[1], d) for x in ctx)
        q5 = torch.cat([q5, cq], 2)
    out = torch.empty_like(q5)
    for pattern in sorted({(len(s), m) for s, m in src}):
        fr = [i for i in range(f) if (len(src[i][0]), src[i][1]) == pattern]
        n, mult = pattern
        ix = torch.as_tensor([src[i][0] for i in fr], device=q.device)
        kk, vv = (x[:, ix].reshape(b, len(fr), n * l, d) for x in (k5, v5))
        bias = None
        # counts matter where keys of different counts meet: other sources,
        # or the context's keys
        if len(set(mult)) > 1 or (ctx is not None and mult[0] > 1):
            bias = torch.log(torch.as_tensor(mult, dtype=torch.float32,
                                             device=q.device)).repeat_interleave(l)
        if ctx is not None:
            kk = torch.cat([kk, ck[:, fr]], 2)
            vv = torch.cat([vv, cv[:, fr]], 2)
            if bias is not None:
                bias = torch.cat([bias, bias.new_zeros(ck.shape[2])])
        o = attention(q5[:, fr].reshape(b * len(fr), -1, d), kk.reshape(b * len(fr), -1, d),
                      vv.reshape(b * len(fr), -1, d), heads, fp8, bias=bias)
        out[:, fr] = o.reshape(b, len(fr), -1, d)
    return out.reshape(bf, -1, d)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding, cos half first (diffusers flip_sin_to_cos=True,
    freq_shift=0), fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                         device=t.device) / half)
    e = t.float().reshape(-1, 1) * freqs[None]
    return torch.cat([torch.cos(e), torch.sin(e)], -1)


def instance_norm(x, dims, eps: float = 1e-5):
    """Biased normalization over ``dims`` with eps, fp32 (``in_stats``)."""
    x = in_stats(x)
    var, mean = torch.var_mean(x, dim=dims, unbiased=False, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


def adain(cnt, sty, norm_dims, stat_dims):
    """``instance_norm(cnt) * std(sty) + mean(sty)``: the method's AdaIN with
    torch's unbiased std for the style statistics, fp32 (``in_stats``)."""
    sty = in_stats(sty)
    return (instance_norm(cnt, norm_dims) * torch.std(sty, dim=stat_dims, keepdim=True)
            + sty.mean(dim=stat_dims, keepdim=True))


def shift_beta(i: int, m: dict) -> float:
    """The K/V blend weight at step ``i``: linear from ``beta_max`` at
    ``eta1 * N`` to ``beta_min`` at ``eta2 * N`` (N = 50 in every
    backbone's constants)."""
    n = m["shift_steps"]
    slope = (m["beta_max"] - m["beta_min"]) / (m["eta1"] * n - m["eta2"] * n)
    return float(np.float32(slope * (i - m["eta2"] * n) + m["beta_min"]))


def resize_mask(mask, h: int, w: int):
    """``[F, H, W]`` mask -> ``[F, 1, h, w]``, bilinear with antialiasing."""
    return F.interpolate(mask.float()[:, None], size=(h, w), mode="bilinear",
                         align_corners=False, antialias=True)
