"""T5 text encoder for SD3/SD3.5 — port of ``univst_tpu/models/t5.py``
(the reference loads T5-XXL as text_encoder_3 through diffusers'
StableDiffusion3Pipeline).

Standard T5-v1.1 encoder: RMS layer norm (no mean subtraction), a relative
position bias computed once from layer 0's table and shared by all layers,
unscaled attention, gated-gelu (tanh) MLP, no biases. Attribute names follow
transformers' ``T5EncoderModel`` keys (``shared`` and
``encoder.embed_tokens`` are one tied table, as in the released
checkpoints), so its state dicts load with ``strict=True``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

T5_EOS = 1
T5_PAD = 0


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    head_dim: int = 64
    rel_buckets: int = 32
    rel_max_distance: int = 128

    @staticmethod
    def xxl(**kw) -> "T5Config":
        return T5Config(**kw)

    @staticmethod
    def tiny(**kw) -> "T5Config":
        base = dict(d_model=32, d_ff=64, num_layers=2, num_heads=2, head_dim=16)
        base.update(kw)
        return T5Config(**base)


def _rel_bucket(rel_pos: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    """Bidirectional relative position bucketing (HF T5
    _relative_position_bucket), with the log in fp32."""
    num_buckets //= 2
    ret = (rel_pos > 0).to(torch.int64) * num_buckets
    n = rel_pos.abs()
    max_exact = num_buckets // 2
    val_large = max_exact + (torch.log(n.float() / max_exact + 1e-9)
                             / math.log(max_distance / max_exact)
                             * (num_buckets - max_exact)).to(torch.int64)
    val_large = torch.clamp(val_large, max=num_buckets - 1)
    return ret + torch.where(n < max_exact, n, val_large)


class T5RMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        xf = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + 1e-6)
        return (xf * self.weight.float()).to(x.dtype)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        inner = cfg.num_heads * cfg.head_dim
        self.cfg = cfg
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        if has_bias:
            self.relative_attention_bias = nn.Embedding(cfg.rel_buckets, cfg.num_heads)

    def forward(self, x, bias):
        c = self.cfg
        b, l, _ = x.shape

        def split(y):
            return y.reshape(b, l, c.num_heads, c.head_dim).transpose(1, 2)

        q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))
        # unscaled (T5 folds the scale into its init); fp32 logits and softmax
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) + bias
        o = torch.matmul(torch.softmax(logits, dim=-1).to(v.dtype), v)
        return self.o(o.transpose(1, 2).reshape(b, l, -1))


class _SelfAttentionLayer(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_bias)
        self.layer_norm = T5RMSNorm(cfg.d_model)


class _DenseGatedGelu(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, h):
        return self.wo(F.gelu(self.wi_0(h), approximate="tanh") * self.wi_1(h))


class _FFLayer(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = _DenseGatedGelu(cfg)
        self.layer_norm = T5RMSNorm(cfg.d_model)


class _Block(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        self.layer = nn.ModuleList([_SelfAttentionLayer(cfg, has_bias), _FFLayer(cfg)])

    def forward(self, x, bias):
        attn, ff = self.layer
        x = x + attn.SelfAttention(attn.layer_norm(x), bias)
        return x + ff.DenseReluDense(ff.layer_norm(x))


class _Stack(nn.Module):
    def __init__(self, cfg: T5Config, shared: nn.Embedding):
        super().__init__()
        self.embed_tokens = shared
        self.block = nn.ModuleList([_Block(cfg, i == 0) for i in range(cfg.num_layers)])
        self.final_layer_norm = T5RMSNorm(cfg.d_model)


class T5Encoder(nn.Module):
    """ids ``[B, L]`` -> final-normed hidden states ``[B, L, d_model]``."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = _Stack(cfg, self.shared)

    def forward(self, input_ids):
        c = self.cfg
        enc = self.encoder
        x = enc.embed_tokens(input_ids)
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        buckets = _rel_bucket(pos[None, :] - pos[:, None], c.rel_buckets, c.rel_max_distance)
        table = enc.block[0].layer[0].SelfAttention.relative_attention_bias.weight
        bias = table.float()[buckets].permute(2, 0, 1)[None]  # [1, H, L, L], shared by all layers
        for blk in enc.block:
            x = blk(x, bias)
        return enc.final_layer_norm(x)


class T5TokenizerShim:
    """Null-prompt tokenizer ([</s>, pad, ...]); with a checkpoint's
    ``tokenizer_3`` folder, transformers' T5TokenizerFast; other prompts
    without one take the byte fallback of ``models/bpe.py`` (valid ids for
    synthetic weights only)."""

    def __init__(self, hf_dir: Optional[str] = None, max_len: int = 256):
        self.max_len = max_len
        self._tok = None
        if hf_dir is not None:
            from transformers import T5TokenizerFast

            self._tok = T5TokenizerFast.from_pretrained(hf_dir)

    def __call__(self, prompts) -> np.ndarray:
        if isinstance(prompts, str):
            prompts = [prompts]
        if self._tok is not None:
            out = self._tok(prompts, padding="max_length", max_length=self.max_len,
                            truncation=True, return_tensors="np")
            return out["input_ids"].astype(np.int32)
        if any(p.strip() for p in prompts):
            from univst_torch.models.bpe import t5_byte_fallback_ids

            return t5_byte_fallback_ids(prompts, self.max_len, eos_id=T5_EOS, pad_id=T5_PAD)
        return np.asarray([[T5_EOS] + [T5_PAD] * (self.max_len - 1) for _ in prompts], np.int32)
