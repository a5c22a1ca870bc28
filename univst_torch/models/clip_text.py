"""CLIP text encoder + tokenizer — port of ``univst_tpu/models/clip_text.py``.

The SD runners build ``CLIPTextModel`` + ``CLIPTokenizer``
(src/sd/run_content_inversion_sd.py:39-40); SD3 adds CLIP-L with its
projection and the OpenCLIP bigG encoder (text_encoder_2). Attribute names follow
transformers' ``CLIPTextModel`` keys (``text_model.*``), so its checkpoints
load with ``strict=True``. Every prompt the reference CLIs encode is the
empty string, which the tokenizer handles without vocab files.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BOS_TOKEN = 49406
EOS_TOKEN = 49407
MAX_LEN = 77


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_positions: int = MAX_LEN
    intermediate_size: int = 3072
    hidden_act: str = "quick_gelu"  # SD-2.1 uses "gelu"
    projection_dim: Optional[int] = None  # text_projection; None for CLIPTextModel

    @staticmethod
    def sd15(**kw) -> "CLIPTextConfig":
        return CLIPTextConfig(**kw)

    @staticmethod
    def sd21(**kw) -> "CLIPTextConfig":
        return CLIPTextConfig(hidden_size=1024, num_layers=23, num_heads=16,
                              intermediate_size=4096, hidden_act="gelu", **kw)

    @staticmethod
    def sd3_clip_l(**kw) -> "CLIPTextConfig":
        return CLIPTextConfig(projection_dim=768, **kw)

    @staticmethod
    def sd3_clip_g(**kw) -> "CLIPTextConfig":
        return CLIPTextConfig(hidden_size=1280, num_layers=32, num_heads=20,
                              intermediate_size=5120, hidden_act="gelu", projection_dim=1280,
                              **kw)

    @staticmethod
    def tiny(**kw) -> "CLIPTextConfig":
        # full vocab so the real BOS/EOS token ids stay in range
        return CLIPTextConfig(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64, **kw)


def _act(name: str, x):
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return F.gelu(x)
    raise ValueError(name)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x):
        b, l, d = x.shape
        h = self.num_heads

        def split(t):
            return t.reshape(b, l, h, d // h).transpose(1, 2)

        out = F.scaled_dot_product_attention(
            split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x)), is_causal=True)
        return self.out_proj(out.transpose(1, 2).reshape(b, l, d))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.act = cfg.hidden_act
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(_act(self.act, self.fc1(x)))


class CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.mlp = CLIPMLP(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=1e-5)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_positions, cfg.hidden_size)
        # persisted by the released checkpoints (older transformers)
        self.register_buffer("position_ids", torch.arange(cfg.max_positions)[None])

    def forward(self, ids):
        return self.token_embedding(ids) + self.position_embedding.weight[None, : ids.shape[1]]


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPLayer(cfg) for _ in range(cfg.num_layers)])


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)


class CLIPTextModel(nn.Module):
    """Returns (hidden_state, pooled) like transformers'
    CLIPTextModel[WithProjection].

    ``hidden_state_index`` indexes the ``output_hidden_states`` list
    (embeddings output + each layer's output, no final LayerNorm): ``None``
    returns the final-LayerNormed last layer (what SD-1.5/2.1 consume),
    ``-2`` the penultimate un-normed state that diffusers' SD3
    ``encode_prompt`` takes (``clip_skip=k`` -> ``-(k + 2)``). The pooled
    output is always the final-normed state at the first EOS (projected when
    ``projection_dim`` is set)."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.text_model = CLIPTextTransformer(cfg)
        if cfg.projection_dim is not None:
            self.text_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False)

    def forward(self, input_ids, hidden_state_index: Optional[int] = None):
        tm = self.text_model
        x = tm.embeddings(input_ids)
        hidden_states = [x]
        for layer in tm.encoder.layers:
            x = layer(x)
            hidden_states.append(x)
        x = tm.final_layer_norm(x)
        eos_pos = (input_ids == EOS_TOKEN).int().argmax(dim=1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eos_pos]
        if self.cfg.projection_dim is not None:
            pooled = self.text_projection(pooled)
        return (x if hidden_state_index is None else hidden_states[hidden_state_index]), pooled


class Tokenizer:
    """CLIP tokenizer (reference surface: arbitrary ``--prompt`` strings).

    * With ``hf_dir`` pointing at a checkpoint's ``tokenizer`` folder, the
      native :class:`~univst_torch.models.bpe.ClipBPE` reads its
      ``vocab.json``/``merges.txt``.
    * Without it, the empty prompt keeps its exact encoding
      ([BOS, EOS, EOS, ...]; CLIP pads with EOS), and other prompts use the
      synthetic real-structure byte-level vocabulary (valid ids, meaningful
      only with synthetic weights — a one-time notice says so).
    """

    def __init__(self, hf_dir: Optional[str] = None, max_len: int = MAX_LEN):
        self.max_len = max_len
        self._bpe = None
        self._warned = False
        if hf_dir is not None:
            from univst_torch.models.bpe import ClipBPE

            self._bpe = ClipBPE.from_dir(hf_dir)

    def __call__(self, prompts) -> np.ndarray:
        if isinstance(prompts, str):
            prompts = [prompts]
        if self._bpe is None and any(p.strip() for p in prompts):
            from univst_torch.models.bpe import ClipBPE

            self._bpe = ClipBPE.synthetic()
            if not self._warned:
                print("[tokenizer] no checkpoint vocab — non-empty prompts use the synthetic "
                      "byte-level CLIP vocabulary (structurally valid ids; pass "
                      "--pretrained_model_path for real-checkpoint token ids)", flush=True)
                self._warned = True
        if self._bpe is not None:
            return self._bpe(prompts, max_len=self.max_len)
        row = [BOS_TOKEN, EOS_TOKEN] + [EOS_TOKEN] * (self.max_len - 2)
        return np.asarray([row for _ in prompts], np.int32)
