"""Native CLIP byte-level BPE tokenizer (no transformers dependency); the
port's own copy of ``univst_tpu/models/bpe.py``.

The reference passes arbitrary ``--prompt`` strings into HF tokenizers whose
vocab files ship with the released checkpoints (run_content_inversion_sd.py:39,
sd3 custom pipelines). This module covers them without transformers:

  * :class:`ClipBPE` implements the full CLIP BPE algorithm — GPT-2 byte
    encoder, lowercase/whitespace cleanup, the CLIP regex split, greedy
    lowest-rank merges with the ``</w>`` word suffix — and loads the real
    ``vocab.json`` + ``merges.txt`` when a checkpoint's tokenizer dir is
    present, producing ids identical to transformers' ``CLIPTokenizer``
    (tests/test_bpe.py pins the JAX package's copy to transformers, and
    tests/test_torch_models.py pins this one to it).
  * :meth:`ClipBPE.synthetic` builds a vocabulary with the REAL CLIP vocab's
    structural layout (ids 0-255 byte symbols, 256-511 byte+``</w>``,
    specials at 49406/49407, size 49408) but no merge table. Offline, any
    prompt tokenizes to valid in-range ids; single-character words even get
    their true CLIP ids (the byte region of the real vocab is identical).
    With synthetic (random) model weights — the only weights available
    offline — structural correctness is all the ids can mean.

The vocab layout mirrors OpenAI's released BPE: 256 byte tokens + 256
``</w>`` byte tokens + 48894 merge tokens + 2 specials = 49408.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

BOS = "<|startoftext|>"
EOS = "<|endoftext|>"
CLIP_VOCAB_SIZE = 49408
_N_MERGES = CLIP_VOCAB_SIZE - 2 * 256 - 2  # 48894


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte<->unicode table (printable ranges kept,
    the rest remapped above U+0100) — the standard byte-level BPE alphabet."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _get_pairs(word: Tuple[str, ...]):
    return {(a, b) for a, b in zip(word, word[1:])}


def _whitespace_clean(text: str) -> str:
    import regex as re

    return re.sub(r"\s+", " ", text).strip()


def _basic_clean(text: str) -> str:
    """transformers' ftfy-absent path: BasicTokenizer(strip_accents=False,
    do_split_on_punc=False) — control-char removal, CJK spacing, NFC,
    lowercase, whitespace re-join (tokenization_clip.py:459-463 with the
    BasicTokenizer defaults CLIPTokenizer passes)."""
    import unicodedata

    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or unicodedata.category(ch).startswith("C") and ch not in "\t\n\r":
            continue
        out.append(" " if ch in "\t\n\r" or unicodedata.category(ch) == "Zs" else ch)
    text = "".join(out)
    spaced = []
    for ch in text:
        cp = ord(ch)
        if (
            0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
        ):
            spaced += [" ", ch, " "]
        else:
            spaced.append(ch)
    text = unicodedata.normalize("NFC", "".join(spaced))
    return " ".join(t.lower() for t in text.split())


class ClipBPE:
    """CLIP byte-level BPE. ``encoder`` maps token string -> id; ``ranks``
    maps merge pairs -> priority (lower merges first)."""

    def __init__(self, encoder: Dict[str, int],
                 ranks: Dict[Tuple[str, str], int]):
        self.encoder = encoder
        self.ranks = ranks
        self.byte_encoder = bytes_to_unicode()
        self.bos_id = encoder[BOS]
        self.eos_id = encoder[EOS]
        self.unk_id = self.eos_id  # CLIP's unk == eos
        self._cache: Dict[str, List[str]] = {BOS: [BOS], EOS: [EOS]}
        import regex as re

        self._pat = re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
            r"""|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
            re.IGNORECASE,
        )

    # -- construction -------------------------------------------------------

    @classmethod
    def from_dir(cls, path: str) -> "ClipBPE":
        """Load ``vocab.json`` + ``merges.txt`` (HF checkpoint tokenizer
        layout). The merges slice [1 : 48895] matches transformers
        (tokenization_clip.py:313: header line dropped, table truncated to
        the vocab's merge capacity)."""
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            encoder = json.load(f)
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            lines = f.read().strip().split("\n")[1: _N_MERGES + 1]
        ranks = {tuple(m.split()): i for i, m in enumerate(lines)}
        return cls(encoder, ranks)

    @classmethod
    def synthetic(cls) -> "ClipBPE":
        """Real-structure vocabulary without a merge table (see module doc)."""
        syms = list(bytes_to_unicode().values())
        encoder = {s: i for i, s in enumerate(syms)}
        encoder.update({s + "</w>": 256 + i for i, s in enumerate(syms)})
        for i in range(_N_MERGES):
            encoder[f"<|merge_{i}|>"] = 512 + i
        encoder[BOS] = CLIP_VOCAB_SIZE - 2
        encoder[EOS] = CLIP_VOCAB_SIZE - 1
        return cls(encoder, {})

    # -- algorithm -----------------------------------------------------------

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        if len(word) == 1:
            self._cache[token] = [token + "</w>"]
            return self._cache[token]
        pairs = _get_pairs(word)
        while pairs:
            bigram = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if bigram not in self.ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = list(word)
        self._cache[token] = out
        return out

    def tokenize(self, text: str) -> List[int]:
        """Token ids for ``text`` WITHOUT specials (the ftfy-absent
        transformers pipeline: BasicTokenizer cleanup, regex split, byte
        encode, BPE)."""
        text = _whitespace_clean(_basic_clean(text))
        ids: List[int] = []
        for token in self._pat.findall(text):
            mapped = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(
                self.encoder.get(t, self.unk_id) for t in self._bpe(mapped)
            )
        return ids

    def __call__(self, prompts: Sequence[str] | str,
                 max_len: int = 77) -> np.ndarray:
        """[B, max_len] int32 ids: BOS + tokens + EOS, truncated to fit,
        padded with EOS (CLIP's pad token)."""
        if isinstance(prompts, str):
            prompts = [prompts]
        rows = []
        for p in prompts:
            body = self.tokenize(p)[: max_len - 2]
            row = [self.bos_id] + body + [self.eos_id]
            row += [self.eos_id] * (max_len - len(row))
            rows.append(row)
        return np.asarray(rows, np.int32)


def t5_byte_fallback_ids(prompts: Sequence[str] | str, max_len: int,
                         eos_id: int = 1, pad_id: int = 0) -> np.ndarray:
    """Structural offline fallback for T5 prompts: utf-8 bytes mapped into
    the low sentencepiece id range (3 + byte — ids 0/1/2 are pad/eos/unk).
    T5's real vocab is a trained sentencepiece model that cannot be
    reconstructed offline; with synthetic weights only well-formed ids
    matter. Real checkpoints load T5TokenizerFast instead (t5.py)."""
    if isinstance(prompts, str):
        prompts = [prompts]
    rows = []
    for p in prompts:
        body = [3 + b for b in p.encode("utf-8")][: max_len - 1]
        row = body + [eos_id]
        row += [pad_id] * (max_len - len(row))
        rows.append(row)
    return np.asarray(rows, np.int32)
