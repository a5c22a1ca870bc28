"""Point-matching mask propagation — port of
``univst_tpu/methods/mask_propagation.py``.

Rebuild of src/mask_propagation.py:15-155: propagate a first-frame one-hot
mask across frames by top-k-filtered cosine affinity over cached UNet decoder
features, with an anchor set of {first frame} + a ring of the 9 previous
frames' subsampled (feature, seg) pairs. Fixed-capacity banks with validity
masks replace the reference's queue of variable-length tensors; invalid
anchors get exp(-inf) = 0 affinity.

Subsampling ranks positions by uniform random scores. torch cannot draw the
JAX package's ``jax.random`` numbers, so :func:`propagate_masks` takes a
``torch.Generator`` or an explicit ``scores`` tensor (the parity tests feed
both implementations the same draw).

Under a frame-parallel mesh the propagation stays whole: its ring of
previous frames is sequential, so it runs on the gathered ``[F, T, C]``
features (the pipeline gathers the captured feature), and the stylization
takes the masks back as each rank's shard (``SDVideoPipeline._shard``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class MaskPropConfig:
    """Hyper-parameters (reference CLI defaults, mask_propagation.py:143-147)."""

    temperature: float = 0.2
    n_last_frames: int = 9
    topk: int = 15
    sample_ratio: float = 0.3


def _l2norm(x, dim):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True), min=1e-12)


def _propagate_one(feat_src, segs_src, src_valid, feat_tgt, cfg: MaskPropConfig):
    """One frame's propagation (reference ``mask_propogation``, :72-83).

    feat_src [S, C], segs_src [n_cls, S], src_valid [S] bool, feat_tgt [T, C];
    returns segs_tgt [n_cls, T].
    """
    fs = _l2norm(feat_src.float(), 1)
    ft = _l2norm(feat_tgt.float(), 1)
    logits = fs @ ft.T  # [S, T]
    logits = torch.where(src_valid[:, None], logits / cfg.temperature,
                         torch.tensor(float("-inf"), device=logits.device))
    aff = torch.exp(logits)
    # per-target top-k floor (affinity below the k-th largest source -> 0)
    tk_min = torch.topk(aff.T, cfg.topk, dim=1).values[:, -1]
    aff = torch.where(aff < tk_min[None, :], torch.zeros_like(aff), aff)
    aff = aff / torch.clamp(aff.sum(dim=0, keepdim=True), min=1e-12)
    return segs_src.float() @ aff


def _class_rank(mask, score):
    """Rank of each position among the members of ``mask`` by score."""
    t = score.shape[0]
    order = torch.argsort(torch.where(mask, score, torch.full_like(score, 2.0)), stable=True)
    rank = torch.empty(t, dtype=torch.long, device=score.device)
    rank[order] = torch.arange(t, device=score.device)
    return rank


def _subsample(segs_tgt, score, capacity: int, cfg: MaskPropConfig):
    """Class-proportional random subsampling (reference :86-99).

    'fore' = positions with nonzero class-0 mass, as the reference computes
    it. ``score`` is one uniform draw per position. Returns (indices
    [capacity], valid [capacity]).
    """
    t = segs_tgt.shape[1]
    is_fore = segs_tgt[0] != 0
    n_f = is_fore.sum()
    n_b = t - n_f
    k_f = torch.floor(n_f.float() ** 2 / float(t) * cfg.sample_ratio).long()
    k_b = torch.floor(n_b.float() ** 2 / float(t) * cfg.sample_ratio).long()
    sel = torch.where(is_fore, _class_rank(is_fore, score) < k_f,
                      _class_rank(~is_fore, score) < k_b)
    order = torch.argsort(torch.where(sel, score, torch.full_like(score, 3.0)), stable=True)
    idx = order[:capacity]
    valid = torch.arange(capacity, device=score.device) < torch.clamp(sel.sum(), max=capacity)
    return idx, valid


def propagate_masks(features, first_seg, cfg: MaskPropConfig = MaskPropConfig(),
                    generator: Optional[torch.Generator] = None,
                    scores: Optional[torch.Tensor] = None):
    """Propagate the first-frame one-hot seg across all frames.

    Args:
      features: ``[F, T, C]`` per-frame flattened decoder features (T = h*w).
      first_seg: ``[n_cls, T]`` one-hot first-frame segmentation.
      generator: draws the anchor-subsampling scores when ``scores`` is None.
      scores: optional ``[F-1, T]`` uniform [0, 1) scores, one row per frame.
    Returns ``[F-1, n_cls, T]`` soft segs for frames 1..F-1.
    """
    f, t, c = features.shape
    dev = features.device
    n_cls = first_seg.shape[0]
    capacity = int(t * cfg.sample_ratio) + 1
    q = cfg.n_last_frames
    if scores is None:
        scores = torch.rand((f - 1, t), generator=generator, device=dev)
    scores = scores.to(dev, torch.float32)

    feat_bank = torch.zeros((q, capacity, c), dtype=features.dtype, device=dev)
    seg_bank = torch.zeros((q, n_cls, capacity), dtype=torch.float32, device=dev)
    valid_bank = torch.zeros((q, capacity), dtype=torch.bool, device=dev)
    first_valid = torch.ones(t, dtype=torch.bool, device=dev)
    segs = []
    for j in range(f - 1):
        feat_tgt = features[j + 1]
        feat_src = torch.cat([features[0], feat_bank.reshape(q * capacity, c)])
        segs_src = torch.cat(
            [first_seg.float(), seg_bank.transpose(0, 1).reshape(n_cls, q * capacity)], dim=1)
        src_valid = torch.cat([first_valid, valid_bank.reshape(q * capacity)])
        segs_tgt = _propagate_one(feat_src, segs_src, src_valid, feat_tgt, cfg)
        idx, valid = _subsample(segs_tgt, scores[j], capacity, cfg)
        slot = j % q
        feat_bank[slot] = feat_tgt[idx]
        seg_bank[slot] = segs_tgt[:, idx]
        valid_bank[slot] = valid
        segs.append(segs_tgt)
    return torch.stack(segs)


def norm_mask(masks):
    """Per-class min-max normalization (reference norm_mask, :114-123);
    masks ``[..., n_cls, H, W]``."""
    mn = masks.amin(dim=(-2, -1), keepdim=True)
    mx = masks.amax(dim=(-2, -1), keepdim=True)
    normed = (masks - mn) / torch.clamp(mx - mn, min=1e-12)
    # reference guards on the channel's (pre-shift) max being > 0
    return torch.where(mx > 0, normed, masks)


def to_one_hot(seg, n_classes: int):
    """[H, W] integer labels -> [n_cls, H*W] float one-hot (reference :126-138)."""
    flat = torch.as_tensor(seg).reshape(-1).long()
    return F.one_hot(flat, n_classes).float().T


def upsample_labels(segs, feat_hw: Tuple[int, int], out_hw: Tuple[int, int]):
    """[F-1, n_cls, T] -> [F-1, H, W] uint8 argmax label maps (reference
    :60-65: bilinear upsample, per-class min-max norm, argmax)."""
    fh, fw = feat_hw
    m = segs.reshape(segs.shape[0], -1, fh, fw).float()
    m = F.interpolate(m, size=tuple(out_hw), mode="bilinear", align_corners=False,
                      antialias=True)
    return torch.argmax(norm_mask(m), dim=1).to(torch.uint8)


def upsample_and_binarize(segs, feat_hw: Tuple[int, int], out_hw: Tuple[int, int]):
    """[F-1, n_cls, T] -> [F-1, H, W] uint8 {0, 255} masks (reference :60-69)."""
    labels = upsample_labels(segs, feat_hw, out_hw)
    return torch.where(labels != 0, 255, 0).to(torch.uint8)
