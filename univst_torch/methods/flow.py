"""Optical flow, warping, occlusion masking and sliding-window smoothing —
port of ``univst_tpu/methods/flow.py``.

Rebuild of src/cal_optica_flow.py:15-99 and of the sliding-window pixel
smoother inside the stylization loop (stable_diffusion.py:713-758, shipped
disabled by the reference). The flow estimator is pluggable: a
``flow_fn(img1, img2) -> flow`` on ``[N, H, W, C]`` batches; the built-in
one is a coarse-to-fine iterative Lucas-Kanade pyramid, and
``univst_torch.models.raft.make_raft_flow`` plugs RAFT in behind the same
interface.

Under a mesh the smoother runs on a rank's frames (``sliding_window_smooth``'s
``shard``): one all-to-all brings the +/-radius frames its keys read, and
the rank runs only its own keys' flows.

The API keeps the JAX package's layout: images ``[H, W, C]`` (or ``[H, W]``
gray) fp32 in [0, 1], flow ``[H, W, 2]`` holding (dx, dy) pixel offsets
(sampling position = grid + flow, cal_optica_flow.py:31-41); each function
also takes a leading batch axis. Inside, everything is NCHW and the
bilinear gathers are ``grid_sample``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F


def _sample(images, sx, sy):
    """Bilinear samples of ``images [N, C, H, W]`` at pixel positions
    ``sx, sy [N, H', W']``; every corner outside the image reads 0 (as
    ``map_coordinates(order=1, mode='constant')`` does). Pixel x is
    normalized as (2x + 1) / w - 1 for ``align_corners=False``, which keeps
    the call off cuDNN's sampler (see ``models/raft.py::_corr_lookup``)."""
    h, w = images.shape[-2:]
    grid = torch.stack([(2.0 * sx + 1.0) / w - 1.0, (2.0 * sy + 1.0) / h - 1.0], dim=-1)
    return F.grid_sample(images, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=False)


def warp_image_with_flow(image, flow):
    """Backward warp: out(x, y) = image(x + dx, y + dy), bilinear, zeros
    outside (reference warp_image_with_flow, cal_optica_flow.py:31-41).
    ``image [..., H, W, C]`` or ``[..., H, W]``, ``flow [..., H, W, 2]``."""
    gray = image.dim() == flow.dim() - 1
    lead = flow.shape[:-3]
    h, w = flow.shape[-3:-1]
    img = image[..., None] if gray else image
    img = img.reshape((-1,) + img.shape[-3:]).permute(0, 3, 1, 2)
    fl = flow.reshape(-1, h, w, 2)
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=flow.device),
                            torch.arange(w, dtype=torch.float32, device=flow.device),
                            indexing="ij")
    out = _sample(img, gx + fl[..., 0], gy + fl[..., 1]).permute(0, 2, 3, 1)
    out = out.reshape(lead + out.shape[1:])
    return out[..., 0] if gray else out


def compute_occlusion_mask(forward_flow, backward_flow, threshold: float = 1.5):
    """Forward-backward consistency occlusion mask, 1 = occluded (reference
    compute_occlusion_mask, cal_optica_flow.py:20-29). The reference reads
    the backward flow at the original grid, not at the forward-warped
    positions, so the error is ||fwd + bwd|| (cal_optica_flow.py:24-26);
    kept as is."""
    err = torch.linalg.vector_norm(forward_flow + backward_flow, dim=-1)
    return (err > threshold).float()


def apply_occlusion(warped, occlusion, original):
    """Occluded pixels fall back to the reference frame (reference
    apply_mask, cal_optica_flow.py:43-46)."""
    m = occlusion[..., None]
    return warped * (1.0 - m) + original * m


def get_warp(flow_fn: Callable, image1, image2, ref_image1=None, ref_image2=None,
             threshold: float = 1.5):
    """Bidirectional flow, then ref2 warped onto frame 1's geometry with the
    occluded pixels taken from ref1 (reference get_warp,
    cal_optica_flow.py:51-99). Both directions go to ``flow_fn`` as one
    batch; unbatched ``[H, W, C]`` images are accepted."""
    ref_image1 = image1 if ref_image1 is None else ref_image1
    ref_image2 = image2 if ref_image2 is None else ref_image2
    single = image1.dim() == 3
    if single:
        image1, image2 = image1[None], image2[None]
        ref_image1, ref_image2 = ref_image1[None], ref_image2[None]
    n = image1.shape[0]
    flows = flow_fn(torch.cat([image1, image2]), torch.cat([image2, image1]))
    fwd, bwd = flows[:n], flows[n:]
    occ = compute_occlusion_mask(fwd, bwd, threshold)
    out = apply_occlusion(warp_image_with_flow(ref_image2, fwd), occ, ref_image1)
    return out[0] if single else out


# ---------------------------------------------------------------------------
# Built-in flow estimator: coarse-to-fine iterative Lucas-Kanade
# ---------------------------------------------------------------------------


_GRAY = (0.299, 0.587, 0.114)


def _to_gray(img):
    """[N, H, W, C] -> [N, H, W]."""
    return img @ torch.tensor(_GRAY, dtype=img.dtype, device=img.device)


def _downsample2(img):
    """2x2 mean of [N, H, W]; an odd last row or column is dropped."""
    n, h, w = img.shape
    h2, w2 = h // 2, w // 2
    return img[:, :h2 * 2, :w2 * 2].reshape(n, h2, 2, w2, 2).mean(dim=(2, 4))


def _upsample2(flow, shape):
    """[N, h, w, 2] flow -> [N, H, W, 2], bilinear (half-pixel centers, as
    ``jax.image.resize``), the offsets doubled."""
    up = F.interpolate(flow.permute(0, 3, 1, 2), size=tuple(shape), mode="bilinear",
                       align_corners=False)
    return up.permute(0, 2, 3, 1) * 2.0


def _lk_refine(i1, i2, flow, window: int = 7, iters: int = 3, eps: float = 1e-3):
    """Iterative Lucas-Kanade refinement at one pyramid level; ``i1, i2
    [N, H, W]``, ``flow [N, H, W, 2]``. The window sum is a zero-padded
    ``window x window`` mean (``convolve2d(mode='same')`` of a box)."""
    gy, gx = torch.gradient(i1, dim=(1, 2))

    def box(x):
        return F.avg_pool2d(x[:, None], window, stride=1, padding=window // 2,
                            count_include_pad=True)[:, 0]

    a11 = box(gx * gx) + eps
    a12 = box(gx * gy)
    a22 = box(gy * gy) + eps
    det = a11 * a22 - a12 * a12
    for _ in range(iters):
        it = warp_image_with_flow(i2, flow) - i1
        b1 = box(gx * it)
        b2 = box(gy * it)
        du = -(a22 * b1 - a12 * b2) / det
        dv = -(-a12 * b1 + a11 * b2) / det
        flow = flow + torch.stack([du, dv], dim=-1)
    return flow


def lucas_kanade_flow(image1, image2, levels: int = 4, window: int = 7, iters: int = 3):
    """Pyramidal LK flow between two images: ``[H, W, C]`` (or ``[H, W]``
    gray) -> ``[H, W, 2]``, or a batch ``[N, H, W, C]`` -> ``[N, H, W, 2]``.
    The pyramid stops at ``levels`` or once a side is at most 32."""
    single = image1.dim() < 4
    i1, i2 = image1.float(), image2.float()
    if single:
        i1, i2 = i1[None], i2[None]
    if i1.dim() == 4:
        i1, i2 = _to_gray(i1), _to_gray(i2)
    pyr1, pyr2 = [i1], [i2]
    for _ in range(levels - 1):
        if min(pyr1[-1].shape[1:]) <= 32:
            break
        pyr1.append(_downsample2(pyr1[-1]))
        pyr2.append(_downsample2(pyr2[-1]))
    flow = torch.zeros(pyr1[-1].shape + (2,), dtype=torch.float32, device=i1.device)
    for l1, l2 in zip(reversed(pyr1), reversed(pyr2)):
        if flow.shape[1:3] != l1.shape[1:]:
            flow = _upsample2(flow, l1.shape[1:])
        flow = _lk_refine(l1, l2, flow, window, iters)
    return flow[0] if single else flow


# ---------------------------------------------------------------------------
# Sliding-window consistent smoothing
# ---------------------------------------------------------------------------


def _frame_window(frames, shard, radius: int):
    """A rank's frames with the +/-``radius`` frames around its shard that
    its keys read, clipped to the clip: one all-to-all (``comm.frame_halo``,
    site ``smooth_halo``) brings the global frames ``[o - radius, o)`` and
    ``[o + f, o + f + radius)`` from whichever ranks hold them (more than
    one neighbour when ``f < radius``). Returns the ``[lo, hi)`` window of
    global frames and ``lo``."""
    from univst_torch.distributed.comm import frame_halo

    n, f, nf, off = shard.mesh.n_data, shard.local, shard.num_frames, shard.offset

    def reads(o):
        return tuple(g for g in (*range(o - radius, o), *range(o + f, o + f + radius))
                     if 0 <= g < nf)

    got = frame_halo(frames[None], shard, [reads(r * f) for r in range(n)], "smooth_halo")[0]
    before = sum(1 for g in reads(off) if g < off)
    return torch.cat([got[:before], frames, got[before:]]), off - before


def sliding_window_smooth(frames, flow_fn: Callable = lucas_kanade_flow, radius: int = 2,
                          mask: Optional[torch.Tensor] = None, shard=None):
    """Sliding-window warp-and-average over frames (reference smoother,
    stable_diffusion.py:716-751).

    Each key frame averages itself and every frame within +/-radius warped
    onto it by flow (occluded pixels from the key frame). All the window's
    pairs go to ``flow_fn`` as one batch (both directions: 2 x pairs flows);
    the sum runs frame offset by frame offset from -radius, as the
    reference's loop adds. With a mask ``[F, H, W]`` (1 = keep), the masked
    object region keeps the original frames (stable_diffusion.py:751).

    ``frames [F, H, W, C]`` in [0, 1] -> ``[F, H, W, C]``.

    Under a frame ``shard`` (a ``distributed.comm.FrameShard``) ``frames``
    and ``mask`` are the rank's ``f`` frames of the clip and the result is
    the rank's: the +/-radius frames its keys read come from the other
    ranks in one all-to-all (:func:`_frame_window`), the rank runs the
    flows of its own keys' pairs only (``0 <= k + b < F`` in global frames),
    and each key's divisor is its window at its global position (the clip's
    edges truncate a window, a rank's edges do not).
    """
    f, dev = frames.shape[0], frames.device
    nf, off = (f, 0) if shard is None else (shard.num_frames, shard.offset)
    window = range(-radius, radius + 1)
    # ext[g - lo] is global frame g
    ext, lo = (frames, 0) if shard is None else _frame_window(frames, shard, radius)
    keys = {b: [k for k in range(off, off + f) if 0 <= k + b < nf] for b in window if b}
    pairs = [(k, k + b) for b, ks in keys.items() for k in ks]
    if pairs:
        key = torch.tensor([k - lo for k, _ in pairs], device=dev)
        now = torch.tensor([j - lo for _, j in pairs], device=dev)
        warped = get_warp(flow_fn, ext[key], ext[now], ext[key], ext[now])
    acc, start = torch.zeros_like(frames), 0
    for b in window:
        if b == 0:
            acc = acc + frames
        elif keys[b]:
            n = len(keys[b])
            acc = acc.index_add(0, torch.tensor([k - off for k in keys[b]], device=dev),
                                warped[start:start + n])
            start += n
    weight = torch.tensor([sum(0 <= k + b < nf for b in window) for k in range(off, off + f)],
                          dtype=frames.dtype, device=dev)
    smoothed = acc / weight[:, None, None, None]
    if mask is not None:
        m = mask[..., None].to(frames.dtype)
        smoothed = frames * m + smoothed * (1.0 - m)
    return smoothed
