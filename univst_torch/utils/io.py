"""Host-side image/video/mask I/O (PIL + imageio), the port's own copy of
``univst_tpu/utils/io.py``.

Mirrors the reference I/O surface (src/util.py) with identical file naming
(``%05d.png`` frames) and value conventions, and returns frames-leading
channels-last numpy arrays.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
from PIL import Image


def seed_everything(seed: int = 42) -> None:
    """Host-side RNG seeding (reference src/util.py:16-19). Device randomness
    uses explicit torch Generators seeded from the same seed."""
    import random

    random.seed(seed)
    np.random.seed(seed)


def load_video_frames(
    frames_path: str, n_frames: int, image_size: Tuple[int, int] = (512, 512)
) -> np.ndarray:
    """Load ``%05d.png`` frames -> ``[F, H, W, 3]`` fp32 in [-1, 1]
    (reference src/util.py:63-81)."""
    frames = []
    for i in range(n_frames):
        p = os.path.join(frames_path, "%05d.png" % i)
        img = Image.open(p).resize(image_size)
        img = img.convert("RGB")
        frames.append(np.asarray(img, dtype=np.float32) / 127.5 - 1.0)
    return np.stack(frames)


def load_video(path: str, n_frames: int, image_size: Tuple[int, int] = (512, 512)) -> np.ndarray:
    """Load a video: a directory of PNG frames or an .mp4 (imageio-ffmpeg).

    Returns ``[F, H, W, 3]`` fp32 in [-1, 1]. The reference uses decord for
    mp4 (inversion_tools/ddim_inversion.py:20-25); imageio stands in for it.
    """
    if path.endswith(".mp4"):
        import imageio

        reader = imageio.get_reader(path)
        frames = []
        for i, frame in enumerate(reader):
            if i >= n_frames:
                break
            img = Image.fromarray(frame).resize(image_size).convert("RGB")
            frames.append(np.asarray(img, dtype=np.float32) / 127.5 - 1.0)
        reader.close()
        return np.stack(frames)
    return load_video_frames(path, n_frames, image_size)


def load_style_image(
    style_path: str, n_frames: int, image_size: Tuple[int, int] = (512, 512)
) -> np.ndarray:
    """Style image repeated to F frames -> ``[F, H, W, 3]`` fp32 in [-1, 1]
    (reference inversion_tools/ddim_inversion.py:48-51)."""
    img = Image.open(style_path).convert("RGB").resize(image_size)
    x = np.asarray(img, dtype=np.float32) / 255.0
    x = 2.0 * x - 1.0
    return np.broadcast_to(x, (n_frames,) + x.shape).copy()


def load_mask(mask_path: str, n_frames: int = 16) -> np.ndarray:
    """Load per-frame propagated masks ``{mask_path}/%05d.png`` ->
    ``[F, H, W]`` fp32 in {0, 1}.

    Replicates the reference binarization quirk (src/util.py:133-144): pixel
    values are multiplied by 255 then clipped to [0, 1], so any nonzero pixel
    becomes foreground.
    """
    masks = []
    for i in range(n_frames):
        p = os.path.join(mask_path, "%05d.png" % i)
        m = np.asarray(Image.open(p)).astype(np.float32)
        if m.ndim == 3:
            m = m[..., 0]
        masks.append(np.clip(m * 255.0, 0.0, 1.0))
    return np.stack(masks)


def davis_palette(n: int = 256) -> np.ndarray:
    """The 256-entry DAVIS-2017 segmentation colormap, ``[n, 3]`` uint8.

    The reference ships this exact table as ``src/palette.txt`` and loads it
    in ``src/mask_propagation.py:22-26`` (where it is actually dead code —
    the masks are saved as plain {0,255} L-mode PNGs, :66-69). We generate
    the identical table instead of shipping the file: rows 0-21 follow the
    PASCAL-VOC bit-reversal recipe with the DAVIS variant's 191-for-192
    second-bit value, rows 22+ are grayscale ``(i, i, i)``. Used for the
    optional palette-rendered mask output (``--save_palette``) so propagated
    labels can be compared visually against reference-style artifacts.
    """
    pal = np.zeros((n, 3), np.uint8)
    for i in range(min(n, 22)):
        cid, rgb = i, [0, 0, 0]
        for j in range(8):
            for ch in range(3):
                rgb[ch] |= ((cid >> ch) & 1) << (7 - j)
            cid >>= 3
        pal[i] = [191 if v == 192 else v for v in rgb]
    for i in range(22, n):
        pal[i] = (i, i, i)
    return pal


def save_palette_mask(labels: np.ndarray, path: str) -> None:
    """Save an integer label map ``[H, W]`` as a P-mode PNG rendered through
    the DAVIS palette (the visual form the reference's ``palette.txt`` was
    meant for)."""
    img = Image.fromarray(labels.astype(np.uint8), mode="P")
    img.putpalette(davis_palette().ravel().tolist())
    img.save(path)


def save_frames(frames: np.ndarray, path: str) -> None:
    """Save ``[F, H, W, 3]`` fp32 in [0, 1] as ``%05d.png`` (reference
    src/util.py:22-31 ``save_folder``)."""
    os.makedirs(path, exist_ok=True)
    x = frames if frames.dtype == np.uint8 else (
        np.clip(frames, 0.0, 1.0) * 255.0
    ).astype(np.uint8)
    for i in range(x.shape[0]):
        Image.fromarray(x[i]).save(os.path.join(path, "%05d.png" % i))


def save_video(frames: np.ndarray, path: str, fps: int = 8) -> None:
    """Save ``[F, H, W, 3]`` fp32 in [0, 1] as mp4 (reference
    src/util.py:34-47 ``save_videos_grid``). Falls back to PNG frames
    (``<path stem>_frames/``) if imageio or its ffmpeg backend is missing."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    x = frames if frames.dtype == np.uint8 else (
        np.clip(frames, 0.0, 1.0) * 255.0
    ).astype(np.uint8)
    try:
        import imageio
    except ImportError:
        save_frames(frames, os.path.splitext(path)[0] + "_frames")
        return
    try:
        imageio.mimsave(path, list(x), fps=fps)
    except Exception:
        save_frames(frames, os.path.splitext(path)[0] + "_frames")
