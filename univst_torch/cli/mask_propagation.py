"""Point-matching mask propagation CLI — port of
``univst_tpu/cli/mask_propagation.py``, flag for flag.

Reads the captured decoder feature map, propagates the first-frame mask and
writes {output}/{backbone}/{name}/%05d.png binary masks ({0, 255}), frame 0
being a copy of the input mask, plus DAVIS-palette label PNGs under
{out}/palette/ (``--save_palette``, default on). Runs on CUDA unless
``--platform cpu``."""

from __future__ import annotations

import argparse
import os

import numpy as np
from PIL import Image

from univst_torch.cli.common import load_feature_pt, setup_device


def main(args):
    import torch

    from univst_torch.methods.mask_propagation import (
        MaskPropConfig, propagate_masks, to_one_hot, upsample_labels,
    )
    from univst_torch.utils.io import save_palette_mask

    device = setup_device(args.platform)
    name = os.path.basename(args.mask_path).split(".")[0]
    out_dir = os.path.join(args.output_path, args.backbone, name)
    os.makedirs(out_dir, exist_ok=True)

    first = Image.open(args.mask_path)
    Image.fromarray(np.asarray(first).astype(np.uint8)).save(os.path.join(out_dir, "00000.png"))
    ori_w, ori_h = first.size

    feats = load_feature_pt(args.feature_path)  # [F, H, W, C]
    f, fh, fw, c = feats.shape
    first_small = np.asarray(first.resize((fw, fh), Image.NEAREST))
    if first_small.ndim == 3:
        first_small = first_small[..., 0]
    # compact the label values: a {0, 255} mask is a 2-class problem, not 256
    # one-hot planes; background 0 keeps class 0
    classes = np.unique(np.concatenate([[0], first_small.ravel()]))
    compact = np.searchsorted(classes, first_small)
    seg0 = to_one_hot(torch.as_tensor(compact), len(classes)).to(device)

    cfg = MaskPropConfig(temperature=args.temperature, n_last_frames=args.n_last_frames,
                         topk=args.topk, sample_ratio=args.sample_ratio)
    segs = propagate_masks(torch.as_tensor(feats.reshape(f, fh * fw, c), device=device), seg0,
                           cfg, generator=torch.Generator(device=device).manual_seed(0))
    labels = upsample_labels(segs, (fh, fw), (ori_h, ori_w)).cpu().numpy()
    # decompact to the input mask's values so palette colors match its ids
    orig_labels = classes[labels]
    masks = np.where(labels != 0, 255, 0).astype(np.uint8)
    pal_dir = os.path.join(out_dir, "palette") if args.save_palette else None
    if pal_dir:
        os.makedirs(pal_dir, exist_ok=True)
        save_palette_mask(classes[compact].astype(np.uint8), os.path.join(pal_dir, "00000.png"))
    for i in range(min(args.num_frames - 1, masks.shape[0])):
        Image.fromarray(masks[i]).save(os.path.join(out_dir, "%05d.png" % (i + 1)))
        if pal_dir:
            save_palette_mask(orig_labels[i], os.path.join(pal_dir, "%05d.png" % (i + 1)))
    print(f"done -> {out_dir}")


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--temperature", default=0.2, type=float)
    p.add_argument("--n_last_frames", type=int, default=9)
    p.add_argument("--topk", type=int, default=15)
    p.add_argument("--sample_ratio", type=float, default=0.3)
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--mask_path", type=str, default="examples/masks/mallard-fly.png")
    p.add_argument("--backbone", type=str, default=None)
    p.add_argument("--feature_path", type=str, default=None)
    p.add_argument("--output_path", type=str, default=None)
    p.add_argument("--platform", type=str, default=None, help="'cpu' or 'cuda' (default)")
    p.add_argument("--save_palette", action=argparse.BooleanOptionalAction, default=True,
                   help="also write DAVIS-palette label PNGs under {out}/palette/")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
