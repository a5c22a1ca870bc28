"""Standalone optical-flow / warp CLI — port of
``univst_tpu/cli/cal_optical_flow.py``, flag for flag (rebuild of
src/cal_optica_flow.py's __main__, :102-108): bidirectional Lucas-Kanade
flow between two images, then the occlusion mask and the
occlusion-blended warped image written as PNGs. Runs on CUDA unless
``--platform cpu``."""

from __future__ import annotations

import argparse

import numpy as np
from PIL import Image

from univst_torch.cli.common import setup_device


def main(args):
    import torch

    from univst_torch.methods.flow import compute_occlusion_mask, get_warp, lucas_kanade_flow

    device = setup_device(args.platform)

    def load(path):
        img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
        return torch.as_tensor(img, device=device)

    img1, img2 = load(args.image1), load(args.image2)
    flows = lucas_kanade_flow(torch.stack([img1, img2]), torch.stack([img2, img1]))
    occ = compute_occlusion_mask(flows[0], flows[1], args.threshold).cpu().numpy()
    # the warp uses get_warp's default threshold, as the reference CLI does
    warped = get_warp(lucas_kanade_flow, img1, img2).cpu().numpy()
    if args.occlusion_mask_save_path:
        Image.fromarray((occ * 255).astype(np.uint8)).save(args.occlusion_mask_save_path)
        print(f"Occlusion mask saved at {args.occlusion_mask_save_path}")
    if args.warped_image_save_path:
        Image.fromarray((np.clip(warped, 0, 1) * 255).astype(np.uint8)).save(
            args.warped_image_save_path)
        print(f"Warped image saved at {args.warped_image_save_path}")


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--image1", required=True)
    p.add_argument("--image2", required=True)
    p.add_argument("--occlusion_mask_save_path", default="occlusion_mask.png")
    p.add_argument("--warped_image_save_path", default="warped_image_with_mask.png")
    p.add_argument("--threshold", type=float, default=1.5)
    p.add_argument("--platform", type=str, default=None, help="'cpu' or 'cuda' (default)")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
