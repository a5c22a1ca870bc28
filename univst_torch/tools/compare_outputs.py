"""Compare two stylization output directories — port of ``scripts/compare_outputs.py``.

The turnkey check for the day real checkpoints arrive: point it at the
port's output frames and the reference's (``%05d.png`` directories, the
reference's save layout) and it prints per-frame and aggregate PSNR / SSIM
(``univst_torch/utils/metrics.py``), LPIPS with the AlexNet trunk when given
its two weight files (``univst_torch/utils/lpips.py``, on the card unless
``--device cpu``), or the latent MSE of two trajectory files.

    python -m univst_torch.tools.compare_outputs DIR_A DIR_B [--json]
    python -m univst_torch.tools.compare_outputs --latents A.pt B.pt [--json]

Exit code 1 when a ``--psnr-min`` / ``--ssim-min`` / ``--lpips-max`` gate
is violated, and when a gate is given whose metric was not computed
(latents mode, or LPIPS without both weight files), so it doubles as a
regression gate. Arguments, JSON keys and exit codes are the JAX script's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from univst_torch.utils.metrics import compare_frame_stacks, latent_mse


def load_dir(path: str) -> np.ndarray:
    from PIL import Image

    names = sorted(f for f in os.listdir(path) if f.lower().endswith((".png", ".jpg", ".jpeg")))
    if not names:
        raise SystemExit(f"no image frames in {path}")
    return np.stack([np.asarray(Image.open(os.path.join(path, n)).convert("RGB"))
                     for n in names])


def lpips_frames(a: np.ndarray, b: np.ndarray, alexnet: str, lin: str, device) -> np.ndarray:
    """Per-frame LPIPS of two uint8 ``[F, H, W, 3]`` stacks, fp32."""
    import torch

    from univst_torch.utils.lpips import load_lpips_params, lpips_distance

    model = load_lpips_params(alexnet, lin).to(device)

    def unit(x):
        return torch.as_tensor(x.astype(np.float32) / 127.5 - 1.0, device=device)

    return lpips_distance(model, unit(a), unit(b)).cpu().numpy()


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="*", help="two frame directories")
    ap.add_argument("--latents", nargs=2, metavar=("A.pt", "B.pt"),
                    help="compare two trajectory/latent .pt files instead")
    ap.add_argument("--json", action="store_true", help="print one JSON line")
    ap.add_argument("--psnr-min", type=float, default=None)
    ap.add_argument("--ssim-min", type=float, default=None)
    ap.add_argument("--lpips-alexnet", type=str, default=None,
                    help="torchvision AlexNet state_dict .pth (adds LPIPS)")
    ap.add_argument("--lpips-lin", type=str, default=None,
                    help="lpips 'lin' heads state_dict .pth")
    ap.add_argument("--lpips-max", type=float, default=None,
                    help="fail when mean LPIPS exceeds this")
    ap.add_argument("--device", default=None,
                    help="where LPIPS runs: cpu, or the card (default)")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)

    result = {}
    if args.latents:
        import torch

        a, b = (torch.load(p, map_location="cpu", weights_only=True) for p in args.latents)
        result["latent_mse"] = latent_mse(np.asarray(a, np.float64), np.asarray(b, np.float64))
    else:
        if len(args.dirs) != 2:
            ap.error("pass two frame directories (or --latents)")
        a, b = load_dir(args.dirs[0]), load_dir(args.dirs[1])
        if a.shape[0] != b.shape[0]:
            raise SystemExit(f"frame count mismatch: {a.shape[0]} vs {b.shape[0]}")
        result = compare_frame_stacks(a, b)
        if args.lpips_alexnet and args.lpips_lin:
            from univst_torch.pipelines.sd import resolve_device

            try:
                device = resolve_device(args.device)
            except RuntimeError as e:
                raise SystemExit(f"LPIPS: {e}") from e
            d = lpips_frames(a, b, args.lpips_alexnet, args.lpips_lin, device)
            result["lpips_per_frame"] = [round(float(x), 5) for x in d]
            result["lpips_mean"] = float(d.mean())

    if args.json:
        print(json.dumps(result))
    else:
        for k, v in result.items():
            if isinstance(v, list):
                print(f"{k}: " + " ".join(f"{x:.3f}" for x in v))
            else:
                print(f"{k}: {v:.4f}")

    # a gate whose metric was never computed is a configuration error, not a
    # pass: a forgotten --lpips-alexnet / --lpips-lin pair, or a PSNR gate in
    # --latents mode, would otherwise report green without measuring anything
    fail = []
    for gate, flag, key, op in ((args.psnr_min, "--psnr-min", "psnr_min", "<"),
                                (args.ssim_min, "--ssim-min", "ssim_min", "<"),
                                (args.lpips_max, "--lpips-max", "lpips_mean", ">")):
        if gate is None:
            continue
        if key not in result:
            raise SystemExit(f"GATE ERROR: {flag} given but {key} was never computed "
                             "(latents mode, or missing --lpips-alexnet/--lpips-lin)")
        v = result[key]
        if (v < gate) if op == "<" else (v > gate):
            fail.append(f"{key} {v:.4f} {op} {gate}")
    if fail:
        print("GATE FAILED: " + "; ".join(fail), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
