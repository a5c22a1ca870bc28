"""Localized style transfer CLI, AnimateDiff backbone — port of
``univst_tpu/cli/run_video_style_transfer_animatediff.py``, flag for flag
(rebuild of src/animatediff/run_video_style_transfer_animatediff.py). This
runner passes the raw content noise as the initial latents, with no
latent_adain shift, as the reference does (SURVEY.md C17), and stylizes by
capture-and-inject."""

from univst_torch.cli import run_video_style_transfer_sd as _sd


def build_parser():
    p = _sd.build_parser()
    p.set_defaults(
        backbone="animatediff",
        content_inv_path="results/contents-inv/animatediff/mallard-fly/inversion",
        style_inv_path="results/styles-inv/animatediff/00033/inversion",
    )
    p.add_argument("--motion_module_path", type=str, default=None)
    p.add_argument("--dreambooth_path", type=str, default=None)
    p.add_argument("--lora_path", type=str, default=None)
    p.add_argument("--lora_alpha", type=float, default=0.8)
    return p


main = _sd.main

if __name__ == "__main__":
    main(build_parser().parse_args())
