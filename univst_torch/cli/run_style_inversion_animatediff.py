"""Style inversion CLI, AnimateDiff backbone — port of
``univst_tpu/cli/run_style_inversion_animatediff.py``, flag for flag
(rebuild of src/animatediff/run_style_inversion_animatediff.py). The style
image is inverted on all num_frames frames: the motion modules give each
frame its own position."""

from univst_torch.cli import run_style_inversion_sd as _sd


def build_parser():
    p = _sd.build_parser()
    p.set_defaults(backbone="animatediff")
    p.add_argument("--motion_module_path", type=str, default=None)
    p.add_argument("--dreambooth_path", type=str, default=None)
    p.add_argument("--lora_path", type=str, default=None)
    p.add_argument("--lora_alpha", type=float, default=0.8)
    return p


main = _sd.main

if __name__ == "__main__":
    main(build_parser().parse_args())
