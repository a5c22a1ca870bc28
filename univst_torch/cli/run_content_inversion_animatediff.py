"""Content inversion CLI, AnimateDiff backbone — port of
``univst_tpu/cli/run_content_inversion_animatediff.py``, flag for flag
(rebuild of src/animatediff/run_content_inversion_animatediff.py). Shares
the workflow with the SD runner; adds the motion-module, DreamBooth and
LoRA flags and defaults --backbone=animatediff. The pipeline builder
switches the DDIM schedule to plain 'linear' betas (animatediff-v2.yaml:
16-20)."""

from univst_torch.cli import run_content_inversion_sd as _sd


def build_parser():
    p = _sd.build_parser()
    p.set_defaults(backbone="animatediff")
    p.add_argument("--motion_module_path", type=str, default=None,
                   help="AnimateDiff motion-module checkpoint (mm_sd_v15_v2.ckpt)")
    p.add_argument("--dreambooth_path", type=str, default=None,
                   help="personalized LDM .ckpt/.safetensors replacing the base "
                        "UNet/VAE/CLIP (reference load_weights dreambooth_model_path)")
    p.add_argument("--lora_path", type=str, default=None,
                   help="webui-format LoRA merged into UNet/text-encoder weights")
    p.add_argument("--lora_alpha", type=float, default=0.8)
    return p


main = _sd.main

if __name__ == "__main__":
    main(build_parser().parse_args())
