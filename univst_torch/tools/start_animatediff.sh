#!/usr/bin/env bash
# The four-stage AnimateDiff workflow on the PyTorch port (univst_torch.cli),
# the counterpart of scripts/start_animatediff.sh, with the same output tree
# under results/ in the working directory. Runs on the CUDA card.
#   PRETRAINED  diffusers checkpoint directory (default: random weights)
#   MOTION_MODULE  motion-module checkpoint (mm_sd_v15_v2.ckpt)
#   CONTENT, STYLE, MASK  frames directory, style image, first-frame mask
#               (default: the committed demo-fly clip)
#   PLATFORM=cpu  run on the CPU instead of the card
#   ARGS        more flags for the three model stages
#   PYTHON      the interpreter (default: python3)
set -e
ROOT=$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)
export PYTHONPATH=$ROOT${PYTHONPATH:+:$PYTHONPATH}
PY=${PYTHON:-python3}
PRETRAINED=${PRETRAINED:+--pretrained_model_path $PRETRAINED}
MM=${MOTION_MODULE:+--motion_module_path $MOTION_MODULE}
PLATFORM=${PLATFORM:+--platform $PLATFORM}
CONTENT=${CONTENT:-$ROOT/examples/contents/demo-fly}
STYLE=${STYLE:-$ROOT/examples/styles/00033.png}
MASK=${MASK:-$ROOT/examples/masks/demo-fly.png}
NAME=$(basename "$CONTENT")
SNAME=$(basename "$STYLE" .png)

$PY -m univst_torch.cli.run_content_inversion_animatediff $PRETRAINED $MM $PLATFORM $ARGS \
    --content_path "$CONTENT" --output_path results/contents-inv --is_opt
$PY -m univst_torch.cli.run_style_inversion_animatediff $PRETRAINED $MM $PLATFORM $ARGS \
    --style_path "$STYLE" --output_path results/styles-inv
$PY -m univst_torch.cli.mask_propagation $PLATFORM \
    --feature_path "results/contents-inv/animatediff/$NAME/features/inversion_feature_map_2_block_301_step.pt" \
    --backbone animatediff --mask_path "$MASK" --output_path results/masks
$PY -m univst_torch.cli.run_video_style_transfer_animatediff $PRETRAINED $MM $PLATFORM $ARGS \
    --content_inv_path "results/contents-inv/animatediff/$NAME/inversion" \
    --style_inv_path "results/styles-inv/animatediff/$SNAME/inversion" \
    --mask_path "results/masks/animatediff/$(basename "$MASK" .png)" \
    --output_path results/stylizations
