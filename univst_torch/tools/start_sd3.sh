#!/usr/bin/env bash
# The four-stage SD3 workflow on the PyTorch port (univst_torch.cli), the
# counterpart of scripts/start_sd3.sh, with the same output tree under
# results/ in the working directory. Runs on the CUDA card.
#   PRETRAINED  diffusers checkpoint directory (default: random weights)
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
PLATFORM=${PLATFORM:+--platform $PLATFORM}
CONTENT=${CONTENT:-$ROOT/examples/contents/demo-fly}
STYLE=${STYLE:-$ROOT/examples/styles/00033.png}
MASK=${MASK:-$ROOT/examples/masks/demo-fly.png}
NAME=$(basename "$CONTENT")
SNAME=$(basename "$STYLE" .png)

$PY -m univst_torch.cli.run_content_inversion_sd3 $PRETRAINED $PLATFORM $ARGS \
    --content_path "$CONTENT" --output_path results/contents-inv --is_rf_solver
$PY -m univst_torch.cli.run_style_inversion_sd3 $PRETRAINED $PLATFORM $ARGS \
    --style_path "$STYLE" --output_path results/styles-inv --is_rf_solver
$PY -m univst_torch.cli.mask_propagation $PLATFORM \
    --feature_path "results/contents-inv/sd3/$NAME/features/inversion_feature_map_20_block_5_step.pt" \
    --backbone sd3 --mask_path "$MASK" --output_path results/masks
$PY -m univst_torch.cli.run_video_style_transfer_sd3 $PRETRAINED $PLATFORM $ARGS \
    --content_inv_path "results/contents-inv/sd3/$NAME/inversion" \
    --style_inv_path "results/styles-inv/sd3/$SNAME/inversion" \
    --mask_path "results/masks/sd3/$(basename "$MASK" .png)" \
    --output_path results/stylizations
