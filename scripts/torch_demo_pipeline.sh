#!/bin/bash
# The PyTorch port's demo pipeline (mirrors scripts/demo_pipeline.sh): parse a
# scanned capture, run keypoint-free SfM on the annotate sequence, then run the
# tracking demo on the test sequence, all through the port's entry points.
#   bash scripts/torch_demo_pipeline.sh <object-name>            # on the GPU
#   DEVICE=cpu bash scripts/torch_demo_pipeline.sh <object-name> # on the CPU
set -e
PROJECT_DIR="$(pwd)"
OBJ_NAME=$1
DEVICE=${DEVICE:-cuda}
if [ -z "$OBJ_NAME" ]; then echo "usage: $0 <object-name>"; exit 1; fi
echo "Current work dir: $PROJECT_DIR"

echo '-------------------'
echo 'Parse scanned data:'
echo '-------------------'
python -m onepose_plus_plus_tpu_torch.parse_scanned_data \
    --scanned_object_path "$PROJECT_DIR/data/demo/$OBJ_NAME"

echo '--------------------------------------------------------------'
echo 'Run Keypoint-Free SfM to reconstruct the object point cloud:'
echo '--------------------------------------------------------------'
python -m onepose_plus_plus_tpu_torch.sfm \
    +preprocess=sfm_demo \
    dataset.data_dir="$PROJECT_DIR/data/demo" \
    dataset.outputs_dir="$PROJECT_DIR/data/demo/sfm_model" \
    device="$DEVICE"

echo '-----------------------------------'
echo 'Run inference and output demo video:'
echo '-----------------------------------'
python -m onepose_plus_plus_tpu_torch.demo \
    +experiment=inference_demo \
    dataset.data_dir="$PROJECT_DIR/data/demo" \
    dataset.sfm_outputs_dir="$PROJECT_DIR/data/demo/sfm_model" \
    device="$DEVICE"
