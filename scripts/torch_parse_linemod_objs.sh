#!/bin/bash
# The PyTorch port's LINEMOD conversion (mirrors scripts/parse_linemod_objs.sh):
# all 13 objects to OnePose layout through the port's entry point, GT boxes for
# the train split, YOLO boxes for the eval split.
#   bash scripts/torch_parse_linemod_objs.sh
set -e
for obj_id in 01 02 04 05 06 08 09 10 11 12 13 14 15; do
    echo "obj_id:$obj_id"
    python -m onepose_plus_plus_tpu_torch.parse_lm_real_data \
        --obj_id "$obj_id" \
        --assign_onepose_id "08${obj_id}" \
        --split train

    python -m onepose_plus_plus_tpu_torch.parse_lm_real_data \
        --obj_id "$obj_id" \
        --assign_onepose_id "08${obj_id}" \
        --split val \
        --use_yolo_box
done
