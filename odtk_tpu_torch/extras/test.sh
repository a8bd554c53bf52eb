#!/bin/bash
# Smoke-test harness for odtk-tpu-torch: the port of extras/test.sh (the
# original's extras/test.sh:10-17): the twelve end-to-end CLI legs of the
# JAX package's harness through `python -m odtk_tpu_torch.main`, then a
# .pt2 and a .cppengine export of model.ckpt, each checked: the .pt2
# loaded and run by torch.export, the .cppengine's contract printed by
# the C++ sample odtk_export (built on first use).
#
# Usage: odtk_tpu_torch/extras/test.sh <images_dir> <annotations.json> [workdir]
# With no arguments, generates a tiny synthetic COCO set first.
# DEVICE (default cuda) is passed to every leg as --device.

set -e

ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
WORK="${3:-$(mktemp -d)}"
IMAGES="$1"
ANNOTATIONS="$2"
DEVICE="${DEVICE:-cuda}"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"

if [ -z "$IMAGES" ]; then
    echo "No dataset given - generating synthetic COCO set in $WORK"
    python - "$WORK" <<EOF
import sys
sys.path.insert(0, '$ROOT/tests')
from synth import make_dataset
img, ann = make_dataset(sys.argv[1], n_images=8, size=(120, 160))
print(img); print(ann)
rimg, rann = make_dataset(sys.argv[1] + '/rot', n_images=6,
                          size=(120, 160), rotated=True)
print(rimg); print(rann)
EOF
    IMAGES="$WORK/images"
    ANNOTATIONS="$WORK/annotations.json"
    ROT_IMAGES="$WORK/rot/images"
    ROT_ANNOTATIONS="$WORK/rot/annotations.json"
    CLASSES=3
    EXTRA="--resize 64 --max-size 128 --jitter 64 64 --warmup 0 --lr 0.001 --no-pretrained"
    SIZE=128
else
    CLASSES=80
    EXTRA="--resize 512 --max-size 768 --jitter 512 512 --no-pretrained"
    SIZE=640
fi

start=$(date +%s)
run() {
    echo "==> odtk-tpu-torch $* --device $DEVICE"
    python -m odtk_tpu_torch.main "$@" --device "$DEVICE"
}

# 1. train with two backbones at once
run train "$WORK/twobb.ckpt" --backbone ResNet18FPN MobileNetV2FPN \
    --classes $CLASSES --images "$IMAGES" --annotations "$ANNOTATIONS" \
    --batch 2 --iters 2 --milestones $EXTRA --full-precision --override
# 2. train default-ish backbone
run train "$WORK/model.ckpt" --backbone ResNet18FPN --classes $CLASSES \
    --images "$IMAGES" --annotations "$ANNOTATIONS" \
    --batch 2 --iters 2 --milestones $EXTRA --full-precision --override
# 3. fine-tune from the produced checkpoint
run train "$WORK/finetune.ckpt" --backbone ResNet18FPN --classes $CLASSES \
    --fine-tune "$WORK/model.ckpt" --images "$IMAGES" \
    --annotations "$ANNOTATIONS" --batch 2 --iters 2 --milestones $EXTRA \
    --full-precision --override
# 4. infer with the checkpoint
run infer "$WORK/model.ckpt" --images "$IMAGES" \
    --annotations "$ANNOTATIONS" --batch 2 \
    --output "$WORK/detections.json" --full-precision \
    $(echo "$EXTRA" | grep -o -- '--resize [0-9]*') \
    $(echo "$EXTRA" | grep -o -- '--max-size [0-9]*')
# 5. export an engine
run export "$WORK/model.ckpt" "$WORK/model.engine" --size $SIZE \
    --full-precision --dynamic-batch-opts 1 2 2
# 6. infer with the engine
run infer "$WORK/model.engine" --images "$IMAGES" \
    --annotations "$ANNOTATIONS" --batch 2 \
    --output "$WORK/detections_engine.json" --full-precision
# 7. INT8: calibrate on the dataset images and export an int8 engine
run export "$WORK/model.ckpt" "$WORK/model_int8.engine" --size $SIZE \
    --int8 --calibration-images "$IMAGES" \
    --calibration-table "$WORK/calibration.json" \
    --dynamic-batch-opts 1 2 2 --verbose
# 8. infer with the int8 engine (accuracy delta vs step 6 shows in the
#    mAP lines of both runs)
run infer "$WORK/model_int8.engine" --images "$IMAGES" \
    --annotations "$ANNOTATIONS" --batch 2 \
    --output "$WORK/detections_int8.json" --full-precision

# 9-12. rotated-bbox leg (synthetic set only: rotated annotations are
# self-generated; with a user dataset the axis legs above apply)
if [ -n "$ROT_IMAGES" ]; then
    run train "$WORK/rotated.ckpt" --backbone ResNet18FPN \
        --classes $CLASSES --images "$ROT_IMAGES" \
        --annotations "$ROT_ANNOTATIONS" --rotated-bbox \
        --batch 2 --iters 2 --milestones $EXTRA --full-precision --override
    run infer "$WORK/rotated.ckpt" --images "$ROT_IMAGES" \
        --annotations "$ROT_ANNOTATIONS" --batch 2 --rotated-bbox \
        --output "$WORK/detections_rotated.json" --full-precision \
        $(echo "$EXTRA" | grep -o -- '--resize [0-9]*') \
        $(echo "$EXTRA" | grep -o -- '--max-size [0-9]*')
    run export "$WORK/rotated.ckpt" "$WORK/rotated.engine" --size $SIZE \
        --full-precision --dynamic-batch-opts 1 2 2
    run infer "$WORK/rotated.engine" --images "$ROT_IMAGES" \
        --annotations "$ROT_ANNOTATIONS" --batch 2 --rotated-bbox \
        --output "$WORK/detections_rotated_engine.json" --full-precision
fi

# 13. the torch.export program of the largest batch profile, run
run export "$WORK/model.ckpt" "$WORK/model.pt2" --size $SIZE \
    --full-precision --dynamic-batch-opts 1 2 2
python - "$WORK/model.pt2" "$DEVICE" $SIZE <<EOF
import sys
import torch
import odtk_tpu_torch.export  # noqa: F401  (the odtk:: operators)
path, device, size = sys.argv[1], sys.argv[2], int(sys.argv[3])
program = torch.export.load(path).module()
with torch.no_grad():
    out = program(torch.zeros(2, size, size, 3, device=device))
print('.pt2: outputs', [list(o.shape) for o in out])
EOF
# 14. the C++ engine (u8 contract) and its contract from C++
run export "$WORK/model.ckpt" "$WORK/model.cppengine" --size $SIZE \
    --full-precision --dynamic-batch-opts 1 2 2 --input-format u8
ODTK_EXPORT=$(python -c "
from odtk_tpu_torch.extras.cppapi.build import build
print(build()['odtk_export'])")
"$ODTK_EXPORT" "$WORK/model.cppengine"

echo "ALL SMOKE TESTS PASSED in $(( $(date +%s) - start ))s (workdir $WORK)"
