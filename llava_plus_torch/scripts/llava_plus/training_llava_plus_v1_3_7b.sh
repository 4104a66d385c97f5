#!/bin/bash
# LLaVA-Plus tool-use tuning (ref llava_plus_torch/scripts/llava_plus/training_llava_plus_v1.3_7b.sh):
# multi-dataset (comma-separated), multi-image-folder, 3 epochs.

python -m llava_plus_torch.train.train \
    --model-name-or-path ./checkpoints/vicuna-7b-v1.3 \
    --version v1 \
    --data-path ./playground/data/llava_150k.json,./playground/data/llava_plus_v1_117k.json \
    --image-folder ./playground/data/coco/train2017,./playground/data/hiertext \
    --vision-tower openai/clip-vit-large-patch14 \
    --mm-projector-type linear \
    --mm-vision-select-layer -2 \
    --bf16 true \
    --output-dir ./checkpoints/llava-plus-v1.3-7b \
    --num-train-epochs 3 \
    --per-device-train-batch-size 16 \
    --learning-rate 2e-5 \
    --warmup-ratio 0.03 \
    --lr-scheduler-type cosine \
    --model-max-length 2048 \
    --gradient-checkpointing true \
    --lazy-preprocess true
