#!/bin/bash
# LLaVA-Plus tool-use tuning on the v0 base
# (ref llava_plus_torch/scripts/llava_plus/training_llava_plus_v0_7b.sh).
export LLAVA_DEFAULT_CONVERSATION="conv_vicuna_v0"

python -m llava_plus_torch.train.train \
    --model-name-or-path ./checkpoints/vicuna-7b-v0 \
    --pretrain-mm-mlp-adapter ./checkpoints/llava-7b-pretrain-projector-v0/mm_projector.bin \
    --version v0 \
    --data-path ./playground/data/llava_150k.json,./playground/data/llava_plus_v1_117k.json \
    --image-folder ./playground/data/coco/train2017,./playground/data/hiertext \
    --vision-tower openai/clip-vit-large-patch14 \
    --mm-projector-type linear \
    --mm-vision-select-layer -2 \
    --bf16 true \
    --output-dir ./checkpoints/llava-plus-v0-7b \
    --num-train-epochs 3 \
    --per-device-train-batch-size 16 \
    --learning-rate 2e-5 \
    --warmup-ratio 0.03 \
    --lr-scheduler-type cosine \
    --model-max-length 2048 \
    --gradient-checkpointing true \
    --lazy-preprocess true
