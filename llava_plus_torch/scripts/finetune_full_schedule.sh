#!/bin/bash
# Original-LLaVA (v1.0) full-schedule finetune, 3 epochs on 158k
# (ref llava_plus_torch/scripts/finetune_full_schedule.sh).

PROMPT_VERSION=v1
MODEL_VERSION="vicuna-7b-v1.3"

python -m llava_plus_torch.train.train \
    --model-name-or-path ./checkpoints/$MODEL_VERSION \
    --version $PROMPT_VERSION \
    --data-path ./playground/data/llava_instruct_158k.json \
    --image-folder ./playground/data/coco/train2017 \
    --vision-tower openai/clip-vit-large-patch14 \
    --pretrain-mm-mlp-adapter ./checkpoints/llava-$MODEL_VERSION-pretrain/mm_projector.bin \
    --mm-vision-select-layer -2 \
    --bf16 true \
    --output-dir ./checkpoints/llava-$MODEL_VERSION-finetune_full_schedule \
    --num-train-epochs 3 \
    --per-device-train-batch-size 16 \
    --learning-rate 2e-5 \
    --weight-decay 0. \
    --warmup-ratio 0.03 \
    --lr-scheduler-type cosine \
    --save-steps 50000 \
    --model-max-length 2048 \
    --gradient-checkpointing true \
    --lazy-preprocess true
