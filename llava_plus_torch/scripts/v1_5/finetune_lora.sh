#!/bin/bash
# Stage-2 LoRA (ref llava_plus_torch/scripts/v1_5/finetune_lora.sh): r=128 alpha=256,
# separate projector lr.

python -m llava_plus_torch.train.train \
    --lora-enable true --lora-r 128 --lora-alpha 256 \
    --mm-projector-lr 2e-5 \
    --model-name-or-path ./checkpoints/vicuna-7b-v1.5 \
    --version v1 \
    --data-path ./playground/data/llava_v1_5_mix665k.json \
    --image-folder ./playground/data \
    --vision-tower openai/clip-vit-large-patch14-336 \
    --pretrain-mm-mlp-adapter ./checkpoints/llava-v1.5-7b-pretrain/mm_projector.bin \
    --mm-projector-type mlp2x_gelu \
    --mm-vision-select-layer -2 \
    --image-aspect-ratio pad \
    --group-by-modality-length true \
    --bf16 true \
    --output-dir ./checkpoints/llava-v1.5-7b-lora \
    --num-train-epochs 1 \
    --per-device-train-batch-size 16 \
    --learning-rate 2e-4 \
    --warmup-ratio 0.03 \
    --lr-scheduler-type cosine \
    --model-max-length 2048 \
    --gradient-checkpointing true \
    --lazy-preprocess true
