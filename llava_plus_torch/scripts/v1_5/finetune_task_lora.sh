#!/bin/bash
# Task LoRA finetuning from a finished LLaVA checkpoint
# (ref llava_plus_torch/scripts/v1_5/finetune_task_lora.sh).

python -m llava_plus_torch.train.train \
    --lora-enable true --lora-r 128 --lora-alpha 256 \
    --mm-projector-lr 2e-5 \
    --model-name-or-path ./checkpoints/llava-v1.5-7b \
    --version v1 \
    --data-path ./playground/data/your_task_data.json \
    --image-folder ./playground/data \
    --vision-tower openai/clip-vit-large-patch14-336 \
    --mm-projector-type mlp2x_gelu \
    --mm-vision-select-layer -2 \
    --image-aspect-ratio pad \
    --group-by-modality-length true \
    --bf16 true \
    --output-dir ./checkpoints/llava-v1.5-7b-task-lora \
    --num-train-epochs 1 \
    --per-device-train-batch-size 16 \
    --learning-rate 2e-4 \
    --warmup-ratio 0.03 \
    --lr-scheduler-type cosine \
    --model-max-length 2048 \
    --gradient-checkpointing true \
    --lazy-preprocess true
