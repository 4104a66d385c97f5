#!/bin/bash
# Stage-2: full finetuning (ref llava_plus_torch/scripts/v1_5/finetune.sh).
# ZeRO-3 == fsdp parameter+optimizer sharding over the mesh.

python -m llava_plus_torch.train.train \
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
    --output-dir ./checkpoints/llava-v1.5-7b \
    --num-train-epochs 1 \
    --per-device-train-batch-size 16 \
    --learning-rate 2e-5 \
    --weight-decay 0. \
    --warmup-ratio 0.03 \
    --lr-scheduler-type cosine \
    --logging-steps 1 \
    --save-steps 50000 \
    --model-max-length 2048 \
    --gradient-checkpointing true \
    --lazy-preprocess true
