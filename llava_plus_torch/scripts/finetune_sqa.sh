#!/bin/bash
# ScienceQA finetuning (ref llava_plus_torch/scripts/finetune_sqa.sh).
# Original-LLaVA (v1.0) recipe, 12 epochs on SQA train.

python -m llava_plus_torch.train.train \
    --model-name-or-path ./checkpoints/vicuna-13b-v1.3 \
    --version v1 \
    --data-path ./playground/data/scienceqa/llava_train_QCM-LEA.json \
    --image-folder ./playground/data/scienceqa/images/train \
    --vision-tower openai/clip-vit-large-patch14 \
    --pretrain-mm-mlp-adapter ./checkpoints/llava-pretrain-vicuna-13b-v1.3/mm_projector.bin \
    --mm-vision-select-layer -2 \
    --bf16 true \
    --output-dir ./checkpoints/llava-vicuna-13b-v1.3-sqa-12e \
    --num-train-epochs 12 \
    --per-device-train-batch-size 16 \
    --learning-rate 2e-5 \
    --weight-decay 0. \
    --warmup-ratio 0.03 \
    --lr-scheduler-type cosine \
    --save-steps 50000 \
    --model-max-length 2048 \
    --gradient-checkpointing true \
    --lazy-preprocess true
