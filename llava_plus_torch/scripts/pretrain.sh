#!/bin/bash
# Original-LLaVA (v1.0) stage-1 projector pretraining (ref llava_plus_torch/scripts/pretrain.sh).
# For LLaVA-1.5 use llava_plus_torch/scripts/v1_5/pretrain.sh.

PROMPT_VERSION=plain
MODEL_VERSION="vicuna-7b-v1.3"

python -m llava_plus_torch.train.train \
    --model-name-or-path ./checkpoints/$MODEL_VERSION \
    --version $PROMPT_VERSION \
    --data-path ./playground/data/blip_laion_cc_sbu_558k.json \
    --image-folder ./playground/data/images \
    --vision-tower openai/clip-vit-large-patch14 \
    --tune-mm-mlp-adapter true \
    --mm-vision-select-layer -2 \
    --bf16 true \
    --output-dir ./checkpoints/llava-$MODEL_VERSION-pretrain \
    --num-train-epochs 1 \
    --per-device-train-batch-size 32 \
    --learning-rate 1e-3 \
    --weight-decay 0. \
    --warmup-ratio 0.03 \
    --lr-scheduler-type cosine \
    --save-steps 24000 \
    --model-max-length 2048 \
    --gradient-checkpointing true \
    --lazy-preprocess true
