#!/bin/bash
# Stage-1: projector pretraining (ref llava_plus_torch/scripts/v1_5/pretrain.sh).
# DeepSpeed ZeRO-2 -> fsdp axis over all local devices.

python -m llava_plus_torch.train.train \
    --model-name-or-path ./checkpoints/vicuna-7b-v1.5 \
    --version plain \
    --data-path ./playground/data/blip_laion_cc_sbu_558k.json \
    --image-folder ./playground/data/images \
    --vision-tower openai/clip-vit-large-patch14-336 \
    --mm-projector-type mlp2x_gelu \
    --tune-mm-mlp-adapter true \
    --mm-vision-select-layer -2 \
    --image-aspect-ratio square \
    --bf16 true \
    --output-dir ./checkpoints/llava-v1.5-7b-pretrain \
    --num-train-epochs 1 \
    --per-device-train-batch-size 32 \
    --learning-rate 1e-3 \
    --weight-decay 0. \
    --warmup-ratio 0.03 \
    --lr-scheduler-type cosine \
    --logging-steps 1 \
    --save-steps 24000 \
    --model-max-length 2048 \
    --gradient-checkpointing true \
    --lazy-preprocess true
