#!/bin/bash
# VQAv2 eval with data-parallel chunking (ref llava_plus_torch/scripts/v1_5/eval/vqav2.sh).
# On TPU hosts, one process per host; chunk by process index.

CKPT="llava-v1.5-7b"
SPLIT="llava_vqav2_mscoco_test-dev2015"
CHUNKS=${CHUNKS:-1}
# >0: answer via the continuous-batching engine (see docs/Evaluation.md)
ENGINE_SLOTS=${ENGINE_SLOTS:-0}

for IDX in $(seq 0 $((CHUNKS-1))); do
    python -m llava_plus_torch.eval.model_vqa_loader \
        --engine-slots $ENGINE_SLOTS \
        --model-path ./checkpoints/$CKPT \
        --question-file ./playground/data/eval/vqav2/$SPLIT.jsonl \
        --image-folder ./playground/data/eval/vqav2/test2015 \
        --answers-file ./playground/data/eval/vqav2/answers/$SPLIT/$CKPT/${CHUNKS}_${IDX}.jsonl \
        --num-chunks $CHUNKS \
        --chunk-idx $IDX \
        --temperature 0 \
        --conv-mode llava_v1 &
done
wait

output_file=./playground/data/eval/vqav2/answers/$SPLIT/$CKPT/merge.jsonl
> "$output_file"
for IDX in $(seq 0 $((CHUNKS-1))); do
    cat ./playground/data/eval/vqav2/answers/$SPLIT/$CKPT/${CHUNKS}_${IDX}.jsonl >> "$output_file"
done

python llava_plus_torch/scripts/convert_vqav2_for_submission.py --split $SPLIT --ckpt $CKPT
