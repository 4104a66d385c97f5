#!/bin/bash
# SEED-Bench eval with chunking (ref llava_plus_torch/scripts/v1_5/eval/seed.sh).

CKPT="llava-v1.5-7b"
CHUNKS=${CHUNKS:-1}
# >0: answer via the continuous-batching engine (see docs/Evaluation.md)
ENGINE_SLOTS=${ENGINE_SLOTS:-0}

for IDX in $(seq 0 $((CHUNKS-1))); do
    python -m llava_plus_torch.eval.model_vqa_loader \
        --engine-slots $ENGINE_SLOTS \
        --model-path ./checkpoints/$CKPT \
        --question-file ./playground/data/eval/seed_bench/llava-seed-bench.jsonl \
        --image-folder ./playground/data/eval/seed_bench \
        --answers-file ./playground/data/eval/seed_bench/answers/$CKPT/${CHUNKS}_${IDX}.jsonl \
        --num-chunks $CHUNKS \
        --chunk-idx $IDX \
        --temperature 0 \
        --conv-mode llava_v1 &
done
wait

output_file=./playground/data/eval/seed_bench/answers/$CKPT/merge.jsonl
> "$output_file"
for IDX in $(seq 0 $((CHUNKS-1))); do
    cat ./playground/data/eval/seed_bench/answers/$CKPT/${CHUNKS}_${IDX}.jsonl >> "$output_file"
done

python llava_plus_torch/scripts/convert_seed_for_submission.py \
    --annotation-file ./playground/data/eval/seed_bench/SEED-Bench.json \
    --result-file $output_file \
    --result-upload-file ./playground/data/eval/seed_bench/answers_upload/$CKPT.jsonl
