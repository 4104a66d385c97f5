#!/bin/bash
# ScienceQA chunked eval fan-out (ref llava_plus_torch/scripts/sqa_eval_batch.sh); one
# process per chunk, data-parallel by --chunk-idx.

CHUNKS=${CHUNKS:-8}
for IDX in $(seq 0 $((CHUNKS-1))); do
    python -m llava_plus_torch.eval.model_vqa_science \
        --model-path ./checkpoints/llava-v1.5-7b \
        --question-file ./playground/data/scienceqa/llava_test_QCM-LEA.json \
        --image-folder ./playground/data/scienceqa/images/test \
        --answers-file ./test_llava-chunk${CHUNKS}_${IDX}.jsonl \
        --num-chunks $CHUNKS \
        --chunk-idx $IDX \
        --conv-mode llava_v1 &
done
wait
