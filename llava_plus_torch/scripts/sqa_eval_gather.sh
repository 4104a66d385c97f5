#!/bin/bash
# Gather + score the ScienceQA chunks (ref llava_plus_torch/scripts/sqa_eval_gather.sh).

CHUNKS=${CHUNKS:-8}
output_file="test_llava.jsonl"
> "$output_file"
for idx in $(seq 0 $((CHUNKS-1))); do
    cat "./test_llava-chunk${CHUNKS}_${idx}.jsonl" >> "$output_file"
done

python -m llava_plus_torch.eval.eval_science_qa \
    --base-dir ./playground/data/scienceqa \
    --result-file ./test_llava.jsonl \
    --output-file ./test_llava_output.json \
    --output-result ./test_llava_result.json
