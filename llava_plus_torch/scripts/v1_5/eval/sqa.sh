#!/bin/bash
# ScienceQA eval (ref llava_plus_torch/scripts/v1_5/eval/sqa.sh).

# >0: answer via the continuous-batching engine (see docs/Evaluation.md)
ENGINE_SLOTS=${ENGINE_SLOTS:-0}
python -m llava_plus_torch.eval.model_vqa_science \
        --engine-slots $ENGINE_SLOTS \
    --model-path ./checkpoints/llava-v1.5-7b \
    --question-file ./playground/data/eval/scienceqa/llava_test_CQM-A.json \
    --image-folder ./playground/data/eval/scienceqa/images/test \
    --answers-file ./playground/data/eval/scienceqa/answers/llava-v1.5-7b.jsonl \
    --single-pred-prompt \
    --temperature 0 \
    --conv-mode llava_v1

python -m llava_plus_torch.eval.eval_science_qa \
    --base-dir ./playground/data/eval/scienceqa \
    --result-file ./playground/data/eval/scienceqa/answers/llava-v1.5-7b.jsonl \
    --output-file ./playground/data/eval/scienceqa/answers/llava-v1.5-7b_output.jsonl \
    --output-result ./playground/data/eval/scienceqa/answers/llava-v1.5-7b_result.json
