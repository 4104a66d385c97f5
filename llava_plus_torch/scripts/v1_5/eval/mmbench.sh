#!/bin/bash
# MMBench eval (ref llava_plus_torch/scripts/v1_5/eval/mmbench.sh).

SPLIT="mmbench_dev_20230712"

# >0: answer via the continuous-batching engine (see docs/Evaluation.md)
ENGINE_SLOTS=${ENGINE_SLOTS:-0}
python -m llava_plus_torch.eval.model_vqa_mmbench \
        --engine-slots $ENGINE_SLOTS \
    --model-path ./checkpoints/llava-v1.5-7b \
    --question-file ./playground/data/eval/mmbench/$SPLIT.tsv \
    --answers-file ./playground/data/eval/mmbench/answers/$SPLIT/llava-v1.5-7b.jsonl \
    --single-pred-prompt \
    --temperature 0 \
    --conv-mode llava_v1

python llava_plus_torch/scripts/convert_mmbench_for_submission.py \
    --annotation-file ./playground/data/eval/mmbench/$SPLIT.tsv \
    --result-dir ./playground/data/eval/mmbench/answers/$SPLIT \
    --upload-dir ./playground/data/eval/mmbench/answers_upload/$SPLIT \
    --experiment llava-v1.5-7b
