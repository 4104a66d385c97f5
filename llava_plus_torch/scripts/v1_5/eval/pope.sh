#!/bin/bash
# POPE eval (ref llava_plus_torch/scripts/v1_5/eval/pope.sh).

# >0: answer via the continuous-batching engine (see docs/Evaluation.md)
ENGINE_SLOTS=${ENGINE_SLOTS:-0}
python -m llava_plus_torch.eval.model_vqa_loader \
        --engine-slots $ENGINE_SLOTS \
    --model-path ./checkpoints/llava-v1.5-7b \
    --question-file ./playground/data/eval/pope/llava_pope_test.jsonl \
    --image-folder ./playground/data/eval/pope/val2014 \
    --answers-file ./playground/data/eval/pope/answers/llava-v1.5-7b.jsonl \
    --temperature 0 \
    --conv-mode llava_v1

python -m llava_plus_torch.eval.eval_pope \
    --annotation-dir ./playground/data/eval/pope/coco \
    --question-file ./playground/data/eval/pope/llava_pope_test.jsonl \
    --result-file ./playground/data/eval/pope/answers/llava-v1.5-7b.jsonl
