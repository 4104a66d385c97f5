#!/bin/bash
# Q-Bench eval, dev|test split as $1 (ref llava_plus_torch/scripts/v1_5/eval/qbench.sh).

if [ "$1" != "dev" ] && [ "$1" != "test" ]; then
    echo "Unknown split, please choose between 'dev' and 'test'."
    exit 1
fi

# >0: answer via the continuous-batching engine (see docs/Evaluation.md)
ENGINE_SLOTS=${ENGINE_SLOTS:-0}
python -m llava_plus_torch.eval.model_vqa_qbench \
        --engine-slots $ENGINE_SLOTS \
    --model-path ./checkpoints/llava-v1.5-7b \
    --image-folder ./playground/data/eval/qbench/images_llvisionqa/ \
    --questions-file ./playground/data/eval/qbench/llvisionqa_$1.json \
    --answers-file ./playground/data/eval/qbench/llvisionqa_$1_answers.jsonl \
    --conv-mode llava_v1 \
    --lang en
