#!/bin/bash
# Q-Bench-CN eval, dev|test split as $1 (ref llava_plus_torch/scripts/v1_5/eval/qbench_zh.sh).

if [ "$1" = "dev" ]; then
    ZH_SPLIT="验证集"
elif [ "$1" = "test" ]; then
    ZH_SPLIT="测试集"
else
    echo "Unknown split, please choose between 'dev' and 'test'."
    exit 1
fi

# >0: answer via the continuous-batching engine (see docs/Evaluation.md)
ENGINE_SLOTS=${ENGINE_SLOTS:-0}
python -m llava_plus_torch.eval.model_vqa_qbench \
        --engine-slots $ENGINE_SLOTS \
    --model-path ./checkpoints/llava-v1.5-7b \
    --image-folder ./playground/data/eval/qbench/images_llvisionqa/ \
    --questions-file "./playground/data/eval/qbench/质衡-问答-$ZH_SPLIT.json" \
    --answers-file ./playground/data/eval/qbench/llvisionqa_zh_$1_answers.jsonl \
    --conv-mode llava_v1 \
    --lang zh
