#!/bin/bash
# MMBench-CN eval (ref llava_plus_torch/scripts/v1_5/eval/mmbench_cn.sh).

# >0: answer via the continuous-batching engine (see docs/Evaluation.md)
ENGINE_SLOTS=${ENGINE_SLOTS:-0}
CKPT="llava-v1.5-7b"
SPLIT="mmbench_dev_cn_20231003"

python -m llava_plus_torch.eval.model_vqa_mmbench \
        --engine-slots $ENGINE_SLOTS \
    --model-path ./checkpoints/$CKPT \
    --question-file ./playground/data/eval/mmbench_cn/$SPLIT.tsv \
    --answers-file ./playground/data/eval/mmbench_cn/answers/$SPLIT/$CKPT.jsonl \
    --lang cn \
    --single-pred-prompt \
    --temperature 0 \
    --conv-mode llava_v1

mkdir -p playground/data/eval/mmbench_cn/answers_upload/$SPLIT
python llava_plus_torch/scripts/convert_mmbench_for_submission.py \
    --annotation-file ./playground/data/eval/mmbench_cn/$SPLIT.tsv \
    --result-dir ./playground/data/eval/mmbench_cn/answers/$SPLIT \
    --upload-dir ./playground/data/eval/mmbench_cn/answers_upload/$SPLIT \
    --experiment $CKPT
