#!/bin/bash
# VizWiz eval (ref llava_plus_torch/scripts/v1_5/eval/vizwiz.sh).

# >0: answer via the continuous-batching engine (see docs/Evaluation.md)
ENGINE_SLOTS=${ENGINE_SLOTS:-0}
CKPT="llava-v1.5-7b"

python -m llava_plus_torch.eval.model_vqa_loader \
        --engine-slots $ENGINE_SLOTS \
    --model-path ./checkpoints/$CKPT \
    --question-file ./playground/data/eval/vizwiz/llava_test.jsonl \
    --image-folder ./playground/data/eval/vizwiz/test \
    --answers-file ./playground/data/eval/vizwiz/answers/$CKPT.jsonl \
    --temperature 0 \
    --conv-mode llava_v1

python llava_plus_torch/scripts/convert_vizwiz_for_submission.py \
    --annotation-file ./playground/data/eval/vizwiz/llava_test.jsonl \
    --result-file ./playground/data/eval/vizwiz/answers/$CKPT.jsonl \
    --result-upload-file ./playground/data/eval/vizwiz/answers_upload/$CKPT.json
