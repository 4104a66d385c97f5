#!/bin/bash
# MM-Vet eval (ref llava_plus_torch/scripts/v1_5/eval/mmvet.sh).

# >0: answer via the continuous-batching engine (see docs/Evaluation.md)
ENGINE_SLOTS=${ENGINE_SLOTS:-0}
CKPT="llava-v1.5-7b"

python -m llava_plus_torch.eval.model_vqa \
        --engine-slots $ENGINE_SLOTS \
    --model-path ./checkpoints/$CKPT \
    --question-file ./playground/data/eval/mm-vet/llava-mm-vet.jsonl \
    --image-folder ./playground/data/eval/mm-vet/images \
    --answers-file ./playground/data/eval/mm-vet/answers/$CKPT.jsonl \
    --temperature 0 \
    --conv-mode llava_v1

mkdir -p ./playground/data/eval/mm-vet/results
python llava_plus_torch/scripts/convert_mmvet_for_eval.py \
    --src ./playground/data/eval/mm-vet/answers/$CKPT.jsonl \
    --dst ./playground/data/eval/mm-vet/results/$CKPT.json
