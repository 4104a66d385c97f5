#!/bin/bash
# MME eval (ref llava_plus_torch/scripts/v1_5/eval/mme.sh). The scorer is MME's own
# eval_tool; this driver produces the answers it consumes.

# >0: answer via the continuous-batching engine (see docs/Evaluation.md)
ENGINE_SLOTS=${ENGINE_SLOTS:-0}
CKPT="llava-v1.5-7b"

python -m llava_plus_torch.eval.model_vqa_loader \
        --engine-slots $ENGINE_SLOTS \
    --model-path ./checkpoints/$CKPT \
    --question-file ./playground/data/eval/MME/llava_mme.jsonl \
    --image-folder ./playground/data/eval/MME/MME_Benchmark_release_version \
    --answers-file ./playground/data/eval/MME/answers/$CKPT.jsonl \
    --temperature 0 \
    --conv-mode llava_v1

(cd ./playground/data/eval/MME && \
    python convert_answer_to_mme.py --experiment $CKPT && \
    cd eval_tool && python calculation.py --results_dir answers/$CKPT)
