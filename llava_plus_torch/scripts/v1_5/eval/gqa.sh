#!/bin/bash
# GQA eval with data-parallel chunking (ref llava_plus_torch/scripts/v1_5/eval/gqa.sh).

CKPT="llava-v1.5-7b"
SPLIT="llava_gqa_testdev_balanced"
GQADIR="./playground/data/eval/gqa/data"
CHUNKS=${CHUNKS:-1}
# >0: answer via the continuous-batching engine (see docs/Evaluation.md)
ENGINE_SLOTS=${ENGINE_SLOTS:-0}

for IDX in $(seq 0 $((CHUNKS-1))); do
    python -m llava_plus_torch.eval.model_vqa_loader \
        --engine-slots $ENGINE_SLOTS \
        --model-path ./checkpoints/$CKPT \
        --question-file ./playground/data/eval/gqa/$SPLIT.jsonl \
        --image-folder ./playground/data/eval/gqa/data/images \
        --answers-file ./playground/data/eval/gqa/answers/$SPLIT/$CKPT/${CHUNKS}_${IDX}.jsonl \
        --num-chunks $CHUNKS \
        --chunk-idx $IDX \
        --temperature 0 \
        --conv-mode llava_v1 &
done
wait

output_file=./playground/data/eval/gqa/answers/$SPLIT/$CKPT/merge.jsonl
> "$output_file"
for IDX in $(seq 0 $((CHUNKS-1))); do
    cat ./playground/data/eval/gqa/answers/$SPLIT/$CKPT/${CHUNKS}_${IDX}.jsonl >> "$output_file"
done

python llava_plus_torch/scripts/convert_gqa_for_eval.py --src $output_file \
    --dst $GQADIR/testdev_balanced_predictions.json
(cd $GQADIR && python eval/eval.py --tier testdev_balanced)
