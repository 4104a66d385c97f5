#!/bin/bash
# LLaVA-Bench (in-the-wild) with GPT-4 pairwise review
# (ref llava_plus_torch/scripts/v1_5/eval/llavabench.sh).

# >0: answer via the continuous-batching engine (see docs/Evaluation.md)
ENGINE_SLOTS=${ENGINE_SLOTS:-0}
CKPT="llava-v1.5-7b"
B=./playground/data/eval/llava-bench-in-the-wild

python -m llava_plus_torch.eval.model_vqa \
        --engine-slots $ENGINE_SLOTS \
    --model-path ./checkpoints/$CKPT \
    --question-file $B/questions.jsonl \
    --image-folder $B/images \
    --answers-file $B/answers/$CKPT.jsonl \
    --temperature 0 \
    --conv-mode llava_v1

mkdir -p $B/reviews
python -m llava_plus_torch.eval.eval_gpt_review_bench \
    --question $B/questions.jsonl \
    --context $B/context.jsonl \
    --rule llava_plus_torch/eval/table/rule.json \
    --answer-list $B/answers_gpt4.jsonl $B/answers/$CKPT.jsonl \
    --output $B/reviews/$CKPT.jsonl

python -m llava_plus_torch.eval.summarize_gpt_review -f $B/reviews/$CKPT.jsonl
