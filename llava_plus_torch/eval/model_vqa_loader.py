"""Chunked batch VQA runner (ref ``llava/eval/model_vqa_loader.py``).

CLI contract preserved: ``--model-path --question-file --answers-file
--num-chunks N --chunk-idx K``; JSONL answers with shortuuid answer ids so
the reference's merge + converter scripts work unchanged.

The port's own copy of ``llava_plus_tpu/eval/model_vqa_loader.py``, with ``--device``
(default ``cuda``: a CUDA device that is not there raises; ``--device cpu``
runs on the CPU).
"""

from __future__ import annotations

import argparse
import json
import os

from PIL import Image

from llava_plus_torch.constants import DEFAULT_IMAGE_TOKEN
from llava_plus_torch.conversation import conv_templates
from llava_plus_torch.eval.common import EvalSession, get_chunk, short_uuid
from llava_plus_torch.mm_utils import get_model_name_from_path


def build_prompt(question_text: str, conv_mode: str,
                 mm_use_im_start_end: bool = False) -> str:
    qs = question_text.replace(DEFAULT_IMAGE_TOKEN, "").strip()
    if mm_use_im_start_end:
        from llava_plus_torch.constants import (
            DEFAULT_IM_END_TOKEN, DEFAULT_IM_START_TOKEN,
        )

        qs = (DEFAULT_IM_START_TOKEN + DEFAULT_IMAGE_TOKEN
              + DEFAULT_IM_END_TOKEN + "\n" + qs)
    else:
        qs = DEFAULT_IMAGE_TOKEN + "\n" + qs
    conv = conv_templates[conv_mode].copy()
    conv.append_message(conv.roles[0], qs)
    conv.append_message(conv.roles[1], None)
    return conv.get_prompt()


def eval_model(args, session: EvalSession = None):
    questions = [
        json.loads(q) for q in open(os.path.expanduser(args.question_file))
    ]
    questions = get_chunk(questions, args.num_chunks, args.chunk_idx)
    answers_file = os.path.expanduser(args.answers_file)
    os.makedirs(os.path.dirname(os.path.abspath(answers_file)), exist_ok=True)

    owned = session is None
    session = session or EvalSession(
        args.model_path, args.model_base,
        conv_mode=args.conv_mode, temperature=args.temperature,
        top_p=args.top_p, max_new_tokens=args.max_new_tokens,
        num_beams=getattr(args, "num_beams", 1),
        engine_slots=getattr(args, "engine_slots", 0),
        device=getattr(args, "device", "cuda"),
    )
    model_name = get_model_name_from_path(args.model_path)

    stop = conv_templates[args.conv_mode].sep2 or conv_templates[args.conv_mode].sep

    def items():
        for line in questions:
            yield (build_prompt(line["text"], args.conv_mode),
                   Image.open(os.path.join(args.image_folder,
                                           line["image"])).convert("RGB"))

    try:
        with open(answers_file, "w") as f:
            for line, output in zip(
                questions, session.answer_many(items(), stop_strings=[stop])
            ):
                f.write(json.dumps({
                    "question_id": line["question_id"],
                    "prompt": line["text"],
                    "text": output,
                    "answer_id": short_uuid(),
                    "model_id": model_name,
                    "metadata": {},
                }) + "\n")
                f.flush()
    finally:
        if owned:
            session.close()


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", type=str, default=None)
    parser.add_argument("--model-base", type=str, default=None)
    parser.add_argument("--image-folder", type=str, default="")
    parser.add_argument("--question-file", type=str, required=True)
    parser.add_argument("--answers-file", type=str, required=True)
    parser.add_argument("--conv-mode", type=str, default="llava_v1")
    parser.add_argument("--num-chunks", type=int, default=1)
    parser.add_argument("--chunk-idx", type=int, default=0)
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--num-beams", "--num_beams", type=int, default=1,
                        dest="num_beams")
    parser.add_argument("--top_p", type=float, default=1.0)
    parser.add_argument("--max-new-tokens", "--max_new_tokens",
                        type=int, default=128, dest="max_new_tokens")
    parser.add_argument("--engine-slots", type=int, default=0,
                        help="answer through the continuous-batching "
                        "engine with this many concurrent slots (0 = "
                        "single-stream; greedy answers are identical)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="the device to answer on (cuda, or cpu)")
    return parser


def main(argv=None):
    eval_model(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
