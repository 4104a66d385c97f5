"""ScienceQA runner (ref llava/eval/model_vqa_science.py): multiple-choice
prompts with optional chain-of-thought, ``--single-pred-prompt`` appends the
answer-letter instruction.

The port's own copy of ``llava_plus_tpu/eval/model_vqa_science.py``, with ``--device``
(default ``cuda``: a CUDA device that is not there raises; ``--device cpu``
runs on the CPU).
"""

import argparse
import json
import os

from PIL import Image

from llava_plus_torch.constants import DEFAULT_IMAGE_TOKEN
from llava_plus_torch.conversation import conv_templates
from llava_plus_torch.eval.common import EvalSession, get_chunk, short_uuid
from llava_plus_torch.mm_utils import get_model_name_from_path


def eval_model(args, session=None):
    questions = json.load(open(os.path.expanduser(args.question_file)))
    questions = get_chunk(questions, args.num_chunks, args.chunk_idx)
    answers_file = os.path.expanduser(args.answers_file)
    os.makedirs(os.path.dirname(os.path.abspath(answers_file)), exist_ok=True)

    owned = session is None
    session = session or EvalSession(
        args.model_path, args.model_base, conv_mode=args.conv_mode,
        temperature=args.temperature, max_new_tokens=1024,
        num_beams=getattr(args, "num_beams", 1),
        engine_slots=getattr(args, "engine_slots", 0),
        device=getattr(args, "device", "cuda"),
    )
    model_name = get_model_name_from_path(args.model_path or "model")
    conv_t = conv_templates[args.conv_mode]
    stop = conv_t.sep2 or conv_t.sep

    def build(line):
        """(prompt, image, cur_prompt) for one question record."""
        question = line["conversations"][0]
        qs = question["value"].replace("<image>", "").strip()
        cur_prompt = qs

        image = None
        if "image" in line:
            image = Image.open(
                os.path.join(args.image_folder, line["image"])
            ).convert("RGB")
            qs = DEFAULT_IMAGE_TOKEN + "\n" + qs
            cur_prompt = "<image>" + "\n" + cur_prompt

        if args.single_pred_prompt:
            tail = ("Answer with the option's letter from the given "
                    "choices directly.")
            qs = qs + "\n" + tail
            cur_prompt = cur_prompt + "\n" + tail

        conv = conv_t.copy()
        conv.append_message(conv.roles[0], qs)
        conv.append_message(conv.roles[1], None)
        return conv.get_prompt(), image, cur_prompt

    cur_prompts = {}

    def items():
        for i, line in enumerate(questions):
            prompt, image, cur_prompt = build(line)
            cur_prompts[i] = cur_prompt
            yield prompt, image

    try:
        answers = session.answer_many(items(), stop_strings=[stop])
        if getattr(args, "answer_prompter", False):
            # CoT requery (ref model_vqa_science.py:97-120): re-generate
            # on prompt + reasoning + ' ###\nANSWER:' (64 tokens), final
            # text = reasoning + '\n The answer is ' + answer. Two batched
            # passes — pass 2's prompts depend on pass 1's outputs.
            reasonings = list(answers)

            def requery_items():
                for line, reasoning in zip(questions, reasonings):
                    prompt, image, _ = build(line)
                    yield prompt + reasoning + " ###\nANSWER:", image

            answers = (
                r + "\n The answer is " + a
                for r, a in zip(
                    reasonings,
                    session.answer_many(requery_items(),
                                        stop_strings=[stop],
                                        max_new_tokens=64),
                )
            )
        with open(answers_file, "w") as f:
            for i, (line, outputs) in enumerate(zip(questions, answers)):
                f.write(json.dumps({
                    "question_id": line["id"],
                    "prompt": cur_prompts.pop(i),
                    "text": outputs,
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
    parser.add_argument("--single-pred-prompt", action="store_true")
    parser.add_argument("--answer-prompter", action="store_true")
    parser.add_argument("--engine-slots", type=int, default=0,
                        help="answer through the continuous-batching "
                        "engine with this many concurrent slots (0 = "
                        "single-stream)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="the device to answer on (cuda, or cpu)")
    return parser


def main(argv=None):
    eval_model(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
