"""MMBench runner (ref llava/eval/model_vqa_mmbench.py): TSV input with
base64 images, multiple-choice option rotation (``--all-rounds``).

The port's own copy of ``llava_plus_tpu/eval/model_vqa_mmbench.py``, with ``--device``
(default ``cuda``: a CUDA device that is not there raises; ``--device cpu``
runs on the CPU).
"""

import argparse
import base64
import json
import math
import os
from io import BytesIO

from PIL import Image

from llava_plus_torch.constants import DEFAULT_IMAGE_TOKEN
from llava_plus_torch.conversation import conv_templates
from llava_plus_torch.eval.common import EvalSession, short_uuid
from llava_plus_torch.mm_utils import get_model_name_from_path

all_options = ["A", "B", "C", "D"]


def split_list(lst, n):
    chunk_size = math.ceil(len(lst) / n)
    return [lst[i : i + chunk_size] for i in range(0, len(lst), chunk_size)]


def get_chunk(lst, n, k):
    return split_list(lst, n)[k]


def is_none(value):
    if value is None:
        return True
    if isinstance(value, float) and math.isnan(value):
        return True
    if isinstance(value, str) and value.lower() in ("nan", "none"):
        return True
    return False


def get_options(row, options):
    parsed_options = []
    for option in options:
        option_value = row[option]
        if is_none(option_value):
            break
        parsed_options.append(option_value)
    return parsed_options


def load_image_from_base64(image):
    return Image.open(BytesIO(base64.b64decode(image)))


def eval_model(args, session=None):
    import pandas as pd

    questions = pd.read_table(os.path.expanduser(args.question_file))
    questions = get_chunk(questions.to_dict("records"), args.num_chunks,
                          args.chunk_idx)
    answers_file = os.path.expanduser(args.answers_file)
    os.makedirs(os.path.dirname(os.path.abspath(answers_file)), exist_ok=True)

    owned = session is None
    session = session or EvalSession(
        args.model_path, args.model_base, conv_mode=args.conv_mode,
        temperature=args.temperature, max_new_tokens=128,
        top_p=getattr(args, 'top_p', None) or 1.0,
        num_beams=getattr(args, "num_beams", 1),
        engine_slots=getattr(args, "engine_slots", 0),
        device=getattr(args, "device", "cuda"),
    )
    model_name = get_model_name_from_path(args.model_path or "model")
    conv_t = conv_templates[args.conv_mode]
    stop = conv_t.sep2 or conv_t.sep

    def work():
        """(answer-row metadata, prompt, image) per circular round. The
        rounds only rotate options deterministically — no round depends
        on a previous answer — so all (question, round) pairs are
        independent and batch through answer_many."""
        for row in questions:
            options = get_options(row, all_options)
            cur_option_char = all_options[: len(options)]
            num_rounds = len(options) if args.all_rounds else 1
            for round_idx in range(num_rounds):
                question = row["question"]
                hint = row["hint"]
                if not is_none(hint):
                    question = hint + "\n" + question
                for option_char, option in zip(all_options[: len(options)],
                                               options):
                    question = question + "\n" + option_char + ". " + option
                qs = DEFAULT_IMAGE_TOKEN + "\n" + question
                if args.single_pred_prompt:
                    if args.lang == "cn":
                        qs = qs + "\n" + "请直接回答选项字母。"
                    else:
                        qs = qs + "\n" + ("Answer with the option's letter "
                                          "from the given choices directly.")

                conv = conv_t.copy()
                conv.append_message(conv.roles[0], qs)
                conv.append_message(conv.roles[1], None)
                meta = {
                    "question_id": row["index"],
                    "round_id": round_idx,
                    "prompt": question,
                    "options": list(options),
                    "option_char": list(cur_option_char),
                }
                image = load_image_from_base64(row["image"]).convert("RGB")
                yield meta, conv.get_prompt(), image
                # rotate options for the next round
                options = options[1:] + options[:1]
                cur_option_char = cur_option_char[1:] + cur_option_char[:1]

    metas = []

    def items():
        for meta, prompt, image in work():
            metas.append(meta)
            yield prompt, image

    try:
        with open(answers_file, "w") as f:
            for i, outputs in enumerate(
                session.answer_many(items(), stop_strings=[stop])
            ):
                meta = metas[i]
                f.write(json.dumps({
                    **meta,
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
    parser.add_argument("--question-file", type=str, required=True)
    parser.add_argument("--answers-file", type=str, required=True)
    parser.add_argument("--conv-mode", type=str, default="llava_v1")
    parser.add_argument("--num-chunks", type=int, default=1)
    parser.add_argument("--chunk-idx", type=int, default=0)
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--num-beams", "--num_beams", type=int, default=1,
                        dest="num_beams")
    parser.add_argument("--top_p", type=float, default=None)
    parser.add_argument("--all-rounds", action="store_true")
    parser.add_argument("--single-pred-prompt", action="store_true")
    parser.add_argument("--lang", type=str, default="en")
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
