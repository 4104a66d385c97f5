"""Q-Bench runner (ref llava/eval/model_vqa_qbench.py): low-level vision
multiple-choice over a JSON of {img_path, question, candidates}.

The port's own copy of ``llava_plus_tpu/eval/model_vqa_qbench.py``, with ``--device``
(default ``cuda``: a CUDA device that is not there raises; ``--device cpu``
runs on the CPU).
"""

import argparse
import json
import os

from PIL import Image

from llava_plus_torch.constants import DEFAULT_IMAGE_TOKEN
from llava_plus_torch.conversation import conv_templates
from llava_plus_torch.eval.common import EvalSession


def eval_model(args, session=None):
    with open(args.questions_file) as f:
        llvqa_data = json.load(f)

    owned = session is None
    session = session or EvalSession(
        args.model_path, args.model_base, conv_mode=args.conv_mode,
        temperature=0.0, max_new_tokens=64,
        engine_slots=getattr(args, "engine_slots", 0),
        device=getattr(args, "device", "cuda"),
    )
    conv_t = conv_templates[args.conv_mode]
    stop = conv_t.sep2 or conv_t.sep

    def items():
        for llddata in llvqa_data:
            if args.lang == "en":
                message = (llddata["question"]
                           + "\nChoose between one of the options as follows:")
            elif args.lang == "zh":
                message = llddata["question"] + "\在下列选项中选择一个:"
            else:
                raise NotImplementedError(
                    "Q-Bench does not support languages other than en and "
                    "zh yet."
                )
            for choice, ans in zip(["A.", "B.", "C.", "D."],
                                   llddata["candidates"]):
                message += f"\n{choice} {ans}"
            qs = DEFAULT_IMAGE_TOKEN + "\n" + message

            conv = conv_t.copy()
            conv.append_message(conv.roles[0], qs)
            conv.append_message(conv.roles[1], None)
            image = Image.open(
                os.path.join(args.image_folder, llddata["img_path"])
            ).convert("RGB")
            yield conv.get_prompt(), image

    try:
        for llddata, outputs in zip(
            llvqa_data, session.answer_many(items(), stop_strings=[stop])
        ):
            llddata["response"] = outputs
        with open(args.answers_file, "w") as wf:
            json.dump(llvqa_data, wf, indent=2)
    finally:
        if owned:
            session.close()


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", type=str, default=None)
    parser.add_argument("--model-base", type=str, default=None)
    parser.add_argument("--image-folder", type=str, default="")
    parser.add_argument("--questions-file", type=str, required=True)
    parser.add_argument("--answers-file", type=str, required=True)
    parser.add_argument("--conv-mode", type=str, default="llava_v1")
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
