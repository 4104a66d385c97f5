"""Text-only QA runner (ref llava/eval/model_qa.py).

The port's own copy of ``llava_plus_tpu/eval/model_qa.py``, with ``--device``
(default ``cuda``: a CUDA device that is not there raises; ``--device cpu``
runs on the CPU).
"""

import argparse
import json
import os

from llava_plus_torch.conversation import conv_templates
from llava_plus_torch.eval.common import EvalSession, short_uuid


def eval_model(args, session=None):
    questions = [json.loads(line) for line in open(
        os.path.expanduser(args.question_file)
    )]
    owned = session is None
    session = session or EvalSession(
        args.model_path, conv_mode=args.conv_mode, max_new_tokens=1024,
        engine_slots=getattr(args, "engine_slots", 0),
        device=getattr(args, "device", "cuda"),
    )
    answers_file = os.path.expanduser(args.answers_file)
    os.makedirs(os.path.dirname(os.path.abspath(answers_file)), exist_ok=True)
    conv_t = conv_templates[args.conv_mode]
    stop = conv_t.sep2 or conv_t.sep

    def items():
        for q in questions:
            conv = conv_t.copy()
            conv.append_message(conv.roles[0], q["text"])
            conv.append_message(conv.roles[1], None)
            yield conv.get_prompt(), None

    try:
        with open(answers_file, "w") as f:
            for q, output in zip(
                questions, session.answer_many(items(), stop_strings=[stop])
            ):
                f.write(json.dumps({
                    "question_id": q["question_id"],
                    "text": output,
                    "answer_id": short_uuid(),
                    "model_id": args.model_path or "model",
                    "metadata": {},
                }) + "\n")
    finally:
        if owned:
            session.close()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", "--model-name", type=str,
                        default=None, dest="model_path")
    parser.add_argument("--question-file", type=str, required=True)
    parser.add_argument("--answers-file", type=str, required=True)
    parser.add_argument("--conv-mode", type=str, default="v1")
    parser.add_argument("--engine-slots", type=int, default=0,
                        help="answer through the continuous-batching "
                        "engine with this many concurrent slots (0 = "
                        "single-stream)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="the device to answer on (cuda, or cpu)")
    eval_model(parser.parse_args(argv))


if __name__ == "__main__":
    main()
