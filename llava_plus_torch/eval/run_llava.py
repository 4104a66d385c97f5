"""Single-prompt runner (ref llava/eval/run_llava.py): file/URL images,
``--sep``-separated multi-image with IMAGE_PLACEHOLDER support.

The port's own copy of ``llava_plus_tpu/eval/run_llava.py``, with ``--device``
(default ``cuda``: a CUDA device that is not there raises; ``--device cpu``
runs on the CPU).
"""

import argparse
import re
from io import BytesIO

from PIL import Image

from llava_plus_torch.constants import (
    DEFAULT_IM_END_TOKEN,
    DEFAULT_IM_START_TOKEN,
    DEFAULT_IMAGE_TOKEN,
    IMAGE_PLACEHOLDER,
)
from llava_plus_torch.conversation import SeparatorStyle, conv_templates
from llava_plus_torch.eval.common import EvalSession
from llava_plus_torch.mm_utils import get_model_name_from_path


def load_image(image_file):
    if image_file.startswith(("http://", "https://")):
        import requests

        response = requests.get(image_file)
        return Image.open(BytesIO(response.content)).convert("RGB")
    return Image.open(image_file).convert("RGB")


def image_parser(args):
    return args.image_file.split(args.sep)


def eval_model(args, session=None):
    model_name = get_model_name_from_path(args.model_path or "model")

    qs = args.query
    image_token_se = (
        DEFAULT_IM_START_TOKEN + DEFAULT_IMAGE_TOKEN + DEFAULT_IM_END_TOKEN
    )
    if IMAGE_PLACEHOLDER in qs:
        if args.mm_use_im_start_end:
            qs = re.sub(IMAGE_PLACEHOLDER, image_token_se, qs)
        else:
            qs = re.sub(IMAGE_PLACEHOLDER, DEFAULT_IMAGE_TOKEN, qs)
    else:
        if args.mm_use_im_start_end:
            qs = image_token_se + "\n" + qs
        else:
            qs = DEFAULT_IMAGE_TOKEN + "\n" + qs

    if args.conv_mode is None:
        name = model_name.lower()
        if "llama-2" in name:
            conv_mode = "llava_llama_2"
        elif "v1" in name:
            conv_mode = "llava_v1"
        elif "mpt" in name:
            conv_mode = "mpt"
        else:
            conv_mode = "llava_v0"
    else:
        conv_mode = args.conv_mode

    conv = conv_templates[conv_mode].copy()
    conv.append_message(conv.roles[0], qs)
    conv.append_message(conv.roles[1], None)
    prompt = conv.get_prompt()

    image_files = image_parser(args)
    images = [load_image(f) for f in image_files]

    session = session or EvalSession(
        args.model_path, args.model_base, conv_mode=conv_mode,
        temperature=args.temperature, top_p=args.top_p,
        max_new_tokens=args.max_new_tokens,
        num_beams=getattr(args, "num_beams", 1),
        device=getattr(args, "device", "cuda"),
    )
    stop = conv.sep if conv.sep_style != SeparatorStyle.TWO else conv.sep2
    outputs = session.answer(prompt, images[0] if images else None,
                             stop_strings=[stop] if stop else [])
    print(outputs)
    return outputs


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", type=str, required=True)
    parser.add_argument("--model-base", type=str, default=None)
    parser.add_argument("--image-file", type=str, required=True)
    parser.add_argument("--query", type=str, required=True)
    parser.add_argument("--conv-mode", type=str, default=None)
    parser.add_argument("--sep", type=str, default=",")
    parser.add_argument("--temperature", type=float, default=0.2)
    parser.add_argument("--top_p", type=float, default=None)
    parser.add_argument("--max_new_tokens", type=int, default=512)
    parser.add_argument("--num-beams", "--num_beams", type=int, default=1,
                        dest="num_beams")
    parser.add_argument("--mm-use-im-start-end", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="the device to answer on (cuda, or cpu)")
    return eval_model(parser.parse_args(argv))


if __name__ == "__main__":
    main()
