"""Interactive chat on the command line (the reference's
``llava/serve/cli.py``; the port's counterpart of
``llava_plus_tpu/serve/cli.py``): load a checkpoint, pick the conversation
template from the model's name, and stream answers about an image over the
single-stream :class:`~llava_plus_torch.generate.Generator`.

    python -m llava_plus_torch.serve.cli --model-path DIR --image-file x.png \\
        [--temperature 0] [--max-new-tokens 512] [--device cuda|cpu]

An empty line (or the end of the input) ends the chat. ``--device`` is
``cuda`` unless the caller asks for ``cpu``; there is no fallback.
"""

from __future__ import annotations

import argparse
from io import BytesIO

from PIL import Image

from llava_plus_torch.constants import (
    DEFAULT_IM_END_TOKEN,
    DEFAULT_IM_START_TOKEN,
    DEFAULT_IMAGE_TOKEN,
)
from llava_plus_torch.conversation import SeparatorStyle, conv_templates
from llava_plus_torch.mm_utils import get_model_name_from_path, process_images


def load_image(image_file: str) -> Image.Image:
    if image_file.startswith(("http://", "https://")):
        import requests

        return Image.open(BytesIO(requests.get(image_file).content)).convert("RGB")
    return Image.open(image_file).convert("RGB")


def pick_conv_mode(model_name: str) -> str:
    """The conversation template for a model's name (the reference's
    cli.py:34-46)."""
    name = model_name.lower()
    if "llama-2" in name:
        return "llava_llama_2"
    if "v1" in name:
        return "llava_v1"
    if "mpt" in name:
        return "mpt"
    return "llava_v0"


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--model-path", type=str, required=True)
    parser.add_argument("--model-base", type=str, default=None)
    parser.add_argument("--image-file", type=str, default=None)
    parser.add_argument("--conv-mode", type=str, default=None)
    parser.add_argument("--temperature", type=float, default=0.2)
    parser.add_argument("--max-new-tokens", type=int, default=512)
    parser.add_argument("--debug", action="store_true")
    return parser.parse_args(argv)


def main(argv=None):
    import torch

    from llava_plus_torch.generate import Generator
    from llava_plus_torch.models.builder import load_pretrained_model
    from llava_plus_torch.models.convert import tree_map

    args = parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available; pass "
                         "--device cpu to run on the CPU")
    model_name = get_model_name_from_path(args.model_path)
    tokenizer, params, cfg, image_processor, context_len = load_pretrained_model(
        args.model_path, args.model_base, model_name)
    gen = Generator(tree_map(lambda x: x.to(args.device), params), cfg, tokenizer,
                    image_processor, device=args.device, max_seq_len=context_len)

    conv = conv_templates[args.conv_mode or pick_conv_mode(model_name)].copy()
    roles = conv.roles
    image_arrays = None
    if args.image_file:
        image_arrays = process_images([load_image(args.image_file)], image_processor, cfg)

    first_turn = True
    while True:
        try:
            inp = input(f"{roles[0]}: ")
        except EOFError:
            inp = ""
        if not inp:
            print("exit...")
            break
        print(f"{roles[1]}: ", end="", flush=True)
        if image_arrays is not None and first_turn:
            if cfg.mm_use_im_start_end:
                inp = (DEFAULT_IM_START_TOKEN + DEFAULT_IMAGE_TOKEN + DEFAULT_IM_END_TOKEN
                       + "\n" + inp)
            else:
                inp = DEFAULT_IMAGE_TOKEN + "\n" + inp
            first_turn = False
        conv.append_message(conv.roles[0], inp)
        conv.append_message(conv.roles[1], None)
        prompt = conv.get_prompt()
        stop_str = conv.sep if conv.sep_style != SeparatorStyle.TWO else conv.sep2
        shown, text = 0, ""
        for text in gen.stream(prompt, images=image_arrays, max_new_tokens=args.max_new_tokens,
                               temperature=args.temperature,
                               stop_strings=[stop_str] if stop_str else []):
            print(text[shown:], end="", flush=True)
            shown = len(text)
        print()
        conv.messages[-1][-1] = text
        if args.debug:
            print("\n", {"prompt": prompt, "outputs": text}, "\n")


if __name__ == "__main__":
    main()
