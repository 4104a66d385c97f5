"""Deployment predictor (the port's counterpart of ``predict.py``, the
Replicate-style ``Predictor`` that ``cog.yaml`` names).

Loads a LLaVA checkpoint from a local directory with the port's loader and
streams answers to an image prompt over the single-stream
:class:`~llava_plus_torch.generate.Generator`. It runs on the card unless
the caller asks for the CPU (``Predictor(device="cpu")``):

    python -m llava_plus_torch.predict --weights DIR --image x.png \\
        --prompt "What is shown?" [--device cuda|cpu]
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

DEFAULT_WEIGHTS = os.environ.get(
    "LLAVA_WEIGHTS", "./checkpoints/llava-v1.5-13b"
)


class Predictor:
    def __init__(self, device: str = "cuda"):
        self.device = device

    def setup(self, weights: Optional[str] = None) -> None:
        import torch

        from llava_plus_torch.generate import Generator
        from llava_plus_torch.mm_utils import get_model_name_from_path
        from llava_plus_torch.models.builder import load_pretrained_model
        from llava_plus_torch.models.convert import tree_map

        if torch.device(self.device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device!r}: no CUDA device is available; "
                               "ask for the CPU with Predictor(device='cpu')")
        path = weights or DEFAULT_WEIGHTS
        name = get_model_name_from_path(path)
        (self.tokenizer, params, self.cfg, self.image_processor,
         context_len) = load_pretrained_model(path, model_name=name)
        self.generator = Generator(
            tree_map(lambda x: x.to(self.device), params), self.cfg, self.tokenizer,
            self.image_processor, device=self.device, max_seq_len=context_len,
        )

    def prompt(self, prompt: str):
        """(the conversation's prompt text, its stop string) for one image
        question in the ``llava_v1`` template."""
        from llava_plus_torch.conversation import SeparatorStyle, conv_templates

        conv = conv_templates["llava_v1"].copy()
        conv.append_message(conv.roles[0], "<image>\n" + prompt)
        conv.append_message(conv.roles[1], None)
        stop = conv.sep if conv.sep_style != SeparatorStyle.TWO else conv.sep2
        return conv.get_prompt(), stop

    def predict(
        self,
        image: str,
        prompt: str,
        top_p: float = 1.0,
        temperature: float = 0.2,
        max_tokens: int = 1024,
    ) -> Iterator[str]:
        """Stream the answer to a visual prompt (image = path or URL)."""
        from llava_plus_torch.mm_utils import process_images
        from llava_plus_torch.serve.cli import load_image

        images = process_images([load_image(image)], self.image_processor, self.cfg)
        text_prompt, stop = self.prompt(prompt)

        prev = 0
        for text in self.generator.stream(
            text_prompt, images=images,
            max_new_tokens=max_tokens, temperature=temperature, top_p=top_p,
            stop_strings=[stop] if stop else [],
        ):
            yield text[prev:]
            prev = len(text)


def build_parser():
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--weights", type=str, default=None)
    parser.add_argument("--image", type=str, required=True)
    parser.add_argument("--prompt", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda",
                        help="the device to answer on (cpu only when asked for)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    p = Predictor(device=args.device)
    p.setup(args.weights)
    for piece in p.predict(args.image, args.prompt):
        print(piece, end="", flush=True)
    print()


if __name__ == "__main__":
    main()
