"""Extract mm_projector weights from a full checkpoint (the port's copy of
``scripts/extract_mm_projector.py``).

    python llava_plus_torch/scripts/extract_mm_projector.py --model-path DIR \\
        --output OUT/mm_projector.bin
"""

import sys
from pathlib import Path

# allow running as `python llava_plus_torch/scripts/<name>.py` without installing the package
sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


import argparse
import os

import torch

from llava_plus_torch.models.hf_import import load_state_dict_dir

PREFIX = "model.mm_projector."


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Extract MMProjector weights"
    )
    parser.add_argument("--model-path", type=str, required=True)
    parser.add_argument("--output", type=str, required=True)
    return parser


def extract(model_path: str, output: str) -> dict:
    """Write the checkpoint's ``model.mm_projector.*`` tensors, as stored,
    to ``output`` with ``torch.save``; return them."""
    sd = load_state_dict_dir(model_path)
    proj = {k: v for k, v in sd.items() if k.startswith(PREFIX)}
    assert proj, f"no {PREFIX}* keys found in {model_path}"
    os.makedirs(os.path.dirname(os.path.abspath(output)), exist_ok=True)
    torch.save(proj, output)
    return proj


if __name__ == "__main__":
    args = build_parser().parse_args()
    extract(args.model_path, args.output)
