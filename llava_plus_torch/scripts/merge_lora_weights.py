"""Merge a LoRA checkpoint into its base and export HF format (the port's
copy of ``scripts/merge_lora_weights.py``).

    python llava_plus_torch/scripts/merge_lora_weights.py --model-path LORA_DIR \\
        --model-base BASE_DIR --save-model-path OUT_DIR
"""

import sys
from pathlib import Path

# allow running as `python llava_plus_torch/scripts/<name>.py` without installing the package
sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


import argparse

from llava_plus_torch.mm_utils import get_model_name_from_path
from llava_plus_torch.models.builder import load_pretrained_model
from llava_plus_torch.train.checkpoint import export_hf_llava


def merge_lora(args):
    model_name = get_model_name_from_path(args.model_path)
    tokenizer, params, cfg, _proc, _ctx = load_pretrained_model(
        args.model_path, args.model_base, model_name
    )
    export_hf_llava(params, cfg, args.save_model_path, tokenizer)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", type=str, required=True)
    parser.add_argument("--model-base", type=str, required=True)
    parser.add_argument("--save-model-path", type=str, required=True)
    return parser


if __name__ == "__main__":
    merge_lora(build_parser().parse_args())
