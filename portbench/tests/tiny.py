"""A temporary copy of the benchmark with tiny cells, for CPU tests: the
files are added beside the real ones, as a later change adds a cell."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent

VISION = {"hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2,
          "num_attention_heads": 2, "image_size": 28, "patch_size": 14,
          "layer_norm_eps": 1e-05, "hidden_act": "quick_gelu"}

CONFIGS = {
    "tiny-mpt": {
        "name": "tiny-mpt", "source": "test", "family": "mpt", "d_model": 64, "n_heads": 4,
        "n_layers": 2, "expansion_ratio": 2, "max_seq_len": 256, "vocab_size": 512,
        "no_bias": True, "logit_scale": None,
        "attn_config": {"attn_type": "multihead_attention", "alibi": True, "alibi_bias_max": 8,
                        "qk_ln": False, "clip_qkv": None, "softmax_scale": None,
                        "prefix_lm": False, "attn_uses_sequence_id": False},
        "mm_hidden_size": 32, "mm_projector_type": "linear", "mm_vision_select_layer": -2,
        "mm_use_im_start_end": True, "vision": VISION,
        "tokenizer": {"bos_token_id": None,
                      "specials": {"<|im_start|>": 500, "<|im_end|>": 501,
                                   "<im_start>": 502, "<im_end>": 503}},
        "template": "<|im_start|> w9 w10 <|im_end|> <|im_start|> w11 <image> {question} "
                    "<|im_end|> <|im_start|> w12",
        "reduced": [],
    },
    "tiny-llama": {
        "name": "tiny-llama", "source": "test", "family": "llama", "hidden_size": 64,
        "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 2, "vocab_size": 512, "max_position_embeddings": 256,
        "rms_norm_eps": 1e-05, "rope_theta": 10000.0, "tie_word_embeddings": False,
        "mm_hidden_size": 32, "mm_projector_type": "mlp2x_gelu", "mm_vision_select_layer": -2,
        "mm_use_im_start_end": False, "image_aspect_ratio": "pad", "vision": VISION,
        "tokenizer": {"bos_token_id": 1, "specials": {"[INST]": 5, "[/INST]": 6}},
        "template": "[INST] <image> {question} [/INST]",
        "reduced": [],
    },
}

MIX = {"loop": "closed", "clients": 6, "block": 8, "set_seed": 3,
       "question_tokens": {"dist": "uniform_int", "lo": 2, "hi": 6},
       "output_tokens": {"dist": "lognormal", "median": 6, "sigma": 0.5, "lo": 2, "hi": 12},
       "images": 4, "ramp_seconds": 0.2}

OPEN_MIX = dict(MIX, loop="open", rate=20.0, clients=16, arrivals={"dist": "gamma", "cv": 2.0},
                drain_seconds=30)

CELL = {"kind": "serve",
        "engine": {"quantize": "int8", "kv_int8": True, "decode_chunk": 4, "max_seq_len": 256,
                   "max_slots": 4, "warmup_len": 40},
        "warm_requests": 2, "max_requests_per_s": 4,
        "check": {"answers": 3, "served_logit_gap": 0.05}}


def make(tmp: Path, configs=("tiny-mpt", "tiny-llama")) -> Path:
    """A checkout-like directory: the benchmark's files, ``BENCHMARK.json``
    with a tiny cell of each configuration added, and the program linked in."""
    root = tmp / "checkout"
    shutil.copytree(BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (root / "llava_plus_torch").symlink_to(ROOT / "llava_plus_torch")
    for name in configs:
        cfg = CONFIGS[name]
        (root / "portbench" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "test", "reduced": [], "why": "test",
                                 "file": f"portbench/configs/{name}.json"})
        for kind, like, mix in (("describe", "mpt7b.describe", "tiny"),
                                ("vqa", "mistral7b.vqa", "tiny_open")):
            cell = f"{name}.{kind}"
            (root / "portbench" / "cells" / f"{cell}.json").write_text(json.dumps(CELL))
            bench["workloads"].append({"name": cell, "config": name, "traffic": mix,
                                       "chips": 1, "why": "test"})
            for m in bench["end_to_end"] + bench["per_layer"]:
                if "workloads" in m and like in m["workloads"]:
                    m["workloads"].append(cell)
            if kind == "vqa":  # the open loop's tails, as a cell that adds them lists them
                bench["end_to_end"] += [
                    {"name": n, "unit": "ms", "better": "lower", "bound": 0.25,
                     "source": "host_clock", "workloads": [cell]}
                    for n in ("serve.ttft_p95_ms", "serve.tpot_p95_ms")]
    (root / "portbench" / "traffic" / "tiny.json").write_text(json.dumps(MIX))
    (root / "portbench" / "traffic" / "tiny_open.json").write_text(json.dumps(OPEN_MIX))
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


# sizes the card's kernels take (head dim 128; K a multiple of 128, N of 64)
NARROW_VISION = dict(VISION, hidden_size=256, intermediate_size=1024, num_attention_heads=4,
                     num_hidden_layers=4, image_size=224)
CONFIGS["narrow-mpt"] = dict(
    CONFIGS["tiny-mpt"], name="narrow-mpt", d_model=512, n_heads=4, n_layers=4,
    expansion_ratio=4, max_seq_len=1024, vocab_size=4096, mm_hidden_size=256,
    vision=NARROW_VISION,
    tokenizer={"bos_token_id": None, "specials": {"<|im_start|>": 4000, "<|im_end|>": 4001,
                                                  "<im_start>": 4002, "<im_end>": 4003}})
CONFIGS["narrow-llama"] = dict(
    CONFIGS["tiny-llama"], name="narrow-llama", hidden_size=512, intermediate_size=1792,
    num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=1, vocab_size=4096,
    max_position_embeddings=1024, rope_theta=1e6, mm_hidden_size=256,
    vision=dict(NARROW_VISION, image_size=336))
NARROW_CELL = dict(CELL, engine=dict(CELL["engine"], max_seq_len=1024, max_slots=8,
                                     warmup_len=620),
                   check={"answers": 4, "served_logit_gap": 1.0})
