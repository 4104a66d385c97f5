"""Deterministic word-hash tokenizer for --tiny-debug-model runs (the port's
own copy of ``llava_plus_tpu/data/debug_tokenizer.py``).

Lets the training/eval CLIs run end-to-end with no checkpoint or external
tokenizer files (the reference has no offline mode at all — every entry
point requires a HF tokenizer download). Sentencepiece-shaped artifacts are
preserved so the preprocess label-masking arithmetic (ref train.py:419-498)
exercises the same code paths as a real LLaMA tokenizer: BOS prepended,
"</s>" a single token even when glued, trailing-space artifact token.
Word ids are stable hashes so separate processes agree.
"""

from __future__ import annotations

import hashlib
import re


class DebugTokenizer:
    bos_token_id = 1
    eos_token_id = 2
    pad_token_id = 0
    unk_token_id = 3
    _SPACE = 4  # sentencepiece dangling-space artifact
    _RESERVED = 8

    def __init__(self, vocab_size: int = 1024, model_max_length: int = 4096):
        self.vocab_size = vocab_size
        self.model_max_length = model_max_length
        self._names = {0: "<pad>", 1: "<s>", 2: "</s>", 3: "<unk>", 4: "▁"}

    def __len__(self):
        return self.vocab_size

    def _word_id(self, w: str) -> int:
        h = int.from_bytes(hashlib.md5(w.encode()).digest()[:4], "little")
        wid = self._RESERVED + h % (self.vocab_size - self._RESERVED)
        self._names.setdefault(wid, w)
        return wid

    def _encode_words(self, text: str):
        ids = []
        for piece in re.split(r"(</s>|<\|im_start\|>|<\|im_end\|>|\n)", text):
            if piece == "":
                continue
            if piece == "</s>":
                ids.append(self.eos_token_id)
                continue
            if piece in ("<|im_start|>", "<|im_end|>", "\n"):
                ids.append(self._word_id(piece))
                continue
            trailing_space = piece.endswith(" ")
            for w in piece.split(" "):
                if w:
                    ids.append(self._word_id(w))
            if trailing_space:
                ids.append(self._SPACE)
        return ids

    def __call__(self, text: str):
        # bos_token_id = None models GPT-NeoX-style tokenizers (MPT):
        # no BOS, which preprocess_mpt's round arithmetic relies on
        ids = ([self.bos_token_id] if self.bos_token_id is not None
               else []) + self._encode_words(text)
        return type("Enc", (), {"input_ids": ids})()

    def encode(self, text: str):
        return self(text).input_ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        out = []
        for i in ids:
            name = self._names.get(int(i), "<unk>")
            if skip_special_tokens and int(i) < self._RESERVED:
                continue
            out.append(name)
        return " ".join(out)

    def batch_decode(self, batch, skip_special_tokens: bool = True):
        return [self.decode(ids, skip_special_tokens) for ids in batch]

    def add_tokens(self, tokens, special_tokens: bool = False) -> int:
        return 0  # hash vocab covers any string; nothing to add
