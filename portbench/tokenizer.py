"""A word-level tokenizer made in set-up: no file, no download.

Every id ``i`` decodes to the word ``w<i>``, so a served text maps back to
its token ids word by word (:func:`ids_of_text`). Prompts are written in
those words, plus the configuration's special strings (its chat template's
markers and image start / end tokens), which take fixed ids. EOS is an id the
model never produces (-1): on random weights EOS means nothing, and every
request runs its whole drawn budget.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional


class WordTokenizer:
    eos_token_id = -1
    pad_token_id = 0
    unk_token_id = 0

    def __init__(self, vocab_size: int, bos_token_id: Optional[int],
                 specials: Dict[str, int], model_max_length: int = 2048):
        self.vocab_size = vocab_size
        self.bos_token_id = bos_token_id
        self.specials = dict(specials)
        self.model_max_length = model_max_length

    def __len__(self):
        return self.vocab_size

    def _word(self, w: str) -> int:
        if w in self.specials:
            return self.specials[w]
        m = re.fullmatch(r"w(\d+)", w)
        if m and int(m.group(1)) < self.vocab_size:
            return int(m.group(1))
        return self.unk_token_id

    def encode(self, text: str) -> List[int]:
        ids = [] if self.bos_token_id is None else [self.bos_token_id]
        return ids + [self._word(w) for w in text.split()]

    def __call__(self, text: str):
        return type("Encoding", (), {"input_ids": self.encode(text)})()

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return " ".join(f"w{int(i)}" for i in ids)

    def batch_decode(self, batch, skip_special_tokens: bool = True):
        return [self.decode(ids) for ids in batch]


def ids_of_text(text: str) -> List[int]:
    """The ids of a text that :meth:`WordTokenizer.decode` wrote; None where
    the text holds anything else (an error message)."""
    words = text.split()
    if not all(re.fullmatch(r"w\d+", w) for w in words):
        return None
    return [int(w[1:]) for w in words]


def for_config(cfg: dict) -> WordTokenizer:
    """The tokenizer of a configuration file (``portbench/configs``)."""
    tok = cfg["tokenizer"]
    return WordTokenizer(cfg["vocab_size"], tok.get("bos_token_id"), tok.get("specials", {}))
