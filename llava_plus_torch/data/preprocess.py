"""Training preprocessing: per-template tokenization + label masking (the
port's own copy of ``llava_plus_tpu/data/preprocess.py``).

Rebuild of the reference's preprocess pipelines
(``llava/train/train.py:229-638``): ``preprocess_plain``, ``preprocess_v1``,
``preprocess_llama_2``, ``preprocess_mpt``, the v0 speaker-signal default,
and the multimodal <image>-normalization pass. Every batch first runs
``reorganize_source_for_tool_use_batch`` (the LLaVA-Plus twist, train.py:603).

Semantics preserved exactly, including the subtle bits: the
``instruction_len - 2`` offset (BOS + the sep-space merge in LLaMA
tokenizers), round splitting on ``conv.sep2``, and the
tokenization-mismatch tripwire that masks the whole sample. Outputs are
unpadded numpy int arrays; padding/expansion happens in the splice planner.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence

import numpy as np

from llava_plus_torch import conversation as conversation_lib
from llava_plus_torch.constants import (
    DEFAULT_IM_END_TOKEN,
    DEFAULT_IM_START_TOKEN,
    DEFAULT_IMAGE_TOKEN,
    IGNORE_INDEX,
)
from llava_plus_torch.conversation import Conversation, SeparatorStyle
from llava_plus_torch.mm_utils import (
    reorganize_source_for_tool_use_batch,
    tokenizer_image_token,
)
from llava_plus_torch.utils.logging import build_logger

logger = build_logger("preprocess", "preprocess.log")


def _tok_len(text: str, tokenizer, has_image: bool) -> int:
    if has_image:
        return len(tokenizer_image_token(text, tokenizer))
    return len(tokenizer(text).input_ids)


def _tokenize(text: str, tokenizer, has_image: bool, max_len: Optional[int]):
    if has_image:
        ids = tokenizer_image_token(text, tokenizer)
    else:
        ids = list(tokenizer(text).input_ids)
    if max_len is not None:
        ids = ids[:max_len]
    return np.asarray(ids, dtype=np.int64)


def _model_max_length(tokenizer) -> Optional[int]:
    n = getattr(tokenizer, "model_max_length", None)
    if n is None or n > 10 ** 8:
        return None
    return n


def _render_conversations(sources, conv: Conversation) -> List[str]:
    roles = {"human": conv.roles[0], "gpt": conv.roles[1]}
    conversations = []
    for source in sources:
        if roles[source[0]["from"]] != conv.roles[0]:
            source = source[1:]  # first turn must be human
        c = conv.copy()
        c.messages = []
        for j, sentence in enumerate(source):
            role = roles[sentence["from"]]
            assert role == c.roles[j % 2], "conversation roles out of order"
            c.append_message(role, sentence["value"])
        conversations.append(c.get_prompt())
    return conversations


def preprocess_multimodal(
    sources,
    *,
    is_multimodal: bool = True,
    mm_use_im_start_end: bool = False,
    version: str = "v1",
):
    """Normalize <image> placement + optional im_start/end wrapping
    (ref train.py:315-336)."""
    if not is_multimodal:
        return sources
    for source in sources:
        for sentence in source:
            if DEFAULT_IMAGE_TOKEN in sentence["value"]:
                sentence["value"] = (
                    sentence["value"].replace(DEFAULT_IMAGE_TOKEN, "").strip()
                )
                sentence["value"] = (
                    DEFAULT_IMAGE_TOKEN + "\n" + sentence["value"]
                ).strip()
                if "mmtag" in version:
                    sentence["value"] = sentence["value"].replace(
                        DEFAULT_IMAGE_TOKEN,
                        "<Image>" + DEFAULT_IMAGE_TOKEN + "</Image>",
                    )
            replace_token = DEFAULT_IMAGE_TOKEN
            if mm_use_im_start_end:
                replace_token = (
                    DEFAULT_IM_START_TOKEN + replace_token + DEFAULT_IM_END_TOKEN
                )
            sentence["value"] = sentence["value"].replace(
                DEFAULT_IMAGE_TOKEN, replace_token
            )
    return sources


def _mask_rounds(
    conversation: str,
    ids: np.ndarray,
    tokenizer,
    *,
    sep: str,
    round_sep: str,
    has_image: bool,
    instruction_offset: int,
    initial_len: int,
    mpt_rounds: bool = False,
    mpt_conv_sep: Optional[str] = None,
) -> np.ndarray:
    """Shared round-walk masking loop for v1/llama_2/mpt."""
    target = ids.copy()
    pad_id = getattr(tokenizer, "pad_token_id", None)
    total_len = int(np.sum(target != pad_id)) if pad_id is not None else len(target)

    if mpt_rounds:
        raw = conversation.split(mpt_conv_sep)
        rounds = [mpt_conv_sep.join(raw[:3])]
        for idx in range(3, len(raw), 2):
            rounds.append(mpt_conv_sep.join(raw[idx:idx + 2]))
    else:
        rounds = conversation.split(round_sep)

    cur_len = initial_len
    target[:cur_len] = IGNORE_INDEX
    for rou in rounds:
        if rou == "":
            break
        parts = rou.split(sep)
        if len(parts) != 2:
            break
        parts[0] += sep
        if mpt_rounds:
            round_len = (
                _tok_len(rou, tokenizer, True)
                + _tok_len(mpt_conv_sep, tokenizer, True)
            )
            instruction_len = _tok_len(parts[0], tokenizer, True)
        else:
            round_len = _tok_len(rou, tokenizer, has_image)
            instruction_len = (
                _tok_len(parts[0], tokenizer, has_image) + instruction_offset
            )
        target[cur_len : cur_len + instruction_len] = IGNORE_INDEX
        cur_len += round_len
    target[cur_len:] = IGNORE_INDEX

    max_len = _model_max_length(tokenizer)
    if max_len is None or cur_len < max_len:
        if cur_len != total_len:
            target[:] = IGNORE_INDEX
            logger.warning(
                f"tokenization mismatch: {cur_len} vs. {total_len}. (ignored)"
            )
    return target


def preprocess_v1(sources, tokenizer, has_image: bool = False,
                  conv: Optional[Conversation] = None) -> Dict:
    conv = conv or conversation_lib.default_conversation
    assert conv.sep_style == SeparatorStyle.TWO
    conversations = _render_conversations(sources, conv)
    max_len = _model_max_length(tokenizer)
    input_ids = [
        _tokenize(c, tokenizer, has_image, max_len) for c in conversations
    ]
    sep = conv.sep + conv.roles[1] + ": "
    labels = [
        _mask_rounds(
            c, ids, tokenizer,
            sep=sep, round_sep=conv.sep2, has_image=has_image,
            instruction_offset=-2, initial_len=1,
        )
        for c, ids in zip(conversations, input_ids)
    ]
    return dict(input_ids=input_ids, labels=labels)


def preprocess_llama_2(sources, tokenizer, has_image: bool = False,
                       conv: Optional[Conversation] = None) -> Dict:
    conv = conv or conversation_lib.default_conversation
    assert conv.sep_style == SeparatorStyle.LLAMA_2
    conversations = _render_conversations(sources, conv)
    max_len = _model_max_length(tokenizer)
    input_ids = [
        _tokenize(c, tokenizer, has_image, max_len) for c in conversations
    ]
    labels = [
        _mask_rounds(
            c, ids, tokenizer,
            sep="[/INST] ", round_sep=conv.sep2, has_image=has_image,
            instruction_offset=-2, initial_len=1,
        )
        for c, ids in zip(conversations, input_ids)
    ]
    return dict(input_ids=input_ids, labels=labels)


def preprocess_mpt(sources, tokenizer,
                   conv: Optional[Conversation] = None) -> Dict:
    conv = conv or conversation_lib.default_conversation
    assert conv.sep_style == SeparatorStyle.MPT
    conversations = _render_conversations(sources, conv)
    max_len = _model_max_length(tokenizer)
    input_ids = [_tokenize(c, tokenizer, True, max_len) for c in conversations]
    sep = conv.sep + conv.roles[1]
    labels = [
        _mask_rounds(
            c, ids, tokenizer,
            sep=sep, round_sep=conv.sep, has_image=True,
            instruction_offset=0, initial_len=0,
            mpt_rounds=True, mpt_conv_sep=conv.sep,
        )
        for c, ids in zip(conversations, input_ids)
    ]
    return dict(input_ids=input_ids, labels=labels)


def preprocess_plain(sources, tokenizer,
                     conv: Optional[Conversation] = None) -> Dict:
    """Stage-1 pairs: "<image>" + caption + sep; mask the image span
    (ref train.py:567-586)."""
    conv = conv or conversation_lib.default_conversation
    conversations = []
    for source in sources:
        assert len(source) == 2
        assert DEFAULT_IMAGE_TOKEN in source[0]["value"]
        source[0]["value"] = DEFAULT_IMAGE_TOKEN
        conversations.append(
            source[0]["value"] + source[1]["value"] + conv.sep
        )
    input_ids = [
        _tokenize(c, tokenizer, True, None) for c in conversations
    ]
    labels = []
    for ids, source in zip(input_ids, sources):
        t = ids.copy()
        n = _tok_len(source[0]["value"], tokenizer, True)
        t[:n] = IGNORE_INDEX
        labels.append(t)
    return dict(input_ids=input_ids, labels=labels)


def _preprocess_v0(sources, tokenizer, has_image: bool,
                   conv: Conversation) -> Dict:
    """Default path: '### Role: text\\n' speaker signals
    (ref train.py:281-311, 613-638)."""
    BEGIN, END = "### ", "\n"
    conversations = []
    headers = []
    for source in sources:
        header = f"{conv.system}\n\n"
        text = header
        for sentence in source:
            frm = sentence["from"].lower()
            role = (
                conv.roles[0] if frm == "human"
                else conv.roles[1] if frm == "gpt" else "unknown"
            )
            sentence["value"] = BEGIN + role + ": " + sentence["value"] + END
            text += sentence["value"]
        text += BEGIN
        conversations.append(text)
        headers.append(header)

    max_len = _model_max_length(tokenizer)
    input_ids = [
        _tokenize(c, tokenizer, has_image, max_len) for c in conversations
    ]
    labels = []
    for ids, source, header in zip(input_ids, sources, headers):
        t = ids.copy()
        lens = [_tok_len(header, tokenizer, has_image)] + [
            _tok_len(s["value"], tokenizer, has_image) for s in source
        ]
        speakers = [s["from"] for s in source]
        cur = lens[0]
        t[:cur] = IGNORE_INDEX
        for ln, speaker in zip(lens[1:], speakers):
            if speaker == "human":
                t[cur + 2 : cur + ln] = IGNORE_INDEX
            cur += ln
        labels.append(t)
    return dict(input_ids=input_ids, labels=labels)


def preprocess(
    sources,
    tokenizer,
    has_image: bool = False,
    conv: Optional[Conversation] = None,
) -> Dict:
    """Dispatcher (ref train.py:589-638). Mutates copies, not the input."""
    sources = copy.deepcopy(list(sources))
    sources = reorganize_source_for_tool_use_batch(sources)
    conv = conv or conversation_lib.default_conversation
    if conv.sep_style == SeparatorStyle.PLAIN:
        return preprocess_plain(sources, tokenizer, conv)
    if conv.sep_style == SeparatorStyle.LLAMA_2:
        return preprocess_llama_2(sources, tokenizer, has_image, conv)
    if conv.version.startswith("v1"):
        return preprocess_v1(sources, tokenizer, has_image, conv)
    if conv.version == "mpt":
        return preprocess_mpt(sources, tokenizer, conv)
    return _preprocess_v0(sources, tokenizer, has_image, conv)
