"""Random LLaVA weights that answer every turn with one LLaVA-Plus tool call.

Random weights never emit the ``"thoughts🤔" … "actions🚀" … "value👉"``
grammar, so the tool-use loop (controller, orchestrator, web server, tool
worker) would never reach its tool round. :func:`plant_chain` plants a
decoding chain in such weights instead: given a tokenizer in which every word
of the canned reply has an id of its own (:func:`tool_tokenizer`), it sets
the embedding row of each chain word to a large multiple of its own
direction, so that it dominates the residual stream through every layer, and
the ``lm_head`` column of the word's successor to a multiple of that row, so
that greedy decoding after the prompt's last word (``" ASSISTANT:"`` for the
``v1`` template) emits :func:`canned_reply` and then ``</s>``. Nothing else
changes: every layer and every matrix keeps its random values and its width,
and no projection is zeroed (a zero column would quantize with a scale of 0).

:func:`chain_gaps` reads the planted margins back: the top-2 logit gap at
every step of the chain, from one forward over a prompt and the chain.
"""

from __future__ import annotations

import math
import re
from typing import List, Sequence

import torch

from llava_plus_torch.conversation import serialize_tool_turn

# a word with its leading space and any newlines after it, as its own token
TOKEN_PATTERN = r" ?[^ \n]+\n*|\n+| +"
START_WORD = " ASSISTANT:"   # the v1 template's last prompt word


def canned_reply(caption: str = "cat") -> str:
    """The round-1 reply the planted weights give: one ``grounding_dino``
    call, every word of it distinct under :data:`TOKEN_PATTERN`."""
    return serialize_tool_turn(
        thoughts="I need to locate the object first.",
        actions=[{"API_name": "grounding_dino", "API_params": {"caption": caption}}],
        value="Let me find it for you.",
    )


def _pieces(text: str) -> List[str]:
    """The tokens of ``text`` as the tokenizer splits it: ``<image>``
    markers (split out by ``tokenizer_image_token``) and the special tokens
    apart, the rest by :data:`TOKEN_PATTERN`."""
    return [w for chunk in re.split(r"<image>|<unk>|<s>|</s>", text)
            for w in re.findall(TOKEN_PATTERN, chunk)]


def tool_tokenizer(vocab_size: int, reply: str, texts: Sequence[str] = (), bos: bool = False):
    """A word-level ``transformers`` fast tokenizer made here (no download):
    ``<unk>``, ``<s>`` and ``</s>`` (the EOS), then :data:`START_WORD`, the
    words of ``reply`` and of the ``v1`` template's system prompt (as they
    follow a space), ``" USER:"``, every token of ``texts`` as the tokenizer
    splits them, then ``" w<i>"`` up to ``vocab_size`` ids. A token is a
    word with its leading space and trailing newlines, and decoding
    concatenates tokens, so a text made of known words decodes back exactly.
    Pass the prompts a run will send as ``texts`` to leave no word of them
    ``<unk>`` (:func:`unknown_words`). ``bos`` starts every encoding with
    ``<s>``, as LLaMA's tokenizer does: the trainer's label masking counts
    on it."""
    from tokenizers import Regex, Tokenizer, decoders, models, pre_tokenizers, processors
    from transformers import PreTrainedTokenizerFast

    from llava_plus_torch.conversation import conv_templates

    text = " ".join([reply, conv_templates["v1"].system, "USER:"])
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for w in [START_WORD] + _pieces(" " + text) + [w for t in texts for w in _pieces(t)]:
        vocab.setdefault(w, len(vocab))
    i = 0
    while len(vocab) < vocab_size:
        vocab.setdefault(f" w{i}", len(vocab))
        i += 1
    if len(vocab) > vocab_size:
        raise ValueError(f"{len(vocab)} words do not fit a vocabulary of {vocab_size}")
    core = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    core.pre_tokenizer = pre_tokenizers.Split(Regex(TOKEN_PATTERN), behavior="isolated")
    core.decoder = decoders.Fuse()
    if bos:
        core.post_processor = processors.TemplateProcessing(
            single="<s> $A", pair="<s> $A <s> $B", special_tokens=[("<s>", 1)])
    return PreTrainedTokenizerFast(tokenizer_object=core, unk_token="<unk>", bos_token="<s>",
                                   eos_token="</s>", clean_up_tokenization_spaces=False)


def unknown_words(tokenizer, prompt: str) -> List[str]:
    """The words of ``prompt`` that tokenize to ``<unk>``, its ``<image>``
    markers split out as ``tokenizer_image_token`` does; empty when every
    word is known."""
    vocab = tokenizer.get_vocab()
    out = []
    for chunk in prompt.split("<image>"):
        if tokenizer.unk_token_id in tokenizer(chunk, add_special_tokens=False).input_ids:
            out += [w for w in _pieces(chunk) if w not in vocab] or [chunk]
    return out


def chain_ids(tokenizer, reply: str) -> List[int]:
    """The chain's ids: :data:`START_WORD`, the reply's words, EOS. Raises
    if a word is unknown or any id repeats (a repeated id would need two
    successors)."""
    ids = ([tokenizer.convert_tokens_to_ids(START_WORD)]
           + tokenizer(" " + reply, add_special_tokens=False).input_ids
           + [tokenizer.eos_token_id])
    if tokenizer.unk_token_id in ids or len(set(ids)) != len(ids):
        raise ValueError(f"the reply does not tokenize to distinct known words: {ids}")
    if tokenizer.decode(ids[1:], skip_special_tokens=True) != " " + reply:
        raise ValueError("the reply's words do not decode back to the reply")
    return ids


@torch.no_grad()
def plant_chain(params, ids: Sequence[int], *, embed_rms: float = 256.0,
                logit: float = 32.0) -> None:
    """Plant the chain ``ids`` in a LLaMA-backbone LLaVA tree, in place:
    the embedding row of each word but the last is set to its own direction
    at RMS ``embed_rms``, and the ``lm_head`` column of its successor to that
    direction over sqrt(hidden), so that a final hidden state aligned with the
    row (the RMS-normed residual) scores the successor at about ``logit``.
    Random lm_head columns score about 0.02 * sqrt(hidden) there."""
    lm = params["language_model"]
    emb, head = lm["embed_tokens"], lm["lm_head"]      # [V, D], [D, V]
    D = emb.shape[1]
    for pred, succ in zip(ids[:-1], ids[1:]):
        row = emb[pred].float()
        row = row / row.norm()
        emb[pred] = (row * embed_rms * math.sqrt(D)).to(emb.dtype)
        head[:, succ] = (row * logit / math.sqrt(D)).to(head.dtype)


@torch.no_grad()
def chain_gaps(params, cfg, tokenizer, prompt: str, images, ids: Sequence[int], device):
    """Greedy margins along the chain: one forward over ``prompt`` (with
    ``images``, as the worker processes them) and the chain's words; per
    step, (argmax equals the chain's next id, top-1 minus top-2 logit)."""
    from llava_plus_torch.generate import prepare_multimodal_request
    from llava_plus_torch.models import llava as llava_model

    text = prompt + tokenizer.decode(ids[1:-1], skip_special_tokens=True)
    batch, plan = prepare_multimodal_request(
        cfg, tokenizer, [text], [images] if images is not None else None,
        max_seq_len=cfg.max_sequence_length, device=device)
    n = int(plan.lengths[0])
    steps = len(ids) - 1
    pos = torch.arange(n - steps, n, device=device)
    logits, _ = llava_model.forward(params, cfg, batch, logits_positions=pos)
    top = logits.reshape(steps, -1).float().topk(2)
    want = torch.tensor(ids[1:], device=top.indices.device)
    return [(bool(a), float(g)) for a, g in zip(top.indices[:, 0] == want,
                                                 top.values[:, 0] - top.values[:, 1])]


def main(argv=None):
    """Write a tiny LLaVA-1.5 checkpoint (random f32 weights from ``--seed``)
    with the planted chain and its tokenizer, for standing the LLaVA-Plus
    topology up on the CPU (``model_worker --model-path OUT --device cpu``)."""
    import argparse

    from llava_plus_torch.models import llava as llava_model
    from llava_plus_torch.models.configs import tiny_llava_config
    from llava_plus_torch.train.checkpoint import export_hf_llava

    parser = argparse.ArgumentParser()
    parser.add_argument("--out", type=str, required=True,
                        help="checkpoint directory; its name is the served model's")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    cfg = tiny_llava_config()
    params = llava_model.init_params(cfg, torch.Generator().manual_seed(args.seed), "cpu",
                                     torch.float32)
    reply = canned_reply()
    tokenizer = tool_tokenizer(cfg.text.vocab_size, reply, [" find the cat"])
    plant_chain(params, chain_ids(tokenizer, reply))
    print(export_hf_llava(params, cfg, args.out, tokenizer))


if __name__ == "__main__":
    main()
