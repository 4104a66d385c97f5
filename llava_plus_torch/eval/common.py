"""Shared eval plumbing: chunking, answer files, model session.

The reference fans out eval across GPUs with ``--num-chunks/--chunk-idx``
(``llava/eval/model_vqa_loader.py:19-27``); each chunk is one process on
one device.

The port's own copy of ``llava_plus_tpu/eval/common.py``: the session loads
the checkpoint through the port's ``models/builder.load_pretrained_model``,
moves the tree to ``device`` and answers through the port's ``Generator``
(greedy, sampled or beam search) or its dense ``BatchedEngine``.
"""

from __future__ import annotations

import json
import math
import os
from typing import Iterable, List


def split_list(lst: List, n: int) -> List[List]:
    chunk_size = math.ceil(len(lst) / n)
    return [lst[i : i + chunk_size] for i in range(0, len(lst), chunk_size)]


def get_chunk(lst: List, n: int, k: int) -> List:
    chunks = split_list(lst, n)
    return chunks[k] if k < len(chunks) else []


def load_jsonl(path) -> List[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def write_jsonl(path, rows: Iterable[dict], mode: str = "w") -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, mode) as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")


def short_uuid() -> str:
    import uuid

    return uuid.uuid4().hex[:22]


class EvalSession:
    """Load a model once; greedy (or sampled, or beam) answers for eval
    prompts."""

    def __init__(self, model_path, model_base=None, model_name=None,
                 conv_mode="llava_v1", temperature=0.0, top_p=1.0,
                 max_new_tokens=128, backend=None, engine_slots=0,
                 engine=None, generator=None, num_beams=1, device="cuda"):
        """``engine_slots > 0`` answers through the continuous-batching
        engine (serve/engine.py) instead of the single-stream generator:
        ``answer_many`` then decodes up to that many questions per step.
        Greedy engine output equals the single-stream generator, so eval
        answers are unchanged, only throughput. ``backend=``, ``engine=``
        and ``generator=`` are test seams (a ``.answer(prompt, image)``
        object, a built ``BatchedEngine``, a built ``Generator``)."""
        self.conv_mode = conv_mode
        self.temperature = temperature
        self.top_p = top_p
        self.max_new_tokens = max_new_tokens
        self.num_beams = int(num_beams or 1)
        if self.num_beams > 1 and engine_slots:
            raise ValueError("--engine-slots requires --num_beams 1 "
                             "(beam search runs on the single-stream "
                             "generator)")
        self.backend = backend
        self.engine = engine
        self.generator = generator
        if backend is not None or engine is not None or generator is not None:
            # test seams: backend has .answer(prompt, image) -> str
            return
        import torch

        # no quiet fallback to the CPU
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"--device {device}: no CUDA device is available; pass "
                               "--device cpu to run on the CPU")
        from llava_plus_torch.mm_utils import get_model_name_from_path
        from llava_plus_torch.models.builder import load_pretrained_model
        from llava_plus_torch.models.convert import tree_map

        name = model_name or get_model_name_from_path(model_path)
        tokenizer, params, cfg, image_processor, context_len = (
            load_pretrained_model(model_path, model_base, name)
        )
        params = tree_map(lambda x: x.to(device), params)
        self.cfg = cfg
        self.image_processor = image_processor
        if engine_slots:
            from llava_plus_torch.serve.engine import BatchedEngine

            self.engine = BatchedEngine(
                params, cfg, tokenizer, max_slots=int(engine_slots),
                max_seq_len=context_len,
            )
        else:
            from llava_plus_torch.generate import Generator

            self.generator = Generator(
                params, cfg, tokenizer, image_processor, device=device,
                max_seq_len=context_len,
            )

    def _pixels(self, image):
        if image is None:
            return None
        from llava_plus_torch.mm_utils import process_images

        return process_images([image], self.image_processor, self.cfg)

    def _request(self, prompt, image, stop_strings, max_new_tokens=None):
        from llava_plus_torch.serve.engine import Request

        return Request(
            prompt=prompt, images=self._pixels(image),
            max_new_tokens=max_new_tokens or self.max_new_tokens,
            temperature=self.temperature, top_p=self.top_p,
            stop_strings=list(stop_strings),
        )

    def answer(self, prompt: str, image=None, stop_strings=(),
               max_new_tokens=None) -> str:
        if self.backend is not None:
            return self.backend.answer(prompt, image)
        if self.engine is not None:
            return self.engine.generate(
                self._request(prompt, image, stop_strings, max_new_tokens)
            ).strip()
        if self.num_beams > 1:
            result = self.generator.beam_search(
                prompt, images=self._pixels(image),
                num_beams=self.num_beams,
                max_new_tokens=max_new_tokens or self.max_new_tokens,
                stop_strings=list(stop_strings),
            )
            return result.text.strip()
        result = self.generator.generate(
            prompt, images=self._pixels(image),
            max_new_tokens=max_new_tokens or self.max_new_tokens,
            temperature=self.temperature,
            top_p=self.top_p,
            stop_strings=list(stop_strings),
        )
        return result.text.strip()

    def answer_many(self, items, stop_strings=(), max_new_tokens=None):
        """Yield answers for an iterable of ``(prompt, image)`` IN ORDER.

        With an engine, requests are submitted ahead (window of
        2x slots, bounding in-flight host pixel buffers) so the engine
        decodes them concurrently; items are pulled from the iterable
        lazily, just in time. Without one, falls back to serial
        ``answer``: the same output either way (greedy equality)."""
        if self.engine is None:
            for prompt, image in items:
                yield self.answer(prompt, image, stop_strings,
                                  max_new_tokens)
            return
        from collections import deque

        it = iter(items)
        window = 2 * self.engine.max_slots
        pending = deque()

        def submit_next():
            try:
                prompt, image = next(it)
            except StopIteration:
                return False
            pending.append(self.engine.submit(
                self._request(prompt, image, stop_strings, max_new_tokens)
            ))
            return True

        while len(pending) < window and submit_next():
            pass
        while pending:
            text = self.engine.drain(pending.popleft())
            submit_next()
            yield text.strip()

    def close(self):
        if self.engine is not None:
            self.engine.stop()
