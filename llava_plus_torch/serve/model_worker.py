"""PyTorch backend for the shared model worker.

The HTTP worker (``llava_plus_tpu.serve.model_worker``: ``ModelWorker``,
``build_app``, the wire protocol) is framework-free and is used as it is;
:class:`TorchBackend` plugs the port in behind its backend seam. By default
requests go through the continuous-batching :class:`~llava_plus_torch.serve.engine.BatchedEngine`,
as the JAX worker serves them; ``use_engine=False`` serves one request at a
time through the single-stream :class:`~llava_plus_torch.generate.Generator`.
``ModelWorker``, ``build_app`` and the client's chunk reader are re-exported
here for callers of the port.
"""

from __future__ import annotations

from typing import Iterator, Optional

import torch

from llava_plus_tpu.constants import (
    DEFAULT_IM_END_TOKEN,
    DEFAULT_IM_START_TOKEN,
    DEFAULT_IMAGE_TOKEN,
)
from llava_plus_tpu.mm_utils import load_image_from_base64, process_images
from llava_plus_tpu.serve.model_worker import ModelWorker, build_app  # noqa: F401
from llava_plus_tpu.serve.protocol import iter_chunks_requests  # noqa: F401
from llava_plus_torch.generate import Generator
from llava_plus_torch.ops.quant import quantize_llava_params
from llava_plus_torch.serve.engine import BatchedEngine, Request


class TorchBackend:
    """Backend over in-memory parameters on ``device``.

    ``quantize="int8"`` / ``"int4"`` quantizes the language model's matrices
    in place (the caller's tree is consumed) and fuses them (``wqkv``,
    ``w_gateup``): the port's ``--load-8bit`` / ``--load-4bit``.
    ``kv_int8`` stores the KV cache as int8 with per-(token, head) scales.
    ``warmup_len`` > 0 warms the engine at that prompt length before the
    first request."""

    def __init__(self, params, cfg, tokenizer, image_processor=None, *,
                 device, use_engine: bool = True, max_slots: int = 8,
                 decode_chunk: int = 4, quantize: Optional[str] = None,
                 kv_int8: bool = False, max_seq_len: Optional[int] = None,
                 warmup_len: int = 0, stream_interval: int = 1):
        if quantize not in (None, "int8", "int4"):
            raise ValueError(f"quantize must be None, 'int8' or 'int4', got {quantize!r}")
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.image_processor = image_processor
        self.context_len = max_seq_len or cfg.max_sequence_length
        self.is_multimodal = True
        self.stream_interval = max(int(stream_interval or 1), 1)
        if quantize:
            params = quantize_llava_params(params, cfg.language_model_type,
                                           bits=4 if quantize == "int4" else 8, fuse=True)
        cache_dtype = torch.int8 if kv_int8 else torch.bfloat16
        self.engine = None
        self.generator = None
        if use_engine:
            self.engine = BatchedEngine(params, cfg, tokenizer, max_slots=max_slots,
                                        max_seq_len=self.context_len,
                                        decode_chunk=decode_chunk, cache_dtype=cache_dtype)
            if warmup_len:
                self.engine.warmup(prompt_len=warmup_len, image=self.is_multimodal)
        else:
            self.generator = Generator(params, cfg, tokenizer, image_processor, device=device,
                                       max_seq_len=self.context_len, cache_dtype=cache_dtype)

    def stop(self):
        """Stop the engine's threads (no-op without an engine)."""
        if self.engine is not None:
            self.engine.stop()

    def generate_stream(self, params: dict) -> Iterator[str]:
        """One request of the worker's protocol: the JAX backend's request
        handling (image count, ``<image>`` accounting, token budget, greedy
        below temperature 0.001, stop string, ``stream_interval``), served by
        the port's engine or generator. Yields cumulative text."""
        prompt = params["prompt"]
        ori_prompt = prompt
        images = params.get("images", None)
        num_image_tokens = 0
        image_arrays = None
        if images is not None and len(images) > 0 and self.is_multimodal:
            if len(images) != prompt.count(DEFAULT_IMAGE_TOKEN):
                raise ValueError(
                    "Number of images does not match number of <image> tokens in prompt")
            pil_images = [load_image_from_base64(im) for im in images]
            image_arrays = process_images(pil_images, self.image_processor, self.cfg)
            replace_token = DEFAULT_IMAGE_TOKEN
            if self.cfg.mm_use_im_start_end:
                replace_token = DEFAULT_IM_START_TOKEN + replace_token + DEFAULT_IM_END_TOKEN
            prompt = prompt.replace(DEFAULT_IMAGE_TOKEN, replace_token)
            num_image_tokens = prompt.count(replace_token) * self.cfg.num_image_tokens

        temperature = float(params.get("temperature", 1.0))
        top_p = float(params.get("top_p", 1.0))
        max_new_tokens = min(int(params.get("max_new_tokens", 256)), 1024)
        stop_str = params.get("stop", None)
        if temperature <= 0.001:
            temperature = 0.0

        prompt_tokens = len(self.tokenizer(prompt).input_ids)
        max_new_tokens = min(max_new_tokens,
                             self.context_len - prompt_tokens - num_image_tokens)
        if max_new_tokens < 1:
            yield ori_prompt + "Exceeds max token length. Please start a new conversation, thanks."
            return

        stop_strings = [stop_str] if stop_str else []
        if self.engine is not None:
            stream = self.engine.stream(Request(
                prompt=prompt, images=image_arrays, max_new_tokens=max_new_tokens,
                temperature=temperature, top_p=top_p, stop_strings=stop_strings))
        else:
            stream = self.generator.stream(
                prompt, images=image_arrays, max_new_tokens=max_new_tokens,
                temperature=temperature, top_p=top_p, stop_strings=stop_strings)
        # push every stream_interval-th cumulative update, and the final one
        n, last = 0, None
        for text in stream:
            n += 1
            if n % self.stream_interval == 0:
                yield ori_prompt + text
                last = None
            else:
                last = text
        if last is not None:
            yield ori_prompt + last
