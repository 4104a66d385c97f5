"""PyTorch backend for the shared model worker.

The HTTP worker (``llava_plus_tpu.serve.model_worker``: ``ModelWorker``,
``build_app``, the wire protocol) is framework-free and is used as it is;
:class:`TorchBackend` plugs the port's :class:`~llava_plus_torch.generate.Generator`
in behind its backend seam. Request handling (image decoding and
preprocessing, ``<image>`` accounting, the token budget, stop strings,
``stream_interval``) is the JAX backend's own ``generate_stream``, shared
rather than copied. ``ModelWorker``, ``build_app`` and the client's chunk
reader are re-exported here for callers of the port.
"""

from __future__ import annotations

from typing import Optional

import torch

from llava_plus_tpu.serve.model_worker import JaxBackend, ModelWorker, build_app  # noqa: F401
from llava_plus_tpu.serve.protocol import iter_chunks_requests  # noqa: F401
from llava_plus_torch.generate import Generator


class TorchBackend:
    """Single-stream backend over in-memory parameters on ``device``
    (continuous batching comes with the engine port, so ``engine`` is None)."""

    generate_stream = JaxBackend.generate_stream

    def __init__(self, params, cfg, tokenizer, image_processor=None, *,
                 device, kv_int8: bool = False,
                 max_seq_len: Optional[int] = None):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.image_processor = image_processor
        self.context_len = max_seq_len or cfg.max_sequence_length
        self.is_multimodal = True
        self.engine = None
        self.generator = Generator(
            params, cfg, tokenizer, image_processor, device=device,
            max_seq_len=self.context_len,
            cache_dtype=torch.int8 if kv_int8 else torch.bfloat16,
        )
