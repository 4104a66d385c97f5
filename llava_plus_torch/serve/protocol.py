"""Serving wire protocol: shared types, error codes, stream chunk framing.

The HTTP/JSON protocol is preserved byte-for-byte from the reference
(SURVEY.md §2.5) so existing clients, gradio frontends, and the 14 tool
workers interoperate unchanged:

- controller endpoints: /register_worker /refresh_all_workers /list_models
  /get_worker_address /receive_heart_beat /worker_generate_stream
  /worker_get_status
- worker endpoints: /worker_generate_stream /worker_get_status
  (+ /worker_generate for sync tool workers)
- stream framing: JSON chunks terminated by b"\\0", each
  {"text": cumulative_text, "error_code": int}

The port's own copy of ``llava_plus_tpu/serve/protocol.py``.
"""

from __future__ import annotations

import dataclasses
import json
from enum import IntEnum
from typing import AsyncIterator, Iterator, List

DELIMITER = b"\0"


@dataclasses.dataclass
class WorkerInfo:
    model_names: List[str]
    speed: int
    queue_length: int
    check_heart_beat: bool
    last_heart_beat: float


class ErrorCode(IntEnum):
    """FastChat-style error codes (ref serve/constants.py:34-58)."""

    VALIDATION_TYPE_ERROR = 40001
    INVALID_AUTH_KEY = 40101
    INCORRECT_AUTH_KEY = 40102
    NO_PERMISSION = 40103
    INVALID_MODEL = 40301
    PARAM_OUT_OF_RANGE = 40302
    CONTEXT_OVERFLOW = 40303
    RATE_LIMIT = 42901
    QUOTA_EXCEEDED = 42902
    ENGINE_OVERLOADED = 50002
    INTERNAL_ERROR = 50001
    CUDA_OUT_OF_MEMORY = 50002
    GRADIO_REQUEST_ERROR = 50003
    GRADIO_STREAM_UNKNOWN_ERROR = 50004
    CONTROLLER_NO_WORKER = 50005
    CONTROLLER_WORKER_TIMEOUT = 50006


def encode_chunk(payload: dict) -> bytes:
    return json.dumps(payload).encode() + DELIMITER


def decode_stream(data: bytes) -> Iterator[dict]:
    """Split a byte buffer of b"\\0"-delimited JSON chunks."""
    for part in data.split(DELIMITER):
        if part:
            yield json.loads(part.decode())


async def iter_chunks(resp) -> AsyncIterator[dict]:
    """Async-iterate b"\\0"-delimited JSON chunks from an aiohttp response."""
    buffer = b""
    async for data, _ in resp.content.iter_chunks():
        buffer += data
        while DELIMITER in buffer:
            part, buffer = buffer.split(DELIMITER, 1)
            if part:
                yield json.loads(part.decode())
    if buffer:
        yield json.loads(buffer.decode())


def iter_chunks_requests(resp) -> Iterator[dict]:
    """Sync variant over a `requests` streaming response."""
    for chunk in resp.iter_lines(decode_unicode=False, delimiter=DELIMITER):
        if chunk:
            yield json.loads(chunk.decode())
