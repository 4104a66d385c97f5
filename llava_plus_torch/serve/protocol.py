"""Serving wire protocol: stream chunk framing (the port's own copy of what it
uses from ``llava_plus_tpu/serve/protocol.py``).

The HTTP/JSON protocol is the reference's, byte for byte: the worker streams
JSON chunks terminated by b"\\0", each {"text": cumulative_text,
"error_code": int}.
"""

from __future__ import annotations

import json
from typing import Iterator

DELIMITER = b"\0"


def encode_chunk(payload: dict) -> bytes:
    return json.dumps(payload).encode() + DELIMITER


def iter_chunks_requests(resp) -> Iterator[dict]:
    """Iterate the chunks of a `requests` streaming response."""
    for chunk in resp.iter_lines(decode_unicode=False, delimiter=DELIMITER):
        if chunk:
            yield json.loads(chunk.decode())
