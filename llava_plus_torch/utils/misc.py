"""Small serving utilities mirroring the reference's two util modules
(llava/utils.py + top-level serve/utils.py): moderation gate, partial-stop
detection, language sniffing, device-memory probe, async-iterator bridging,
gradio auth parsing.

The port's own copy of ``llava_plus_tpu/utils/misc.py``.
"""

from __future__ import annotations

import asyncio
import json
import os
from typing import AsyncGenerator, Generator, List, Optional, Tuple


def violates_moderation(text: str) -> bool:
    """OpenAI moderation check (ref llava/utils.py:102-120). Fails open
    when no API key / no network — serving must not depend on egress."""
    api_key = os.environ.get("OPENAI_API_KEY")
    if not api_key:
        return False
    try:
        import requests

        url = "https://api.openai.com/v1/moderations"
        headers = {
            "Content-Type": "application/json",
            "Authorization": "Bearer " + api_key,
        }
        text = text.replace("\n", "")
        data = json.dumps({"input": text}).encode()
        ret = requests.post(url, headers=headers, data=data, timeout=5)
        return bool(ret.json()["results"][0]["flagged"])
    except Exception:
        return False


def is_partial_stop(output: str, stop_str: str) -> bool:
    """True if `output` ends with a prefix of `stop_str` (ref
    serve/utils.py): the streamer must hold the tail back until it knows
    whether the stop string is completing."""
    for i in range(min(len(output), len(stop_str)), 0, -1):
        if output.endswith(stop_str[:i]):
            return True
    return False


def detect_language(text: str) -> str:
    """Coarse zh/en sniff (ref serve/utils.py detect_language): CJK
    codepoints => Chinese."""
    for ch in text:
        if "一" <= ch <= "鿿":
            return "zh"
    return "en"


def get_device_memory(device_index: int = 0) -> Optional[float]:
    """Free device memory in GB (the reference's get_gpu_memory): what
    ``torch.cuda.mem_get_info`` reports for card ``device_index``; None
    without a CUDA device there."""
    try:
        import torch

        if device_index >= torch.cuda.device_count():
            return None
        free, _ = torch.cuda.mem_get_info(device_index)
        return free / (1 << 30)
    except Exception:
        return None


def iter_over_async(async_gen: AsyncGenerator, loop=None) -> Generator:
    """Drive an async generator from sync code (ref serve/utils.py
    iter_over_async) — used by WSGI-ish layers around aiohttp handlers."""
    owns_loop = loop is None
    if owns_loop:
        loop = asyncio.new_event_loop()
    ait = async_gen.__aiter__()
    try:
        while True:
            try:
                yield loop.run_until_complete(ait.__anext__())
            except StopAsyncIteration:
                break
    finally:
        if owns_loop:
            loop.close()


def parse_gradio_auth_creds(filename: str) -> Optional[List[Tuple[str, str]]]:
    """Parse "user:pass" lines (ref serve/utils.py gradio auth parsing)."""
    creds = []
    with open(filename) as f:
        for line in f:
            line = line.strip()
            if line and ":" in line:
                user, _, pwd = line.partition(":")
                creds.append((user, pwd))
    return creds or None
