"""Logging helpers and the shared serving messages (the port's own copy of
``llava_plus_tpu/utils/logging.py``; ref llava/utils.py, serve/utils.py)."""

from __future__ import annotations

import logging
import logging.handlers
import os
import sys

from llava_plus_torch.constants import LOGDIR

server_error_msg = (
    "**NETWORK ERROR DUE TO HIGH TRAFFIC. PLEASE REGENERATE OR REFRESH THIS PAGE.**"
)
moderation_msg = (
    "YOUR INPUT VIOLATES OUR CONTENT MODERATION GUIDELINES. PLEASE TRY AGAIN."
)

_handlers = {}


def build_logger(logger_name: str, logger_filename: str) -> logging.Logger:
    """Console + daily-rotating shared file logger (ref llava/utils.py:17-57,
    minus the stdout/stderr hijacking, which hides tracebacks)."""
    formatter = logging.Formatter(
        fmt="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    logger = logging.getLogger(logger_name)
    logger.setLevel(logging.INFO)
    if logger.handlers:
        return logger

    stream = logging.StreamHandler(sys.stdout)
    stream.setFormatter(formatter)
    logger.addHandler(stream)

    if logger_filename not in _handlers:
        os.makedirs(LOGDIR, exist_ok=True)
        path = os.path.join(LOGDIR, logger_filename)
        try:
            fh = logging.handlers.TimedRotatingFileHandler(
                path, when="D", utc=True, encoding="utf-8"
            )
            fh.setFormatter(formatter)
            _handlers[logger_filename] = fh
        except OSError:
            _handlers[logger_filename] = None
    if _handlers.get(logger_filename) is not None:
        logger.addHandler(_handlers[logger_filename])
    return logger


def pretty_print_semaphore(semaphore) -> str:
    if semaphore is None:
        return "None"
    return (
        f"Semaphore(value={getattr(semaphore, '_value', '?')}, "
        f"locked={semaphore.locked()})"
    )
