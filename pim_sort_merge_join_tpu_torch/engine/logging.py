"""Structured logging for the engine (port of `engine/logging.py`).

A standard-library logger that emits one JSON object per event, switched
on at run time (`EngineConfig.debug_log` sends the pipeline's stage events
through `log_event`). The port's logger has its own name, so the two
packages' events never mix.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Any

_LOGGER_NAME = "pim_sort_merge_join_tpu_torch"


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        payload: dict[str, Any] = {
            "ts": round(time.time(), 3),
            "level": record.levelname.lower(),
            "event": record.getMessage(),
        }
        extra = getattr(record, "fields", None)
        if extra:
            payload.update(extra)
        return json.dumps(payload)


def get_logger() -> logging.Logger:
    return logging.getLogger(_LOGGER_NAME)


def configure(level: int = logging.INFO, stream=None, json_format: bool = True):
    logger = get_logger()
    logger.handlers.clear()
    handler = logging.StreamHandler(stream or sys.stderr)
    if json_format:
        handler.setFormatter(JsonFormatter())
    else:
        handler.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
    logger.addHandler(handler)
    logger.setLevel(level)
    return logger


def log_event(event: str, **fields):
    get_logger().info(event, extra={"fields": fields})
