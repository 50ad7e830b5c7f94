"""Structured logging — replaces the reference's printf-with-[Tag] style
(SURVEY.md §5) with the standard logging module plus an optional JSON-lines
file sink for machine-readable run records."""

from __future__ import annotations

import json
import logging
import sys
import time
from pathlib import Path
from typing import Optional


def get_logger(name: str = "lvba") -> logging.Logger:
    return logging.getLogger(name)


class _JsonLineHandler(logging.Handler):
    def __init__(self, path: Path):
        super().__init__()
        self.f = open(path, "a")

    def emit(self, record):
        self.f.write(
            json.dumps(
                {
                    "t": time.time(),
                    "level": record.levelname,
                    "name": record.name,
                    "msg": record.getMessage(),
                }
            )
            + "\n"
        )
        self.f.flush()


def setup_logging(level=logging.INFO, json_path: Optional[str] = None):
    root = logging.getLogger("global_lvba_tpu_torch")
    root.setLevel(level)
    if not any(isinstance(h, logging.StreamHandler) for h in root.handlers):
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(logging.Formatter("[%(levelname).1s %(name)s] %(message)s"))
        root.addHandler(h)
    if json_path:
        root.addHandler(_JsonLineHandler(Path(json_path)))
    return root
