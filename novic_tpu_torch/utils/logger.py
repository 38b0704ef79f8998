"""ANSI-colored logging: one shared ``log`` instance with a per-level colored
stream handler."""

from __future__ import annotations

import logging
import os
import sys

_RESET = "\x1b[0m"
_LEVEL_COLORS = {
    logging.DEBUG: "\x1b[38;5;245m",   # grey
    logging.INFO: "",                  # default
    logging.WARNING: "\x1b[33m",       # yellow
    logging.ERROR: "\x1b[31m",         # red
    logging.CRITICAL: "\x1b[41m",      # red background
}


class ColorFormatter(logging.Formatter):

    def __init__(self, fmt: str, datefmt: str, use_color: bool):
        super().__init__(fmt=fmt, datefmt=datefmt)
        self.use_color = use_color

    def format(self, record: logging.LogRecord) -> str:
        text = super().format(record)
        if self.use_color:
            color = _LEVEL_COLORS.get(record.levelno, "")
            if color:
                text = f"{color}{text}{_RESET}"
        return text


_FMT = "[%(asctime)s][%(levelname)s] %(message)s"
_DATEFMT = "%H:%M:%S"


def create_logger(name: str = "novic_tpu_torch", level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(stream=sys.stdout)
        use_color = sys.stdout.isatty() or os.environ.get("FORCE_COLOR", "") not in ("", "0")
        handler.setFormatter(ColorFormatter(fmt=_FMT, datefmt=_DATEFMT, use_color=use_color))
        logger.addHandler(handler)
        logger.setLevel(level)
        logger.propagate = False
    return logger


log = create_logger()
