"""Colored console logger (counterpart of urh/util/Logger.py)."""

from __future__ import annotations

import logging
import os
import sys
import tempfile

LOG_LEVEL_PATH = os.path.join(tempfile.gettempdir(), "urh_tpu_torch_log_level")


class ColoredFormatter(logging.Formatter):
    COLORS = {
        logging.WARNING: "\033[93m",
        logging.ERROR: "\033[91m",
        logging.CRITICAL: "\033[91m\033[1m",
        logging.DEBUG: "\033[94m",
    }
    RESET = "\033[0m"

    def format(self, record):
        out = super().format(record)
        color = self.COLORS.get(record.levelno)
        if color and sys.stderr.isatty():
            return color + out + self.RESET
        return out


def _read_log_level(default=logging.INFO):
    try:
        with open(LOG_LEVEL_PATH) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return default


def save_log_level(level: int):
    try:
        with open(LOG_LEVEL_PATH, "w") as f:
            f.write(str(level))
    except OSError:
        pass


logger = logging.getLogger("urh_tpu_torch")
if not logger.handlers:
    _handler = logging.StreamHandler()
    _handler.setFormatter(ColoredFormatter(
        "[%(levelname)s::%(filename)s::%(funcName)s] %(message)s"))
    logger.addHandler(_handler)
    logger.setLevel(_read_log_level())
    logger.propagate = False
