"""Logging + misc helper decorators (ppq/core/defs.py + ppq/log/logger.py
equivalents)."""

from __future__ import annotations

import functools
import logging
import sys
import time
from typing import Optional


class SingletonMeta(type):
    _instances: dict = {}

    def __call__(cls, *args, **kwargs):
        if cls not in cls._instances:
            cls._instances[cls] = super().__call__(*args, **kwargs)
        return cls._instances[cls]


class PPQLogger(metaclass=SingletonMeta):
    """Framework logger (reference: ppq/log/logger.py:59 NaiveLogger)."""

    def __init__(self, level: int = logging.INFO):
        self._logger = logging.getLogger('ppq_tpu_torch')
        if not self._logger.handlers:
            handler = logging.StreamHandler(sys.stdout)
            handler.setFormatter(logging.Formatter(
                '[%(asctime)s ppq_tpu_torch %(levelname)s] %(message)s', '%H:%M:%S'))
            self._logger.addHandler(handler)
        self._logger.setLevel(level)
        self._logger.propagate = False

    def set_level(self, level: int):
        self._logger.setLevel(level)

    def register_file_handler(self, path: str):
        handler = logging.FileHandler(path)
        handler.setFormatter(logging.Formatter(
            '[%(asctime)s ppq_tpu_torch %(levelname)s] %(message)s'))
        self._logger.addHandler(handler)

    def info(self, msg: str): self._logger.info(msg)
    def warning(self, msg: str): self._logger.warning(msg)
    def error(self, msg: str): self._logger.error(msg)
    def debug(self, msg: str): self._logger.debug(msg)


def ppq_info(msg: str): PPQLogger().info(msg)
def ppq_warning(msg: str): PPQLogger().warning(msg)
def ppq_error(msg: str): PPQLogger().error(msg)
def ppq_debug(msg: str): PPQLogger().debug(msg)


def timed(label: Optional[str] = None):
    """Decorator printing wall-clock of the wrapped call at debug level."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            ppq_debug(f'{label or fn.__name__} took {time.perf_counter() - t0:.3f}s')
            return out
        return wrapper
    return deco
