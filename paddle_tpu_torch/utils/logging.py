"""Logging and version stamping — the port of
``paddle_tpu/utils/logging.py`` (paddle/utils glog/gflags surface).

Python logging plays glog's role; the format mirrors glog's
``[LEVEL datetime file:line]`` so log-scraping tooling carries over.
The port logs under ``paddle_tpu_torch``.
"""

from __future__ import annotations

import logging
import sys

VERSION = "0.3.0"               # the framework version stamp
ISA_TARGET = "cuda-sm90a"       # the reference stamped WITH_GPU/avx flags

_FMT = "[%(levelname).1s %(asctime)s %(filename)s:%(lineno)d] %(message)s"
_ROOT = "paddle_tpu_torch"
_initialized = False


class _StderrHandler(logging.StreamHandler):
    """Resolves ``sys.stderr`` at EMIT time, not construction: glog
    writes to whatever stderr currently is, so stderr redirection (and
    pytest's capture) works no matter which module logged first."""

    def __init__(self):
        logging.Handler.__init__(self)

    @property
    def stream(self):
        return sys.stderr


def initialize_logging(level: int = logging.INFO) -> logging.Logger:
    """initializeLogging parity: the package logger with the glog line
    format."""
    global _initialized
    logger = logging.getLogger(_ROOT)
    if not _initialized:
        handler = _StderrHandler()
        handler.setFormatter(logging.Formatter(_FMT, "%m%d %H:%M:%S"))
        logger.addHandler(handler)
        logger.propagate = False
        _initialized = True
    logger.setLevel(level)
    return logger


def get_logger(name: str = _ROOT) -> logging.Logger:
    initialize_logging()
    return logging.getLogger(name)


def set_min_log_level(level: int) -> None:
    """setMinLogLevel parity (glog numeric levels also accepted: 0..3 ->
    INFO/WARNING/ERROR/FATAL)."""
    glog_map = {0: logging.INFO, 1: logging.WARNING, 2: logging.ERROR,
                3: logging.CRITICAL}
    initialize_logging().setLevel(glog_map.get(level, level))


def version() -> str:
    """version::printVersion parity — framework + runtime versions."""
    import torch

    cuda = torch.version.cuda or "none"
    return (f"paddle_tpu_torch {VERSION} (target {ISA_TARGET}, "
            f"torch {torch.__version__}, cuda {cuda})")


def print_version() -> None:
    print(version())
