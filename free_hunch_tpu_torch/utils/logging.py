"""Rank-prefixed logging and the rank-0 stdout/stderr tee.

Counterpart of ``free_hunch_tpu/utils/logging.py``. The rank comes from
``parallel/dist.py`` (``torch.distributed``), not from the environment.
"""
from __future__ import annotations

import logging
import sys

from free_hunch_tpu_torch.parallel.dist import get_rank


class _CurrentStderr:
    """Stream proxy that resolves ``sys.stderr`` at write time, so log lines
    follow a later ``Tee`` redirect (a plain StreamHandler binds the stream
    object at setup time and would bypass it)."""

    def write(self, text):
        return sys.stderr.write(text)

    def flush(self):
        return sys.stderr.flush()


class _RankFilter(logging.Filter):
    """Stamps each record with the rank at the time it is logged: the
    logger is made at import, before the process group may exist."""

    def filter(self, record):
        record.rank = get_rank()
        return True


def setup_logger(name: str = "free_hunch_tpu_torch", level=logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(_CurrentStderr())
        h.addFilter(_RankFilter())
        h.setFormatter(logging.Formatter("[rank %(rank)s] %(asctime)s %(levelname)s "
                                         "%(message)s"))
        logger.addHandler(h)
        logger.setLevel(level)
        logger.propagate = False
    return logger


class Tee:
    """Mirror stdout/stderr into a log file (rank 0 only by convention)."""

    def __init__(self, file_path: str, mode: str = "w"):
        self.file = open(file_path, mode)
        self.stdout = sys.stdout
        self.stderr = sys.stderr

    def __enter__(self):
        sys.stdout = _Split(self.stdout, self.file)
        sys.stderr = _Split(self.stderr, self.file)
        return self

    def __exit__(self, *exc):
        sys.stdout, sys.stderr = self.stdout, self.stderr
        self.file.close()
        return False


class _Split:
    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for s in self.streams:
            s.write(text)

    def writelines(self, lines):
        for line in lines:
            self.write(line)

    def flush(self):
        for s in self.streams:
            s.flush()

    def isatty(self):
        return False

    def close(self):
        # the Tee owns its file handle; the wrapped std streams stay open
        self.flush()
