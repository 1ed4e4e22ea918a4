"""Logging setup: a console handler and a rotating ``info.txt`` (counterpart
of ``esr_tpu/utils/logging.py``).

:func:`setup_logging` configures the root logger as the reference's does: a
console handler that prints the message alone, and, with a log directory, a
``RotatingFileHandler`` on ``<log_dir>/info.txt`` (10 MiB, 5 backups) whose
lines carry the time, the logger's name and the level. A process that is not
the main one (``is_main=False``: a rank other than 0 under data parallelism)
keeps WARNING and above on both. A second call replaces the handlers; it
does not add to them. :class:`~esr_tpu_torch.config.parser.RunConfig` calls
it for every run directory it makes, as the reference's does.
"""

from __future__ import annotations

import logging
import logging.handlers
import os
from typing import Optional

# the reference's file format and rotation
FILE_FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"
MAX_BYTES = 10 * 1024 * 1024
BACKUP_COUNT = 5


def setup_logging(log_dir: Optional[str] = None, level: int = logging.INFO,
                  is_main: bool = True) -> logging.Logger:
    """Configure the root logger (module docstring); returns the
    ``esr_tpu_torch`` logger. Safe to call repeatedly: the root's handlers
    are replaced, and the file handlers an earlier call opened are
    closed."""
    root = logging.getLogger()
    for h in list(root.handlers):
        root.removeHandler(h)
        if isinstance(h, logging.handlers.RotatingFileHandler):
            h.close()
    # INFO at the root keeps third-party DEBUG lines out of the file; the
    # package's own loggers opt into DEBUG by name (get_logger)
    root.setLevel(logging.INFO)

    console = logging.StreamHandler()
    console.setFormatter(logging.Formatter("%(message)s"))
    console.setLevel(level if is_main else logging.WARNING)
    root.addHandler(console)

    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        fileh = logging.handlers.RotatingFileHandler(
            os.path.join(log_dir, "info.txt"), maxBytes=MAX_BYTES, backupCount=BACKUP_COUNT)
        fileh.setFormatter(logging.Formatter(FILE_FORMAT))
        fileh.setLevel(logging.DEBUG if is_main else logging.WARNING)
        root.addHandler(fileh)

    return logging.getLogger("esr_tpu_torch")


def get_logger(name: str, verbosity: int = 2) -> logging.Logger:
    """The logger ``name`` at the reference's verbosity: 0 WARNING, 1 INFO,
    2 DEBUG."""
    levels = {0: logging.WARNING, 1: logging.INFO, 2: logging.DEBUG}
    if verbosity not in levels:
        raise ValueError(f"verbosity {verbosity} not in {list(levels)}")
    logger = logging.getLogger(name)
    logger.setLevel(levels[verbosity])
    return logger
