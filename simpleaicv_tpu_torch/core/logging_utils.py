"""Logger set-up (counterpart of ``simpleaicv_tpu/core/logging_utils.py``):
a stream handler and a weekly rotating file ``<log_dir>/<name>.log``, format
``%(asctime)s - %(message)s``. Callers log on process 0 only
(``core.platform.process_index``).
"""

from __future__ import annotations

import logging
import logging.handlers
import os


def get_logger(name: str, log_dir: str | None = None) -> logging.Logger:
    """The logger ``name`` with its stream handler and, given ``log_dir``,
    the file handler of ``<log_dir>/<name>.log``; a later call with another
    ``log_dir`` (a second run in the same process) moves the file handler
    there."""
    logger = logging.getLogger(name)
    fmt = logging.Formatter("%(asctime)s - %(message)s")
    if not logger.handlers:
        logger.setLevel(logging.INFO)
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        logger.propagate = False
    if log_dir is not None:
        path = os.path.abspath(os.path.join(log_dir, f"{name}.log"))
        files = [h for h in logger.handlers
                 if isinstance(h, logging.FileHandler)]
        if all(h.baseFilename != path for h in files):
            for h in files:
                logger.removeHandler(h)
                h.close()
            os.makedirs(log_dir, exist_ok=True)
            fh = logging.handlers.TimedRotatingFileHandler(
                path, when="W0", encoding="utf-8")
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger
