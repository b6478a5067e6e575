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
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("%(asctime)s - %(message)s")

    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)

    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.handlers.TimedRotatingFileHandler(
            os.path.join(log_dir, f"{name}.log"), when="W0", encoding="utf-8")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger
