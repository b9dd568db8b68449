"""Process-0-gated logger (reference DGDE/utils/logger.py:8-32); a copy of
the JAX package's ``dcd_tpu/utils/logger.py``."""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional


def setup_logger(name: str, save_dir: Optional[str] = None, process_index: int = 0):
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if process_index > 0:
        return logger
    if logger.handlers:
        return logger
    ch = logging.StreamHandler(stream=sys.stdout)
    ch.setLevel(logging.DEBUG)
    formatter = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
    ch.setFormatter(formatter)
    logger.addHandler(ch)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(save_dir, "log.txt"), mode="a")
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    return logger
