"""Process-0-gated logger (reference DGDE/utils/logger.py:8-32); the JAX
package's ``dcd_tpu/utils/logger.py``, but for one change: the port's command
lines also run in-process one after another (``train_dgde.run``,
``train_gmw.run``), so a call with another ``save_dir`` moves the log file
there instead of keeping the first run's."""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

FORMAT = "%(asctime)s %(name)s %(levelname)s: %(message)s"


def setup_logger(name: str, save_dir: Optional[str] = None, process_index: int = 0):
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if process_index > 0:
        return logger
    formatter = logging.Formatter(FORMAT)
    files = [h for h in logger.handlers if isinstance(h, logging.FileHandler)]
    if len(files) == len(logger.handlers):  # no console handler yet
        ch = logging.StreamHandler(stream=sys.stdout)
        ch.setLevel(logging.DEBUG)
        ch.setFormatter(formatter)
        logger.addHandler(ch)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        path = os.path.abspath(os.path.join(save_dir, "log.txt"))
        for h in files:
            if h.baseFilename != path:
                logger.removeHandler(h)
                h.close()
        if not any(h.baseFilename == path for h in files):
            fh = logging.FileHandler(path, mode="a")
            fh.setLevel(logging.DEBUG)
            fh.setFormatter(formatter)
            logger.addHandler(fh)
    return logger
