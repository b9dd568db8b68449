"""Scalar metric writer: TensorBoard when available, JSONL always.

A copy of the JAX package's ``dcd_tpu/utils/writer.py``.

The reference logs losses/LR/depth-MAE to a SummaryWriter
(DGDE/engine/trainer.py:106-175; GMW/main.py:235,479-481). Here the same
scalars go to TensorBoard (via torch.utils.tensorboard, baked into the
image) plus an append-only ``metrics.jsonl`` that needs no viewer. Under
several processes only process 0 writes (``process_index``), as the JAX
command line builds its writer on process 0 only.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricWriter:
    def __init__(self, logdir: str, use_tensorboard: bool = True, process_index: int = 0):
        self.jsonl = self.tb = None
        if process_index > 0:
            return
        os.makedirs(logdir, exist_ok=True)
        self.jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        self.tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(log_dir=logdir)
            except Exception:
                self.tb = None

    def write_scalars(self, step: int, scalars: Dict[str, float], prefix: str = ""):
        if self.jsonl is None:
            return
        row = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            name = f"{prefix}{k}" if prefix else k
            v = float(v)
            row[name] = v
            if self.tb is not None:
                self.tb.add_scalar(name, v, int(step))
        self.jsonl.write(json.dumps(row) + "\n")
        self.jsonl.flush()

    def close(self):
        if self.jsonl is not None:
            self.jsonl.close()
        if self.tb is not None:
            self.tb.close()
