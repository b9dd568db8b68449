"""Misc utilities: seeding, source backup, dataset catalog.

The counterpart of ``dcd_tpu/utils/misc.py``. Reference counterparts:
``seed_all_rng`` (DGDE/utils/envs.py:10), ``sync_root`` source-tree backup
(utils/backup_files.py, invoked from tools/plain_train_net.py:168-173), and
the dataset catalog (config/paths_catalog.py:3-76).
"""

from __future__ import annotations

import os
import random
import shutil
import time
from typing import Dict, Optional

import numpy as np
import torch


def seed_all_rng(seed: Optional[int] = None) -> int:
    """Seed torch's, numpy's and python's RNGs; returns the seed used (a
    fresh one from the clock and the pid when ``seed`` is None or
    negative, as the JAX package draws it)."""
    if seed is None or seed < 0:
        seed = int(time.time() * 1000) % (2**31) ^ os.getpid()
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    return seed


def backup_source_tree(src_root: str, output_dir: str, exts=(".py", ".yaml", ".cc", ".md")):
    """Copy the source tree into the run directory for reproducibility."""
    dst = os.path.join(output_dir, "source_backup")
    for dirpath, dirnames, filenames in os.walk(src_root):
        dirnames[:] = [
            d for d in dirnames
            if d not in (".git", "__pycache__", ".jax_cache", "logs", ".claude")
        ]
        for fn in filenames:
            if not fn.endswith(exts):
                continue
            src = os.path.join(dirpath, fn)
            rel = os.path.relpath(src, src_root)
            out = os.path.join(dst, rel)
            os.makedirs(os.path.dirname(out), exist_ok=True)
            shutil.copy2(src, out)
    return dst


# Dataset name -> relative roots (reference DatasetCatalog,
# config/paths_catalog.py:3-60; only the KITTI factory exists there too).
DATASET_CATALOG: Dict[str, Dict[str, str]] = {
    "kitti_train": {"root": "kitti/training", "factory": "KITTIDataset"},
    "kitti_test": {"root": "kitti/testing", "factory": "KITTIDataset"},
}


def resolve_dataset(name: str, data_root: str) -> str:
    """Dataset name -> absolute directory."""
    if name not in DATASET_CATALOG:
        raise KeyError(f"unknown dataset {name}; known: {list(DATASET_CATALOG)}")
    return os.path.join(data_root, DATASET_CATALOG[name]["root"])
