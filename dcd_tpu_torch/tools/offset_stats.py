"""Offset statistics of a trained detector: how far the DCN offsets reach.

The twin of the JAX package's ``tools/offset_stats.py``: the same flags,
and ``--device`` (``cuda`` unless asked for ``cpu``; with no card it
raises). The deformable convs of both packages clip every offset to the
radius ``cfg.model.backbone.dcn_radius`` (3), where the reference's CUDA
kernel samples unbounded. This tool records every DCN's offsets, before
the clip, on eval-mode forwards (forward hooks on each ``conv_offset_mask``)
and reports per module the fraction of offsets whose magnitude exceeds
each candidate radius.

    python -m dcd_tpu_torch.tools.offset_stats --ckpt build/convergence_ckpt \\
        [--data_root KITTI/training] [--train_steps N] [--batches 4] [--device cpu]

``--ckpt`` is a checkpoint of the port (a ``torch.save`` file, or a
checkpoint directory whose ``last_checkpoint`` names one). Without it the
detector keeps the port's seeded random weights, whose offset convs start
at zero; ``--train_steps`` first trains it in place on synthetic batches,
as the JAX tool does.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import dgde_run_config
from ..data import synthetic
from ..data.target_encoder import collate, encode_targets
from ..engine.train import batch_to_device, build_trainer, train_step
from ..models.layers import DCN
from ..utils.checkpoint import Checkpointer


def collect_offsets(model, images, edge_idx, edge_len) -> Dict[str, np.ndarray]:
    """One eval-mode forward recording every DCN's offsets: {module name:
    (B, H, W, 18) offsets, interleaved (dy, dx) per tap, before the clip}."""
    out = {}

    def hook(name):
        def record(_m, _inputs, om):
            out[name] = om[:, :18].permute(0, 2, 3, 1).float().cpu().numpy()
        return record

    handles = [m.conv_offset_mask.register_forward_hook(hook(name))
               for name, m in model.named_modules() if isinstance(m, DCN)]
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            model(images, edge_idx, edge_len)
    finally:
        model.train(was_training)
        for h in handles:
            h.remove()
    return out


def report(offsets_by_module, radii=(1, 2, 3, 4, 5)) -> List[dict]:
    """Per module: the std, 99.9th percentile and largest offset magnitude,
    and the fraction above each radius."""
    rows = []
    for name, off in sorted(offsets_by_module.items()):
        mag = np.abs(off.reshape(-1))
        row = {
            "module": name,
            "std": float(mag.std()),
            "p99.9": float(np.percentile(mag, 99.9)),
            "max": float(mag.max()),
        }
        for r in radii:
            row[f"frac>|{r}|"] = float((mag > r).mean())
        rows.append(row)
    return rows


def load_checkpoint(model, ckpt: str) -> None:
    """A port checkpoint file, or a checkpoint directory's last one."""
    if os.path.isdir(ckpt):
        if not Checkpointer(ckpt).load_model(model):
            raise FileNotFoundError(f"no checkpoint in {ckpt}")
    else:
        Checkpointer(os.path.dirname(os.path.abspath(ckpt))).load_model(model, ckpt)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="DCN offset statistics of the port's detector")
    p.add_argument("--ckpt", default=None, help="port checkpoint file or directory to load")
    p.add_argument("--data_root", default=None, help="KITTI training dir (default: synthetic)")
    p.add_argument("--train_steps", type=int, default=0,
                   help="fit the model on synthetic batches first (no ckpt case)")
    p.add_argument("--batches", type=int, default=4)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    cfg = dgde_run_config()
    trainer = build_trainer(cfg, args.device, seed=0)
    if args.ckpt:
        load_checkpoint(trainer.model, args.ckpt)
        print(f"loaded checkpoint {args.ckpt}")

    dataset = None
    if args.data_root:
        from ..data.kitti_dataset import KITTIDataset

        dataset = KITTIDataset(cfg, args.data_root, is_train=True, augment=False)

    def make_batch(seed):
        if dataset is not None:
            samples = [dataset.get_sample((seed * 4 + i) % len(dataset)) for i in range(4)]
        else:
            samples = [encode_targets(*synthetic.make_scene(seed=seed * 4 + i, num_objs=8), cfg)
                       for i in range(4)]
        return collate(samples)

    for i in range(args.train_steps):
        logs = train_step(trainer, make_batch(i))
        if i % 10 == 0:
            print(f"  fit step {i}: loss {float(logs['total_loss']):.3f}")

    acc: Dict[str, list] = {}
    for b in range(args.batches):
        batch = batch_to_device(make_batch(1000 + b), trainer.device)
        offs = collect_offsets(trainer.model, batch["images"], batch["edge_indices"],
                               batch["edge_len"])
        for k, v in offs.items():
            acc.setdefault(k, []).append(v)
    rows = report({k: np.concatenate(v) for k, v in acc.items()})
    hdr = list(rows[0].keys())
    print("\t".join(hdr))
    for r in rows:
        print("\t".join(str(round(r[h], 6)) if h != "module" else r[h] for h in hdr))
    worst = max(r["frac>|3|"] for r in rows)
    print(f"\nworst-module fraction escaping the default radius 3: {worst:.2e} "
          f"({'OK: the clip is faithful' if worst < 1e-3 else 'raise dcn_radius or use dcn_impl gather'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
