"""bf16 against fp32 inference on one checkpoint: how far bf16 moves the
detector's outputs end to end.

    python -m dcd_tpu_torch.tools.bf16_rows --ckpt build/convergence_ckpt \\
        [--scenes 16] [--device cpu] [--out build/bf16_rows.json]

The detector is built twice from the checkpoint, in fp32 and with
``cfg.model.fp16`` (bf16 activations, the same fp32 weights), and runs the
inference forward (lazy top-K heads) and ``postprocess`` on the held-out
synthetic scenes of ``tools/convergence_run.py`` (seeds 10000+, 8 cars),
scores from the heatmap alone and detection threshold 0, so that all 50 rows
of each image are compared. It prints one JSON object: the heatmap's largest
difference; the share of the fp32 peaks that bf16 also chose and, at those,
each head's largest difference over that head's largest magnitude; and the
share of the fp32 rows that have a bf16 row (nearest 2D box centre and
depth) within 1e-3, 1e-2 and 2e-2 of each column's largest magnitude, over
all rows and over the confident ones (fp32 score at least the shipped
detection threshold).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import List, Optional

import numpy as np
import torch

from ..config import dgde_run_config
from ..data import synthetic
from ..data.target_encoder import collate, encode_targets
from ..engine.infer import build_detector, postprocess
from ..engine.train import batch_to_device
from ..models.predictor import Converter_key2channel
from .offset_stats import load_checkpoint

ROW_TOLS = (1e-3, 1e-2, 2e-2)


def compare(cfg, fp32: dict, bf16: dict, rows32: dict, rows16: dict, confident: float) -> dict:
    """The differences of the bf16 outputs (heads and rows) from the fp32;
    ``confident`` is the score from which a row counts as a detection."""
    head = cfg.model.head
    k2c = Converter_key2channel(head.regression_heads, head.regression_channels)
    p32, p16 = fp32["points_xy"].cpu().numpy(), bf16["points_xy"].cpu().numpy()
    pairs = []
    for b in range(p32.shape[0]):
        where = {tuple(p): i for i, p in enumerate(p16[b])}
        pairs += [(b, j, where[tuple(p)]) for j, p in enumerate(p32[b]) if tuple(p) in where]
    b, i32, i16 = (torch.tensor(x) for x in zip(*pairs)) if pairs else [torch.zeros(0, dtype=torch.long)] * 3
    out = {"cls_max_abs": float((bf16["cls"] - fp32["cls"]).abs().max()),
           "matched_peaks": len(pairs) / p32.shape[0] / p32.shape[1], "heads": {}}
    for key, _ in head.reg_channels_flat:
        want = fp32["reg_pois"][b, i32, k2c(key)]
        got = bf16["reg_pois"][b, i16, k2c(key)]
        out["heads"][key] = float((got - want).abs().max() / want.abs().max().clamp_min(1e-30)) if len(pairs) else None
    d32, d16 = rows32["dets"].cpu().numpy(), rows16["dets"].cpu().numpy()
    v32 = rows32["valid"].cpu().numpy()
    scale = np.abs(d32).max(axis=(0, 1)).clip(1e-6)
    centre = lambda d: np.stack([d[:, 2] + d[:, 4], d[:, 3] + d[:, 5], d[:, 11]], 1)
    worst, score = [], []
    for bb in range(d32.shape[0]):
        c16, c32 = centre(d16[bb]), centre(d32[bb])
        for i in np.nonzero(v32[bb])[0]:
            j = int(np.argmin(np.abs(c16 - c32[i]).sum(1)))
            worst.append(float((np.abs(d16[bb, j] - d32[bb, i]) / scale).max()))
            score.append(float(d32[bb, i, 13]))
    worst, score = np.array(worst), np.array(score)
    for tag, sel in (("rows", np.ones(len(worst), bool)), ("confident_rows", score >= confident)):
        out[tag] = int(sel.sum())
        out[f"{tag}_within"] = {str(t): int((worst[sel] <= t).sum()) for t in ROW_TOLS}
    out["rows_errs"] = worst.tolist()
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="bf16 against fp32 inference on one checkpoint")
    ap.add_argument("--ckpt", required=True, help="port checkpoint file or directory")
    ap.add_argument("--scenes", type=int, default=16)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)

    base = dgde_run_config()
    cfg = dataclasses.replace(base, test=dataclasses.replace(
        base.test, uncertainty_as_confidence=False, detections_threshold=0.0))
    models = {}
    for fp16 in (False, True):
        c = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, fp16=fp16))
        models[fp16] = build_detector(c, args.device)
        load_checkpoint(models[fp16], args.ckpt)
    dev = next(models[False].parameters()).device
    samples = [encode_targets(*synthetic.make_scene(seed=10_000 + s, num_objs=8), cfg)
               for s in range(args.scenes)]
    per_batch = []
    with torch.no_grad():
        for lo in range(0, len(samples), 4):
            batch = batch_to_device({k: v for k, v in collate(samples[lo:lo + 4]).items()
                                     if not isinstance(v, list)}, dev)
            post = [batch[k].float() for k in ("calib_P_full", "pad_size", "image_size")]
            outs = {}
            for fp16, model in models.items():
                preds = model(batch["images"], batch["edge_indices"], batch["edge_len"], lazy_topk=True)
                outs[fp16] = (preds, postprocess(cfg, preds, *post))
            per_batch.append(compare(cfg, outs[False][0], outs[True][0], outs[False][1], outs[True][1],
                                     base.test.detections_threshold))
    result = {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "scenes": args.scenes,
        "cls_max_abs": max(r["cls_max_abs"] for r in per_batch),
        "matched_peaks": float(np.mean([r["matched_peaks"] for r in per_batch])),
        "heads": {k: max(r["heads"][k] for r in per_batch if r["heads"][k] is not None)
                  for k in per_batch[0]["heads"]},
        "rows_median_err": float(np.median(sum((r["rows_errs"] for r in per_batch), []))),
        "confident_score": base.test.detections_threshold,
    }
    for tag in ("rows", "confident_rows"):
        n = sum(r[tag] for r in per_batch)
        result[tag] = n
        result[f"{tag}_within"] = {t: sum(r[f"{tag}_within"][t] for r in per_batch) / max(n, 1)
                                   for t in map(str, ROW_TOLS)}
    text = json.dumps(result)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
