"""The numbers that decide ``correct``: what the timed path produced, judged
by the plain reference once the window has closed.

Inference. A sample of the window's batches, drawn from the seed, is kept:
the rows and validity that reached the host, and the peaks (point, class)
the program chose. The reference runs each kept batch's frames, in blocks of
images, in the precision the configuration states, and reads:

* ``peak_gap``: the widest gap, in logits, by which the reference's heatmap
  at a peak the program chose lies below the reference's own K-th best peak
  of that frame (0 where the program's peak is at least as good), less the
  heat map's own rounding: half a step of its type on each side (in bf16
  the heat saturates at 1 from a logit of about 6, and values one step
  apart there lie 3.7 logits apart). It is the served token's logit gap of
  a language model, for a detector's top-K.
* ``row_gap``: the rows decoded by the reference at the program's peaks
  against the program's rows, each column's gap over that column's spread
  in the reference rows (angles wrapped), the worst column of a row, and
  the 95th percentile over the kept rows. A quantile and not the widest
  row: the multi-bin orientation and the edge-depth clamps switch on a
  rounding in a few rows of any two sound runs.
* ``frame_gap``: the same row gaps, each frame's median over its rows, and
  the worst frame: a fault in one image slot of the batch touches a
  sixty-fourth of the rows, under ``row_gap``'s quantile.
* ``valid_flips``: the reference decides each row's validity at the
  program's peak: its heat at or over the detection threshold, and (where
  the confidence is taken from the depth error) a depth error under 1, so
  that the final score is above 0. Each switch has a rounding margin of its
  own, in ``limits/<cell>.json``: the heat's in logits of the threshold,
  the depth error's in -log(depth error). A row whose kept validity differs
  from the reference's decision is explained where rounding at the switches
  reaches the program's decision: for a row the reference keeps, either
  switch within its margin; for one it drops, every switch it fails within
  its margin. ``valid_flips`` counts the rows left unexplained.

Training. The step's own object is driven from the seed through its first
three steps in set-up; the reference follows the same three steps from the
same weights on the same batches and reads:

* ``grad_leaves_off``: the first step's gradient as the optimizer got it
  (AdamW's first moment after one step over 1 - beta1), leaf by leaf: the
  gap between the program's and the reference's norm of the leaf over the
  larger of the reference's norm of it and of the median leaf, and the
  number of leaves whose gap is over a tenth. A count and not the worst
  leaf: where the loss's edge-pair top-K meets a near-tie, rounding routes
  the gradient through other keypoints, and the corner-offset head's leaves
  part by up to 0.31 in a sound run, where the bf16 control's worst leaf
  reads as little as 0.39; the control moves 40 leaves and more by over a
  tenth, such a switch 4 (PERF.md, section 2);
* ``median_change_gap``: the same of each leaf's change over the three
  steps, and the median over the leaves, leaving out those whose reference
  gradient is under a thousandth of the median leaf's (they move by
  round-off alone). The median and not the worst leaf: the worst leaf's
  change parts in the later steps, whose losses meet the loss's switches
  (the edge pairs' top-K, the orientation bins), by 0.03-0.18 between sound
  runs, where the bf16 control reads as little as 0.08 (PERF.md, section 2).

The steps' losses (the first step's and the largest gap of the three), the
worst and the median leaf's gradient gap and the worst leaf's change are
reported beside the numbers, not compared: the first step's loss parts by up to 2e-3 between
sound runs where a seed's heat map saturates, and no fault or control reads
ten times that (PERF.md, section 2).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from ..reference import post as ref_post
from ..reference.codec import nms_hm, select_topk

ANGLE_COLUMNS = (1, 12)  # alpha and roty of a KITTI row
SMALL_LEAF = 1e-3  # of the median leaf's gradient norm
LEAF_OFF = 0.1  # a leaf's gradient gap that counts it in ``grad_leaves_off``


@contextlib.contextmanager
def reference_precision() -> Iterator[None]:
    """The reference's own calls in the precision the configuration states,
    as PyTorch runs fp32 by default: matrix products in fp32 (TF32 off) and
    cuDNN's convolutions on TF32 inputs; the caller's settings back after
    them. (A bf16 configuration's products take bf16 inputs either way.)"""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def _logit(p: torch.Tensor) -> torch.Tensor:
    p = p.double()
    return torch.log(p) - torch.log1p(-p)


@torch.no_grad()
def reference_at_peaks(model, frames, points: torch.Tensor, clses: torch.Tensor) -> Dict:
    """The reference at the given peaks of one block of frames: peak gaps
    (b, K) in logits, rows (b, K, 14), validity (b, K) and each row's
    decision margin (b, K)."""
    cfg = model.cfg
    K = cfg.test.detections_per_img
    preds = model(frames.images, frames.edge_indices, frames.edge_len, lazy_topk=False)
    hm, reg = preds["cls"], preds["reg"]
    b, H, W, C = hm.shape
    own = select_topk(nms_hm(hm), K=K)[0]  # (b, K), descending
    idx = (points[..., 1].long() * W + points[..., 0].long()).clamp(0, H * W - 1)
    cls = clses.long().clamp(0, C - 1)
    heat = hm.reshape(b, H * W, C).gather(1, idx[..., None].expand(b, K, C))
    heat = heat.gather(2, cls[..., None])[..., 0]
    dtype = torch.bfloat16 if cfg.model.fp16 else torch.float32
    kth = own[:, -1:].double()
    below = _logit(kth - _half_step(kth, dtype)) - _logit(heat.double() + _half_step(heat, dtype))
    gaps = torch.where(heat.double() >= kth, torch.zeros_like(below), below.clamp(min=0))
    R = reg.shape[-1]
    pois = reg.reshape(b, H * W, R).gather(1, idx[..., None].expand(b, K, R)).float()
    out = ref_post.postprocess(cfg, {"cls": hm, "reg_pois": pois, "scores": heat,
                                     "clses": clses.float(), "points_xy": points.float()},
                               frames.calib_P, frames.pad_size, frames.img_size)
    by_heat, by_error = switch_margins(cfg, heat, out["depth_error"])
    return {"gaps": gaps, "rows": out["dets"], "valid": out["valid"], "by_heat": by_heat,
            "by_error": by_error}


def _half_step(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Half the spacing of ``dtype`` at ``x`` in (0, 1] (the spacing above
    it, at a power of two), in float64."""
    e = torch.frexp(x.double()).exponent  # x = m 2**e, m in [0.5, 1)
    return torch.finfo(dtype).eps * torch.exp2((e - 2).double())


def switch_margins(cfg, heat: torch.Tensor, depth_error: torch.Tensor):
    """Each row's signed distance from its two validity switches, positive
    on the valid side: logit(heat) - logit(threshold), and -log(depth
    error) (+inf where the confidence does not use it; -inf where it is not
    a number)."""
    thr = torch.tensor(float(cfg.test.detections_threshold), dtype=torch.float64)
    by_heat = torch.nan_to_num(_logit(heat) - _logit(thr), nan=-math.inf)
    if cfg.test.uncertainty_as_confidence:
        by_error = torch.nan_to_num(-torch.log(depth_error.double()), nan=-math.inf)
    else:
        by_error = torch.full_like(by_heat, math.inf)
    return by_heat, by_error


def unexplained_flips(valid, got_valid, by_heat, by_error, margins: Mapping[str, float]):
    """The rows whose kept validity differs from the reference's decision
    and that rounding within the switches' margins does not explain."""
    near_heat = np.abs(by_heat) <= margins["heat_logit"]
    near_error = np.abs(by_error) <= margins["depth_error_log"]
    fails_heat, fails_error = ~(by_heat >= 0), ~(by_error > 0)
    explained = np.where(valid, near_heat | near_error,
                         (~fails_heat | near_heat) & (~fails_error | near_error))
    return (valid != got_valid) & ~explained


def row_errors(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """(N, 14) rows -> (N,) worst column gap over the column's spread in
    ``want`` (angles wrapped into [-pi, pi]); equal non-finite values agree,
    a non-finite value against another is infinitely far."""
    d = got.astype(np.float64) - want.astype(np.float64)
    for c in ANGLE_COLUMNS:
        d[:, c] = (d[:, c] + math.pi) % (2 * math.pi) - math.pi
    finite = np.isfinite(want)
    scale = np.array([np.std(want[finite[:, c], c]) if finite[:, c].any() else 1.0
                      for c in range(want.shape[1])])
    scale = np.where(scale > 0, scale, 1.0)
    err = np.abs(d) / scale
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    err = np.where(same, 0.0, np.where(np.isfinite(err), err, np.inf))
    return err.max(axis=1)


def infer_numbers(blocks: Sequence[Mapping[str, np.ndarray]],
                  margins: Mapping[str, float]) -> Tuple[Dict[str, float], Dict]:
    """``peak_gap``, ``row_gap``, ``frame_gap`` and ``valid_flips`` of the
    judged blocks of frames (each: the reference's ``gaps``, ``rows``,
    ``valid``, ``by_heat`` and ``by_error``, the program's ``got_rows`` and
    ``got_valid``) under the switches' rounding ``margins``, and what shows
    beside them."""
    cat = lambda k: np.concatenate([np.asarray(b[k]) for b in blocks])  # noqa: E731
    got, want = cat("got_rows"), cat("rows")
    F, K, C = want.shape
    errs = row_errors(got.reshape(-1, C), want.reshape(-1, C)).reshape(F, K)
    valid, got_valid = cat("valid").astype(bool), cat("got_valid").astype(bool)
    left = unexplained_flips(valid, got_valid, cat("by_heat"), cat("by_error"), margins)
    numbers = {"peak_gap": float(cat("gaps").max()), "row_gap": float(np.quantile(errs, 0.95)),
               "frame_gap": float(np.median(errs, axis=1).max()), "valid_flips": float(left.sum())}
    shown = {"rows_max": float(errs.max()), "flipped": int((valid != got_valid).sum()),
             "valid_share": float(valid.mean()), "rows": int(F * K)}
    return numbers, shown


def train_record(losses: Sequence[float], grads: Mapping[str, float],
                 changes: Mapping[str, float]) -> Dict:
    return {"losses": list(losses), "grads": dict(grads), "changes": dict(changes)}


def _leaf_gaps(got: Mapping[str, float], want: Mapping[str, float], leaves: List[str]) -> np.ndarray:
    med = float(np.median([want[k] for k in leaves]))
    return np.array([abs(got[k] - want[k]) / max(want[k], med) for k in leaves])


def train_numbers(got: Mapping, want: Mapping, worst: bool = False) -> Dict[str, float]:
    """``grad_leaves_off`` and ``median_change_gap`` of two records (with
    ``worst``, also the numbers reported beside them)."""
    losses = [abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])]
    leaves = sorted(want["grads"])
    med = float(np.median([want["grads"][k] for k in leaves]))
    moved = [k for k in leaves if want["grads"][k] >= SMALL_LEAF * med]
    grads = _leaf_gaps(got["grads"], want["grads"], leaves)
    changes = _leaf_gaps(got["changes"], want["changes"], moved)
    out = {"grad_leaves_off": float((grads > LEAF_OFF).sum()),
           "median_change_gap": float(np.median(changes))}
    if worst:
        out.update(first_loss_gap=float(losses[0]), loss_gap=float(max(losses)),
                   grad_gap=float(grads.max()), median_grad_gap=float(np.median(grads)),
                   worst_change_gap=float(changes.max()))
    return out


def verdict(numbers: Mapping[str, float], limits: Mapping[str, float]) -> bool:
    """Every number at or under its limit (a NaN is not)."""
    return all(numbers[k] <= limits[k] for k in limits)
