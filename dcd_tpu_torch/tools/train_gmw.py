"""GMW (stage 2) training / validation command line of the port.

The twin of the JAX package's ``tools/train_gmw.py`` (the reference's
``GMW/main.py``): it loads ``gen_data_{train,infer}.json``, trains the
graph-matching weighting network with the epoch-50 loss-weight flip,
validates every ``--val_every`` epochs by refining the detections' depths
and rewriting their KITTI txt files (``model_best`` on a better metric),
saves ``checkpoint_epoch_N`` every ``--save_every`` epochs and
``checkpoint_final``, and validates once more at the end. The metric is Car
AP3D|R40 moderate with ``--kitti_path``, else the negative mean relative
depth shift from the raw estimate. It takes the same flags, and one more:
``--device`` (``cuda`` unless asked for ``cpu``; with no card it raises).

    python -m dcd_tpu_torch.tools.train_gmw --train_data gen_data/gen_data_train.json \\
        --val_data gen_data/gen_data_infer.json --kitti_path KITTI --log_dir logs/gmw
    python -m dcd_tpu_torch.tools.train_gmw --val_data ... --log_dir logs/gmw --evaluate --resume

As the JAX command line does:

- ``--resume`` restores the weights, the AdamW state, the update count (the
  LR schedule's input) and the epoch, and draws the batch order anew from
  ``--seed``: the epochs after a resume see the orders of the first epochs.
- The batches are ``np.random.RandomState(seed)`` permutations, the last
  partial batch of an epoch dropped.

The initial weights are flax's initialisers drawn from ``torch.Generator``
``--seed``, so one seed gives other weights than JAX's PRNG: to start both
packages from the same weights, convert JAX's into a checkpoint
(``utils/weights.py::from_jax_gmw_params``, :meth:`Checkpointer.save_gmw`) and
``--resume``.

As the JAX command line shards each batch over its local devices, the port
trains data-parallel over the local cards: the largest count of cards that
divides ``--batch_size``, one process per card (NCCL), each on its slice of
every batch (:func:`data_parallel_size`, :func:`rank_worker`). Process 0
alone logs, validates and saves. On one card, or on the CPU, it is one
process, as before.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np

from ..data.gen_data import load_gen_data_infer, load_gen_data_train
from ..engine.gmw_train import (GMWConfig, create_gmw_state, loss_weights_for_epoch,
                                make_gmw_predict, make_gmw_train_step, rescale_location)
from ..evaluation import evaluate_from_files
from ..parallel import barrier, launch, shard_batch
from ..utils.checkpoint import Checkpointer
from ..utils.logger import setup_logger
from ..utils.metrics import MetricLogger

LOGGER = "dcd_tpu_torch.gmw"
AP_KEY = "Car_3d_moderate_R40_0.70"


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    # the JAX CLI's flags (GMW/main.py:47-93), and --device
    p = argparse.ArgumentParser(description="GMW training on the port")
    p.add_argument("--train_data", default="gen_data/gen_data_train.json")
    p.add_argument("--val_data", default="gen_data/gen_data_infer.json")
    p.add_argument("--kitti_path", default=None)
    p.add_argument("--log_dir", default="logs/gmw")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--cls_weight", type=float, default=1.0)
    p.add_argument("--reg_weight", type=float, default=0.1)
    p.add_argument("--reg_loss_start_epoch", type=int, default=50)
    p.add_argument("--evaluate", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--save_every", type=int, default=5,
                   help="epochs between checkpoints (reference GMW/main.py:318)")
    p.add_argument("--val_every", type=int, default=5,
                   help="epochs between validations (reference GMW/main.py:316-320)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_kpts", type=int, default=73)
    p.add_argument(
        "--topk", type=int, default=1500,
        help="edges kept by |dV| in compute_z (GMW/main.py:404); must be "
        "<= num_kpts*(num_kpts-1)/2 for reduced-keypoint runs",
    )
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p.parse_args(argv)


def make_config(args: argparse.Namespace) -> GMWConfig:
    n_pairs = args.num_kpts * (args.num_kpts - 1) // 2
    return GMWConfig(num_kpts=args.num_kpts, lr=args.lr, weight_decay=args.weight_decay,
                     epochs=args.epochs, batch_size=args.batch_size, cls_weight=args.cls_weight,
                     reg_weight=args.reg_weight, reg_loss_start_epoch=args.reg_loss_start_epoch,
                     topk=min(args.topk, n_pairs))


def write_kitti_txts(val_data: str, refined: Dict[str, Dict[int, np.ndarray]], result_dir: str) -> None:
    """One txt per image of ``val_data``: each detection's box, dimensions,
    yaw and score as the JSON holds them, its refined location (the raw one
    where there is none) and the alpha of that location, 7 decimals
    (GMW/main.py:549-564)."""
    with open(val_data) as f:
        raw = json.load(f)
    for img in sorted(raw.keys()):
        lines = []
        for det, a in enumerate(raw[img]):
            loc = refined.get(img, {}).get(det, a["pred_location"])
            box, dim = a["box"], a["dim"]
            ori = a["pred_rot"][0] if isinstance(a["pred_rot"], list) else a["pred_rot"]
            score = a["score"][0] if isinstance(a["score"], list) else a["score"]
            alpha = ori - np.arctan2(loc[0], loc[2])
            lines.append(
                f"Car -1.00 -1 {alpha:.7f} "
                + " ".join(f"{v:.7f}" for v in box)
                + " "
                + " ".join(f"{v:.7f}" for v in dim)
                + " "
                + " ".join(f"{v:.7f}" for v in loc)
                + f" {ori:.7f} {score:.7f}"
            )
        with open(os.path.join(result_dir, f"{img}.txt"), "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))


def run_validation(args: argparse.Namespace, cfg: GMWConfig, predict, logger,
                   epoch: Optional[int] = None) -> Dict:
    """Refine the depths of ``--val_data``'s detections in batches of
    ``--batch_size``, rewrite the KITTI txt files and return the tracked
    metric (GMW/main.py:486-564) with what it came from: the refined
    locations by (image, detection), the depths, the AP and each predict
    call's seconds (each waits for its depths)."""
    arrays, img_idx = load_gen_data_infer(args.val_data, cfg.num_kpts)
    n_val = arrays["kpts_2d"].shape[0]
    result_dir = os.path.join(args.log_dir, "kitti_results_for_eval")
    os.makedirs(result_dir, exist_ok=True)
    refined: Dict[str, Dict[int, np.ndarray]] = {}
    all_depths, predict_seconds = [], []
    bs = max(args.batch_size, 1)
    for start in range(0, n_val, bs):
        sl = slice(start, min(start + bs, n_val))
        batch = {"kpts_2d": arrays["kpts_2d"][sl], "kpts_3d": arrays["kpts_3d"][sl],
                 "pred_rot": arrays["pred_rot"][sl, 0]}
        t0 = time.perf_counter()
        depths = predict(batch).cpu().numpy()
        predict_seconds.append(time.perf_counter() - t0)
        all_depths.append(depths)
        locs = rescale_location(arrays["pred_location"][sl], depths, arrays["dim"][sl])
        for k, (img, det) in enumerate(img_idx[sl]):
            refined.setdefault(img, {})[det] = locs[k]
    write_kitti_txts(args.val_data, refined, result_dir)
    tag = f"epoch {epoch}: " if epoch is not None else ""
    logger.info(f"{tag}wrote refined detections to {result_dir}")
    out = dict(refined=refined, result_dir=result_dir, predict_seconds=predict_seconds,
               depths=np.concatenate(all_depths) if all_depths else np.zeros(0, np.float32))

    if args.kitti_path:
        result, ret = evaluate_from_files(
            os.path.join(args.kitti_path, "training", "label_2"),
            result_dir,
            os.path.join(args.kitti_path, "training", "ImageSets", "val.txt"),
            current_class=0,
            metric="R40",
        )
        logger.info("\n" + result)
        ap = {k: float(v) for k, v in ret.items()}
        return dict(out, metric=ap.get(AP_KEY, float("-inf")), ap=ap, result=result)
    # no labels: track the mean refined depth's distance from the raw
    # estimate as a proxy so best-model selection still functions
    if n_val == 0:
        return dict(out, metric=float("-inf"))
    raw_z = arrays["pred_location"][:, 2]
    mae = float(np.mean(np.abs(out["depths"] - raw_z) / np.maximum(raw_z, 1e-6)))
    logger.info(f"{tag}val depth shift vs raw: {mae:.4f}")
    return dict(out, metric=-mae)


def data_parallel_size(device: str, batch_size: int) -> int:
    """The processes of a training run: the largest count of local cards
    that divides ``batch_size`` (the JAX command line's rule for its local
    devices); 1 on the CPU."""
    import torch

    n = torch.cuda.device_count() if torch.device(device).type == "cuda" else 1
    while n > 1 and batch_size % n:
        n -= 1
    return max(n, 1)


def run(args: argparse.Namespace) -> Dict:
    """Train and validate, or only validate with ``--evaluate``. Returns the
    model and its state, the epoch it started after, each epoch's LR, loss
    weights, batch order, steps (losses and seconds, each step waiting for
    its losses) and validation, the best epoch and the final validation.
    Over several cards (:func:`data_parallel_size`) the training runs in one
    process per card, and the return is process 0's, without the model and
    its state."""
    n = 1 if args.evaluate else data_parallel_size(args.device, args.batch_size)
    if n == 1:
        return _run(args)
    return launch(rank_worker, n, (args,), backend="nccl")[0]


def rank_worker(rank: int, world: int, args: argparse.Namespace) -> Dict:
    """Process ``rank`` of a data-parallel run, inside its process group:
    :func:`run`'s return on rank 0 without the model and its state (None on
    the other ranks)."""
    import torch
    import torch.distributed as dist

    device = args.device
    if torch.device(device).type == "cuda":
        device = f"cuda:{rank % torch.cuda.device_count()}"
    out = _run(args, device=device, group=dist.group.WORLD, rank=rank, world=world)
    barrier()
    if rank != 0:
        return None
    return {k: v for k, v in out.items() if k not in ("model", "state")}


def _run(args: argparse.Namespace, device: Optional[str] = None, group=None, rank: int = 0,
         world: int = 1) -> Dict:
    cfg = make_config(args)
    logger = setup_logger(LOGGER, args.log_dir, rank)

    train = None
    n_train = steps_per_epoch = 0
    if not args.evaluate:
        train = load_gen_data_train(args.train_data, cfg.num_kpts)
        n_train = train["kpts_2d"].shape[0]
        steps_per_epoch = max(n_train // cfg.batch_size, 1)
        logger.info(f"train objects: {n_train} ({steps_per_epoch} steps/epoch)")

    model, state = create_gmw_state(cfg, args.seed, steps_per_epoch=max(steps_per_epoch, 1),
                                    device=device or args.device, process_group=group)
    if world > 1:
        logger.info(f"data-parallel over {world} processes")
    ckptr = Checkpointer(os.path.join(args.log_dir, "ckpt"))
    start_epoch = 0
    if args.resume and ckptr.has_checkpoint():
        start_epoch = ckptr.load_gmw(model, state)
        logger.info(f"resumed at epoch {start_epoch}")

    step = make_gmw_train_step(cfg, model)
    predict = make_gmw_predict(cfg, model)
    rng = np.random.RandomState(args.seed)
    meters = MetricLogger()
    have_val = rank == 0 and bool(args.val_data and os.path.exists(args.val_data))
    best_metric, best_epoch = float("-inf"), None
    epochs = []

    if not args.evaluate:
        for epoch in range(start_epoch + 1, args.epochs + 1):
            cls_w, reg_w = loss_weights_for_epoch(cfg, epoch)
            record = dict(epoch=epoch, lr=state.schedule(state.step), loss_weights=(cls_w, reg_w),
                          order=rng.permutation(n_train), steps=[])
            t_epoch = time.perf_counter()
            for start in range(0, n_train - cfg.batch_size + 1, cfg.batch_size):
                idx = record["order"][start:start + cfg.batch_size]
                batch = {"kpts_2d": train["kpts_2d"][idx], "kpts_3d": train["kpts_3d"][idx],
                         "pred_rot": train["pred_rot"][idx, 0],
                         "gt_depth": train["gt_location"][idx, 2]}
                if world > 1:
                    batch = shard_batch(batch, rank, world)
                t0 = time.perf_counter()
                logs = {k: float(v) for k, v in step(state, batch, cls_w, reg_w).items()}
                record["steps"].append(dict(logs, seconds=time.perf_counter() - t0))
                meters.update(**logs)
            record["seconds"] = time.perf_counter() - t_epoch
            logger.info(f"epoch {epoch}: {meters}")
            # periodic validation + best-model tracking (GMW/main.py:316-320)
            if have_val and args.val_every > 0 and epoch % args.val_every == 0:
                record["validation"] = run_validation(args, cfg, predict, logger, epoch=epoch)
                metric = record["validation"]["metric"]
                if metric > best_metric:
                    best_metric, best_epoch = metric, epoch
                    ckptr.save_gmw("model_best", model, state, epoch)
                    logger.info(f"epoch {epoch}: new best ({metric:.4f})")
            if args.save_every > 0 and epoch % args.save_every == 0 and rank == 0:
                ckptr.save_gmw(f"checkpoint_epoch_{epoch}", model, state, epoch)
            epochs.append(record)
        if rank == 0:
            ckptr.save_gmw("checkpoint_final", model, state, args.epochs)

    # final validation: refine depths and rewrite KITTI txts (GMW/main.py:486-564)
    final = run_validation(args, cfg, predict, logger) if have_val else None
    return dict(model=model, state=state, start_epoch=start_epoch, epochs=epochs,
                best_epoch=best_epoch, best_metric=best_metric, final=final)


def main(argv: Optional[List[str]] = None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
