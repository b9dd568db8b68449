"""DGDE (stage 1) training / evaluation / gen-for-GMW command line of the port.

The twin of the JAX package's ``tools/train_dgde.py`` (the reference's
``DGDE/tools/plain_train_net.py`` + ``engine/trainer.py``): the iteration
loop with the warmup/decay LR, loss logging every 10 iterations, periodic
checkpoints and ``model_final``; ``--eval`` (the test split one image at a
time, KITTI txt files, the KITTI AP protocol, ``inference/result.json``);
``--generate_for_GMW`` (``gen_data/gen_data_{train,infer}.json`` under the
working directory); ``--finetune CKPT`` (the weights and BN buffers of CKPT,
the update count from 0, no update of ``cfg.model.freeze_names``); ``--vis N``
with ``--eval`` (``OUTPUT/vis/<id>.png`` for the first N images: the
detections and the ground truth in the frame and in a bird's-eye panel). It
takes the same flags, and two more: ``--device`` (``cuda`` unless asked for
``cpu``; with no card it raises) and ``--dist_backend``.

Several processes (``--coordinator host:port --num_processes N
--process_id I``, one command per process) train data-parallel, as the JAX
command line does over its global mesh: they rendezvous through
:func:`dcd_tpu_torch.parallel.initialize_distributed`, process I runs on card
``I % device_count`` (NCCL by default; ``--dist_backend gloo`` puts several
ranks on one card or runs them on the CPU), reads its slice of each global
batch of ``SOLVER.IMS_PER_BATCH`` images and trains with BN and the loss
over the global batch (``engine/train.py``). Only process 0 logs to the
console and the log file, writes the metrics and saves checkpoints;
``--resume`` loads that file on every rank. ``--eval`` writes each rank's
share of the test split's txt files, waits for every rank, and process 0
computes the AP; ``--generate_for_GMW`` runs on process 0 while the others
wait.

    python -m dcd_tpu_torch.tools.train_dgde --data_root KITTI/training --output logs
    python -m dcd_tpu_torch.tools.train_dgde --data_root ... --output logs --eval --resume
    python -m dcd_tpu_torch.tools.train_dgde --data_root ... --output logs --generate_for_GMW --resume
    python -m dcd_tpu_torch.tools.train_dgde --config finetune.yaml --data_root ... --output ft \
        --finetune logs/ckpt/model_final.pt
    python -m dcd_tpu_torch.tools.train_dgde --data_root ... --output logs --eval --resume --vis 4
    python -m dcd_tpu_torch.tools.train_dgde --data_root ... --output logs \
        --coordinator localhost:29500 --num_processes 2 --process_id 0   # and 1, in another shell

An orbax checkpoint of the JAX package cannot be read (``--ckpt DIR`` raises).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import platform
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import Config, dgde_run_config, load_yaml_config
from ..data.gen_data import (GenDataInferWriter, GenDataTrainWriter, normalize_batch_kpts,
                             normalize_kpts_2d)
from ..data.kitti_dataset import InferenceSampler, KITTIDataset, _load_image, make_data_loader
from ..data.target_encoder import EncodedSample, collate
from ..engine.gen import make_gen_step
from ..engine.infer import format_kitti_lines, infer
from ..engine.train import Trainer, build_trainer, train_step
from ..evaluation import evaluate_from_files
from ..parallel import barrier, default_backend, initialize_distributed, shutdown
from ..utils.checkpoint import Checkpointer, load_torch_dgde
from ..utils.logger import setup_logger
from ..utils.metrics import MetricLogger
from ..utils.timer import Timer
from ..utils.visualize import gt_rows_from_objects, save_scene_visualization
from ..utils.writer import MetricWriter

LOGGER = "dcd_tpu_torch"


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    # the JAX CLI's flags (engine/defaults.py:15-70), and --device
    p = argparse.ArgumentParser(description="DGDE training on the port")
    p.add_argument("--config", default=None, help="experiment yaml (reference runs/DGDE.yaml layout)")
    p.add_argument("--data_root", required=False, default=None, help="KITTI training dir")
    p.add_argument("--output", default="./logs")
    p.add_argument("--eval", action="store_true", help="evaluate only")
    p.add_argument("--generate_for_GMW", action="store_true")
    p.add_argument("--ckpt", default=None,
                   help="a checkpoint of this port (name or path), or a reference DGDE .pth/.pkl")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--num_iters", type=int, default=None, help="override max iterations")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--pretrain", default=None, metavar="PTH",
                   help="ImageNet DLA-34 weights, a local .pth (reference dla_dcn.py:344-358)")
    p.add_argument(
        "--finetune", default=None, metavar="CKPT",
        help="load model weights from a checkpoint of this port, reset the iteration "
        "counter, and freeze cfg.model.freeze_names (reference check_point.py:98-114)",
    )
    p.add_argument(
        "--vis", type=int, default=0, metavar="N",
        help="with --eval: write debug panels (pred+GT wireframes, BEV) for the first N "
        "images to OUTPUT/vis (reference visualize_infer.show_image_with_boxes)",
    )
    p.add_argument(
        "--per_sample_calib", action="store_true",
        help="with --generate_for_GMW: normalize each sample's keypoints with its OWN "
        "calibration. Default keeps the reference quirk of using sample 0's calib for the "
        "whole batch (detector_loss.py:150)",
    )
    p.add_argument("--seed", type=int, default=0)
    # multi-host
    p.add_argument("--coordinator", default=None, help="host:port of process 0's rendezvous")
    p.add_argument("--num_processes", type=int, default=1)
    p.add_argument("--process_id", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--dist_backend", default=None, choices=("nccl", "gloo"),
                   help="the process group's backend: nccl on cuda, gloo on cpu by default")
    return p.parse_args(argv)


def check_multihost_flags(args: argparse.Namespace) -> None:
    """Refuse inconsistent multi-host flags before any rendezvous."""
    if args.num_processes < 1:
        raise ValueError(f"--num_processes {args.num_processes} is not a count of processes")
    if not 0 <= args.process_id < args.num_processes:
        raise ValueError(f"--process_id {args.process_id} is not in [0, {args.num_processes})")
    if args.num_processes > 1 and not args.coordinator:
        raise ValueError(f"--num_processes {args.num_processes} needs --coordinator host:port")


def process_device(args: argparse.Namespace) -> torch.device:
    """``--device``; under several processes on cuda, card
    ``process_id % device_count``."""
    device = torch.device(args.device)
    if device.type == "cuda" and device.index is None and args.num_processes > 1:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA was asked for and no CUDA device is available; "
                               "pass --device cpu to run on the CPU")
        device = torch.device("cuda", args.process_id % torch.cuda.device_count())
    return device


def make_config(args: argparse.Namespace) -> Config:
    cfg = dgde_run_config()
    if args.config:
        cfg = load_yaml_config(args.config, base=cfg)
    if args.batch_size:
        cfg = dataclasses.replace(
            cfg, solver=dataclasses.replace(cfg.solver, ims_per_batch=args.batch_size))
    cfg = dataclasses.replace(cfg, output_dir=args.output, seed=args.seed)
    if args.pretrain:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, pretrain=True, pretrain_path=args.pretrain))
    return cfg


def run(args: argparse.Namespace) -> Dict:
    """Train, evaluate or generate as the flags say. Returns what the run
    did: the trainer, and the iterations' logs, the evaluation's speed and
    AP, or the gen files' paths."""
    check_multihost_flags(args)
    device = process_device(args)
    group = initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                                   backend=args.dist_backend or default_backend(device),
                                   device=device)
    try:
        return _run(args, device, group)
    finally:
        if group is not None:
            shutdown()


def _run(args: argparse.Namespace, device: torch.device, group) -> Dict:
    cfg = make_config(args)
    rank = args.process_id if group is not None else 0
    logger = setup_logger(LOGGER, cfg.output_dir, rank)
    card = torch.cuda.get_device_name(device) if device.type == "cuda" and torch.cuda.is_available() else "-"
    logger.info(f"env: python {platform.python_version()} | torch {torch.__version__} | "
                f"device {device} ({card}) | processes {args.num_processes} | "
                f"{platform.platform()}")

    loader = make_data_loader(cfg, args.data_root, is_train=True, process_index=rank,
                              process_count=args.num_processes)
    iters_per_epoch = max(len(loader.dataset) // cfg.solver.ims_per_batch, 1)
    max_iter = args.num_iters or int(cfg.solver.max_epochs * iters_per_epoch)

    trainer = build_trainer(cfg, device=device, seed=args.seed, iters_per_epoch=iters_per_epoch,
                            process_group=group)
    ckptr = Checkpointer(os.path.join(cfg.output_dir, "ckpt"))
    if args.resume and ckptr.has_checkpoint():
        ckptr.load(trainer)
        logger.info(f"resumed at step {trainer.optimizer.count}")
    elif args.finetune:
        # the weights and BN buffers only; the new trainer's update count (0)
        # and AdamW state stay, and its optimizer leaves cfg.model.freeze_names
        # out (reference Checkpointer.finetune, check_point.py:98-114)
        ckptr.load(trainer, args.finetune, model_only=True)
        logger.info(f"finetune from {args.finetune}; frozen: {list(cfg.model.freeze_names)}")
    elif args.ckpt and args.ckpt.endswith((".pth", ".pkl")):
        # a reference torch checkpoint: the full detector, weights only
        load_torch_dgde(trainer.model, args.ckpt)
        logger.info(f"imported torch DGDE checkpoint {args.ckpt}")
    elif args.ckpt:
        ckptr.load(trainer, args.ckpt)

    if args.eval:
        return dict(trainer=trainer, **run_eval(cfg, args, trainer.model, logger, rank))
    if args.generate_for_GMW:
        out = generate_for_gmw(cfg, args, trainer.model, logger) if rank == 0 else {}
        barrier(group)
        return dict(trainer=trainer, **out)
    return dict(trainer=trainer, **train(cfg, trainer, loader, ckptr, iters_per_epoch, max_iter,
                                         logger, rank))


def train(cfg: Config, trainer: Trainer, loader, ckptr: Checkpointer, iters_per_epoch: int,
          max_iter: int, logger, rank: int = 0) -> Dict:
    """The iteration loop. Under several processes every rank steps on its
    slice of each global batch; rank 0 alone writes metrics and
    checkpoints."""
    meters = MetricLogger()
    writer = MetricWriter(os.path.join(cfg.output_dir, "writer"), process_index=rank)
    save_every = int(cfg.solver.save_checkpoint_epoch_interval * iters_per_epoch)
    start = trainer.optimizer.count
    # continue the deterministic sample stream where the restored step left off
    loader.start_batch = start
    if loader.buckets:
        logger.info(f"multi-scale buckets: {[(b.width, b.height) for b in loader.buckets]}")
    iterations = []
    batches = iter(loader)
    try:
        t_end = time.perf_counter()
        for iteration, batch in zip(range(start, max_iter), batches):
            data_time = time.perf_counter() - t_end
            batch.pop("img_ids", None)
            logs = {k: float(v) for k, v in train_step(trainer, batch).items()}  # waits for the card
            batch_time = time.perf_counter() - t_end
            t_end = time.perf_counter()
            meters.update(time=batch_time, data=data_time, **logs)
            iterations.append(dict(iteration=iteration, time=batch_time, data=data_time, logs=logs))
            if iteration % 10 == 0:
                logger.info(f"iter {iteration}/{max_iter}  {meters}")
                writer.write_scalars(iteration, logs, prefix="train/")
            if save_every > 0 and (iteration + 1) % save_every == 0 and rank == 0:
                ckptr.save(f"model_checkpoint_{(iteration + 1) // iters_per_epoch}", trainer)
    finally:
        batches.close()  # stops the loader's threads
        writer.close()
    if rank == 0:
        ckptr.save("model_final", trainer)
    barrier(trainer.process_group)
    logger.info("training done")
    return dict(iterations=iterations)


def _infer_sample(cfg: Config, model, s: EncodedSample) -> Dict[str, np.ndarray]:
    """The eval-mode forward + postprocess of one sample, rows back as numpy."""
    t = s.targets
    out = infer(model, torch.from_numpy(s.image[None]),
                torch.from_numpy(t["edge_indices"][None]).long(),
                torch.from_numpy(t["edge_len"][None]).long(),
                *(torch.from_numpy(np.asarray(t[k][None], np.float32))
                  for k in ("calib_P_full", "pad_size", "image_size")), cfg=cfg)
    return {k: v.cpu().numpy() for k, v in out.items()}


def run_eval(cfg: Config, args: argparse.Namespace, model, logger, rank: int = 0) -> Dict:
    """Inference over the test split one image at a time into
    ``OUTPUT/inference/data/<id>.txt``, then the KITTI AP protocol on those
    files and ``OUTPUT/inference/result.json``. A first call is made and
    kept out of the timer (builds and first launches). With ``--vis N`` the
    first N images' panels go to ``OUTPUT/vis/<id>.png``, outside the timer.
    Under several processes each rank infers its shard of the split
    (``InferenceSampler``) and writes its files; after a barrier rank 0
    computes the AP on all of them, as the JAX command line does."""
    ds = KITTIDataset(cfg, args.data_root, is_train=False, augment=False)
    shard = list(InferenceSampler(len(ds), rank, args.num_processes))
    out_dir = os.path.join(cfg.output_dir, "inference", "data")
    os.makedirs(out_dir, exist_ok=True)
    vis_dir = os.path.join(cfg.output_dir, "vis")
    vis_paths = []
    if args.vis:
        os.makedirs(vis_dir, exist_ok=True)
    model.eval()
    device = next(model.parameters()).device
    timer = Timer(device)
    for i in shard:
        s = ds.get_sample(i)
        if i == shard[0]:
            _infer_sample(cfg, model, s)
        timer.tic()
        out = _infer_sample(cfg, model, s)
        timer.toc()
        lines = format_kitti_lines(out["dets"][0], out["valid"][0])
        with open(os.path.join(out_dir, f"{s.img_id}.txt"), "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
        if len(vis_paths) < args.vis:
            # detections are in original-image coordinates, so draw on the
            # raw (unpadded) frame; no heatmap, as the JAX command line
            vis_paths.append(os.path.join(vis_dir, f"{s.img_id}.png"))
            save_scene_visualization(
                vis_paths[-1], _load_image(os.path.join(ds.image_dir, f"{s.img_id}.png")),
                out["dets"][0], out["valid"][0], s.calib,
                gt_rows=gt_rows_from_objects(ds._load_objects(s.img_id) or []))
    images_per_s = 1.0 / max(timer.average_time, 1e-9)
    logger.info(f"inference: {images_per_s:.1f} img/s")
    barrier()  # every rank's txt files are on disk
    out = dict(images=len(shard), images_per_s=images_per_s,
               seconds_per_image=timer.average_time, out_dir=out_dir, vis=vis_paths)
    if rank != 0:
        return out
    t0 = time.perf_counter()
    result, ret = evaluate_from_files(
        os.path.join(args.data_root, "label_2"),
        out_dir,
        os.path.join(args.data_root, "ImageSets", f"{cfg.datasets.test_split}.txt"),
        current_class=list(cfg.datasets.detect_classes),
        metric=cfg.test.metric[0],
    )
    ap_seconds = time.perf_counter() - t0
    logger.info("\n" + result)
    ap = {k: float(v) for k, v in ret.items()}
    with open(os.path.join(cfg.output_dir, "inference", "result.json"), "w") as f:
        json.dump(ap, f, indent=1)
    return dict(out, ap=ap, result=result, ap_seconds=ap_seconds)


def generate_for_gmw(cfg: Config, args: argparse.Namespace, model, logger) -> Dict:
    """The gen-data pass (reference trainer.py:89-98,208-221 + inference
    hook): the frozen-BN gen step over the train split into
    ``gen_data/gen_data_train.json``, then an inference pass over the test
    split into ``gen_data/gen_data_infer.json``, both under the working
    directory."""
    gen_cfg = dataclasses.replace(cfg, test=dataclasses.replace(cfg.test, generate_gmw=True))
    M = gen_cfg.datasets.max_objects
    # one pass over train, no shuffling, no augmentation, BN frozen
    ds = KITTIDataset(gen_cfg, args.data_root, is_train=True, augment=False)
    writer = GenDataTrainWriter()
    gen_step = make_gen_step(gen_cfg, model)
    bs = gen_cfg.solver.ims_per_batch
    for start in range(0, len(ds) - bs + 1, bs):  # the last partial batch is dropped
        samples = [ds.get_sample(i) for i in range(start, start + bs)]
        out = {k: v.cpu().numpy() for k, v in gen_step(collate(samples)).items()}
        m = out["mask"].astype(bool)
        objs = np.nonzero(m.reshape(-1))[0]
        # default reproduces the reference quirk (calib[0].P for the whole
        # batch, detector_loss.py:150); --per_sample_calib corrects it
        kpts_norm = normalize_batch_kpts(out["kpts_2d_img"][m], objs // M,
                                         [s.calib.P for s in samples],
                                         per_sample_calib=args.per_sample_calib)
        writer.add_batch(kpts_norm, out["kpts_3d"][m], out["pred_rot"][m], out["gt_location"][m],
                         out["pred_location"][m], [samples[k // M].img_id for k in objs])
    os.makedirs("gen_data", exist_ok=True)
    train_path = os.path.join("gen_data", "gen_data_train.json")
    writer.dump(train_path)
    logger.info(f"wrote {train_path}")

    ds_val = KITTIDataset(gen_cfg, args.data_root, is_train=False, augment=False)
    iw = GenDataInferWriter()
    model.eval()
    for i in range(len(ds_val)):
        s = ds_val.get_sample(i)
        out = _infer_sample(gen_cfg, model, s)
        iw.add_image(s.img_id, out["dets"][0], out["valid"][0],
                     normalize_kpts_2d(out["kpts_2d"][0], s.calib.P), out["kpts_3d"][0])
    infer_path = os.path.join("gen_data", "gen_data_infer.json")
    iw.dump(infer_path)
    logger.info(f"wrote {infer_path}")
    return dict(train_json=os.path.abspath(train_path), infer_json=os.path.abspath(infer_path))


def main(argv: Optional[List[str]] = None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
