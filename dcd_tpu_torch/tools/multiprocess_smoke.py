"""Two real processes of the port, data-parallel, against one process.

The twin of the JAX package's ``tools/multiprocess_smoke.py``. It spawns
two processes that rendezvous over TCP on localhost, as the command line
does (``--coordinator host:port``, :func:`dcd_tpu_torch.parallel.initialize_distributed`),
and:

1. runs 3 data-parallel DGDE train steps at a tiny configuration, each
   process on its half of a global batch of synthetic scenes, and holds
   them to one process's 3 steps on the whole batch: every step's loss
   within 5e-4 relative (the JAX tool's test), the first step within
   ``parallel.workers.dgde_step_agreement``'s limits, and both ranks'
   weights bitwise equal;
2. runs ``train_dgde`` itself in two processes on a synthetic KITTI tree:
   3 iterations, then the sharded ``--eval`` (each rank writes its shard's
   txt files, a barrier, rank 0 computes the AP), and checks a txt per val
   id, ``result.json`` from rank 0 alone, one ``model_final`` and both
   ranks' weights bitwise equal.

It prints the transcript and writes it to ``--out`` (``build/MULTIPROC.md``).

    python -m dcd_tpu_torch.tools.multiprocess_smoke                  # two cards, NCCL
    python -m dcd_tpu_torch.tools.multiprocess_smoke --backend gloo   # both ranks on one card
    python -m dcd_tpu_torch.tools.multiprocess_smoke --device cpu     # gloo on the CPU
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import dgde_run_config
from ..engine.infer import resolve_device
from ..parallel import initialize_distributed, launch, shutdown
from ..parallel.mesh import free_port
from ..parallel.mesh import default_backend
from ..parallel.workers import (dgde_step, dgde_step_agreement, digest, rank_device,
                                small_dgde_config)

REPO = Path(__file__).resolve().parents[2]
LOSS_RTOL = 5e-4  # the JAX tool's test of the 3 steps' losses

TINY_YAML = """\
INPUT:
  HEIGHT_TRAIN: 64
  WIDTH_TRAIN: 128
MODEL:
  BACKBONE:
    CHANNELS: [8, 8, 16, 16, 32, 32]
  HEAD:
    NUM_CHANNEL: 16
SOLVER:
  IMS_PER_BATCH: 2
TEST:
  DETECTIONS_THRESHOLD: 0.0
"""


def step_worker(rank: int, world: int, coordinator: str, backend: str, device: str, cfg,
                batch: Dict, steps: int) -> Dict:
    """``steps`` DGDE steps on this rank's half, after the command line's
    rendezvous."""
    dev = rank_device(device, rank)
    initialize_distributed(coordinator, world, rank, backend=backend, device=torch.device(dev))
    try:
        return dgde_step(cfg, batch, steps, 0, dev, rank, world)
    finally:
        shutdown()


def cli_worker(rank: int, world: int, runs: Sequence[Sequence[str]],
               use_tensorboard: bool) -> List[Dict]:
    """``train_dgde`` as process ``rank`` of ``world``, once per flag list of
    ``runs`` in turn, each with its own rendezvous: what each run returned
    (its iterations' logs, or the evaluation's numbers) and a digest of the
    model's weights and buffers."""
    from ..utils.writer import MetricWriter
    from . import train_dgde

    if not use_tensorboard:  # TensorBoard's import can pull in TensorFlow
        train_dgde.MetricWriter = functools.partial(MetricWriter, use_tensorboard=False)
    results = []
    for argv in runs:
        out = train_dgde.run(train_dgde.parse_args([*argv, "--process_id", str(rank)]))
        trainer = out.pop("trainer")
        state = {k: v.detach().cpu().numpy() for k, v in trainer.model.state_dict().items()}
        keep = ("iterations", "images", "images_per_s", "ap", "out_dir")
        results.append(dict(state_digest=digest(state),
                            **{k: v for k, v in out.items() if k in keep}))
    return results


def run_steps(device: str = "cuda", backend: Optional[str] = None, batch_size: int = 4,
              steps: int = 3) -> Dict:
    """Part 1: ``steps`` DGDE steps over two processes against one, on
    ``device`` (rank r on card ``r % device_count``) over ``backend`` (by
    default NCCL on cuda, gloo on the CPU)."""
    from ..data import synthetic
    from ..data.target_encoder import collate, encode_targets

    cfg = small_dgde_config(dgde_run_config(), max_objects=6, ims_per_batch=batch_size)
    samples = [encode_targets(*synthetic.make_scene(seed=s, num_objs=3, image_size=(90, 60)),
                              cfg, img_id=f"{s:06d}") for s in range(batch_size)]
    batch = {k: v for k, v in collate(samples).items() if k != "img_ids"}
    coordinator = f"127.0.0.1:{free_port()}"
    backend = backend or default_backend(torch.device(device))
    ranks = launch(step_worker, 2, (coordinator, backend, device, cfg, batch, steps),
                   join_group=False)
    one = dgde_step(cfg, batch, steps, 0, device)
    losses = [[s["total_loss"] for s in r["logs"]] for r in ranks]
    ref = [s["total_loss"] for s in one["logs"]]
    agreement = dgde_step_agreement(cfg, ranks[0], one)
    same = all(np.array_equal(v, ranks[1]["state"][k]) for k, v in ranks[0]["state"].items())
    ok = (np.allclose(losses[0], ref, rtol=LOSS_RTOL, atol=0.0) and losses[0] == losses[1]
          and max(agreement.values()) <= 1.0 and same)
    return dict(ok=bool(ok), losses=losses[0], one_process_losses=ref, agreement=agreement,
                ranks_bitwise_equal=same, launches=ranks[0]["launches"])


def cli_runs(data_root: str, config: Optional[str], output: str, device: str = "cuda",
             backend: Optional[str] = None, num_iters: int = 3, extra: Sequence[str] = ()) -> List[List[str]]:
    """The flag lists of part 2 for :func:`cli_worker`: ``num_iters``
    iterations, then ``--eval --resume``, each with a rendezvous of its own
    on localhost, with ``config`` (the shipped configuration when None) and
    the ``extra`` flags."""
    base = ["--device", device, "--data_root", data_root, "--output", output,
            "--num_processes", "2", "--dist_backend",
            backend or default_backend(torch.device(device)), *extra]
    if config is not None:
        base += ["--config", config]
    ports = {free_port()}
    while len(ports) < 2:
        ports.add(free_port())
    return [[*base, "--coordinator", f"127.0.0.1:{port}", *flags]
            for port, flags in zip(sorted(ports), (["--num_iters", str(num_iters)],
                                                   ["--eval", "--resume"]))]


def check_cli(ranks: Sequence[Sequence[Dict]], data_root: str, output: str,
              num_iters: int = 3) -> Dict:
    """Part 2's checks on the two ranks' :func:`cli_worker` results; raises if
    one fails."""
    train, evals = zip(*ranks)
    ckpts = sorted(p.name for p in Path(output, "ckpt").iterdir())
    val_ids = Path(data_root, "ImageSets", "val.txt").read_text().split()
    txts = sorted(p.stem for p in Path(output, "inference", "data").iterdir())
    checks = {
        "model_final written once": ckpts == ["last_checkpoint", "model_final.pt"],
        "a txt per val id": txts == sorted(val_ids),
        "result.json from rank 0": ("ap" in evals[0] and "ap" not in evals[1]
                                    and Path(output, "inference", "result.json").exists()),
        "shards cover the split": evals[0]["images"] + evals[1]["images"] == len(val_ids),
        "ranks' weights bitwise equal": train[0]["state_digest"] == train[1]["state_digest"],
        f"{num_iters} iterations on each rank": [len(r["iterations"]) for r in train] == [num_iters] * 2,
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"train_dgde over 2 processes: {failed} (checkpoints {ckpts}, "
                             f"{len(txts)} txts for {len(val_ids)} val ids)")
    losses = [[it["logs"]["total_loss"] for it in r["iterations"]] for r in train]
    return dict(checks=checks, losses=losses, ap=evals[0]["ap"],
                images=[r["images"] for r in evals], iterations=train[0]["iterations"])


def run_cli(data_root: str, config: Optional[str], output: str, device: str = "cuda",
            backend: Optional[str] = None, num_iters: int = 3, use_tensorboard: bool = True,
            extra: Sequence[str] = ()) -> Dict:
    """Part 2: ``train_dgde`` in two spawned processes (:func:`cli_runs`,
    :func:`cli_worker`), checked by :func:`check_cli`."""
    runs = cli_runs(data_root, config, output, device, backend, num_iters, extra)
    ranks = launch(cli_worker, 2, (runs, use_tensorboard), join_group=False)
    return check_cli(ranks, data_root, output, num_iters)


def main(argv: Optional[List[str]] = None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; rank r on card r %% device_count) or cpu")
    p.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                   help="nccl on cuda, gloo on cpu by default (gloo puts both ranks on one card)")
    p.add_argument("--out", default=str(REPO / "build" / "MULTIPROC.md"))
    args = p.parse_args(argv)
    resolve_device(args.device)  # no card: raises here, before any process starts
    args.backend = args.backend or default_backend(torch.device(args.device))

    steps = run_steps(args.device, args.backend)
    from ..data.synthetic import write_kitti_tree

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(args.out))) as work:
        data_root = write_kitti_tree(os.path.join(work, "kitti"), train_seeds=range(4),
                                     val_seeds=range(4, 9), num_objs=4, image_size=(120, 60))
        config = os.path.join(work, "tiny.yaml")
        Path(config).write_text(TINY_YAML)
        cli = run_cli(data_root, config, os.path.join(work, "logs"), args.device, args.backend,
                      use_tensorboard=False)
    md = [
        "# MULTIPROC — two processes of the port against one",
        "",
        "Produced by `python -m dcd_tpu_torch.tools.multiprocess_smoke "
        f"--device {args.device} --backend {args.backend}`: two processes that rendezvous",
        "over TCP on localhost, as `train_dgde --coordinator` does.",
        "",
        f"- 3-step train losses (2 processes): {steps['losses']}",
        f"- 3-step train losses (1 process, same global batch): {steps['one_process_losses']}",
        f"- first step against one process, each category over its limit: "
        f"{json.dumps({k: float(f'{v:.4g}') for k, v in steps['agreement'].items()})}",
        f"- ranks' weights bitwise equal: {steps['ranks_bitwise_equal']}",
        f"- DDP-equivalence (losses rtol {LOSS_RTOL}, first step within limits): "
        f"{'PASS' if steps['ok'] else 'FAIL'}",
        f"- train_dgde over 2 processes: losses {cli['losses'][0]}; eval shards {cli['images']} "
        f"images; checks {json.dumps(cli['checks'])}",
        "",
    ]
    text = "\n".join(md)
    print(text)
    with open(args.out, "w") as f:
        f.write(text)
    if not steps["ok"]:
        raise SystemExit(1)
    return dict(steps=steps, cli=cli)


if __name__ == "__main__":
    main()
