"""The full-size forward with example arguments, and the data-parallel dry
run: the counterparts of ``__graft_entry__.entry`` and
``__graft_entry__.dryrun_multichip`` in the JAX package."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .config import dgde_run_config
from .engine.infer import build_detector, resolve_device


def entry(device=None):
    """(fn, args): the shipped DGDE detector (DLA-34 + deformable decoder +
    heads) at 384x1280 with random weights, and example arguments for it.
    Runs on ``cuda`` unless ``device`` names another device; TF32 is turned
    off, so that fp32 convolutions stay fp32."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dgde_run_config()
    model = build_detector(cfg, dev)
    H, W = cfg.input.height_train, cfg.input.width_train
    L = cfg.max_edge_length
    images = torch.zeros((1, H, W, 3), device=dev)
    edge_idx = torch.zeros((1, L, 2), dtype=torch.long, device=dev)
    edge_len = torch.full((1,), 16, dtype=torch.long, device=dev)

    @torch.no_grad()
    def fn(images, edge_idx, edge_len):
        return model(images, edge_idx, edge_len)

    return fn, (images, edge_idx, edge_len)


# the GMW step's losses and gradients, n ranks against one process: the 1e-5
# of scale to which tests/test_torch_gmw.py holds the small GMW to JAX (a
# bias's gradient: of its weight's gradient's scale)
GMW_REL = 1e-5


def dryrun_multichip(n_devices: int, device: Optional[str] = None, backend: str = "gloo") -> Dict:
    """The DGDE train step and the GMW train step data-parallel over
    ``n_devices`` spawned gloo processes at a tiny configuration, as ``__graft_entry__.dryrun_multichip`` runs
    them over an ``n_devices`` mesh: the DGDE step on ``n_devices`` synthetic
    scenes, one per rank, and the GMW step on one random batch. Asserts
    finite losses, every rank's parameters and buffers bitwise rank 0's, and
    each step equal to the one-process step on the global batch: the DGDE
    step within ``parallel.workers.dgde_step_agreement``'s limits, the GMW
    step's losses and gradients within ``GMW_REL``. Returns the ranks' and
    the one process's results.

    The ranks run on the cards (``cuda``; rank r on card ``r % device_count``,
    so several ranks may share one card over gloo) unless ``device`` names
    another device: ``device="cpu"`` is the dry run on the CPU that the JAX
    package's runs on its virtual CPU devices. With no card ``cuda`` raises."""
    from .data import synthetic
    from .data.target_encoder import collate, encode_targets
    from .engine.gmw_train import GMWConfig
    from .parallel import launch
    from .parallel.workers import (dgde_step, dgde_step_agreement, dgde_step_worker, gmw_step,
                                   gmw_step_worker, small_dgde_config)

    device = str(resolve_device(device))
    cfg = small_dgde_config(dgde_run_config(), ims_per_batch=n_devices)
    samples = [encode_targets(*synthetic.make_scene(seed=s, num_objs=2, image_size=(90, 60)), cfg,
                              img_id=f"{s:06d}") for s in range(n_devices)]
    batch = {k: v for k, v in collate(samples).items() if k != "img_ids"}
    ranks = launch(dgde_step_worker, n_devices, (cfg, batch, 1, 0, device), backend=backend)
    one = dgde_step(cfg, batch, 1, 0, device)
    for r, res in enumerate(ranks):
        _same_on_every_rank("DGDE", ranks, r)
        worst = dgde_step_agreement(cfg, res, one)
        if max(worst.values()) > 1.0:
            raise AssertionError(f"DGDE rank {r} against one process, over the limits: {worst}")
    total = ranks[0]["logs"][0]["total_loss"]
    if not np.isfinite(total):
        raise AssertionError(f"DGDE total_loss {total}")
    print(f"dryrun_multichip({n_devices}): DGDE total_loss={total:.4f} "
          f"(one process {one['logs'][0]['total_loss']:.4f}) OK")

    n_kpts = 10  # tiny towers: 45 edges
    gcfg = GMWConfig(num_kpts=n_kpts, features=16, depth=2, topk=16, batch_size=n_devices)
    rng = np.random.RandomState(0)
    gbatch = {
        "kpts_2d": rng.randn(n_devices, n_kpts, 2).astype(np.float32) * 0.1,
        "kpts_3d": rng.randn(n_devices, n_kpts, 3).astype(np.float32),
        "pred_rot": rng.randn(n_devices).astype(np.float32),
        "gt_depth": (10.0 + rng.rand(n_devices) * 20).astype(np.float32),
    }
    granks = launch(gmw_step_worker, n_devices, (gcfg, gbatch, 1, 1, device), backend=backend)
    gone = gmw_step(gcfg, gbatch, 1, 1, device)
    for r, res in enumerate(granks):
        _same_on_every_rank("GMW", granks, r)
        for k, v in res["logs"][0].items():
            want = gone["logs"][0][k]
            if not np.isfinite(v) or abs(v - want) > GMW_REL * max(abs(want), 1e-12):
                raise AssertionError(f"GMW rank {r}: {k} {v} against one process {want}")
        for k, v in res["grads"].items():
            want = gone["grads"][k]
            err, scale = float(np.abs(v - want).max()), float(np.abs(want).max())
            if k.endswith(".bias"):  # gcn_norm removes a bias: its gradient is rounding noise
                scale = max(scale, float(np.abs(gone["grads"][k[:-4] + "weight"]).max()))
            if err > GMW_REL * scale:
                raise AssertionError(f"GMW rank {r}: gradient {k} off by {err} (scale {scale})")
    print(f"dryrun_multichip({n_devices}): GMW loss={granks[0]['logs'][0]['loss']:.4f} "
          f"(one process {gone['logs'][0]['loss']:.4f}) OK")
    return dict(dgde=dict(ranks=ranks, one=one), gmw=dict(ranks=granks, one=gone))


def _same_on_every_rank(name: str, ranks, r: int) -> None:
    """Rank ``r`` ends with rank 0's parameters and buffers, bit for bit."""
    for k, v in ranks[r]["state"].items():
        if not np.array_equal(v, ranks[0]["state"][k]):
            raise AssertionError(f"{name}: {k} differs between rank {r} and rank 0")
