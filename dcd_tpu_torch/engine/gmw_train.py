"""GMW (stage 2) training and depth refinement.

The counterpart of ``dcd_tpu/engine/gmw_train.py`` (the loops of the
reference's ``GMW/main.py``): the train step with ``loss = cls_weight *
correspondenceLoss + reg_weight * reg_loss`` (:454-461), the epoch-50 weight
flip (:312-315), AdamW with a cosine LR stepped per epoch (:255-272), and the
validation-side location rescale (:542-547).

The JAX package's optimizer is optax's chain ``scale_by_adam(0.9, 0.999)``
-> ``add_decayed_weights(wd)`` -> ``scale_by_learning_rate(schedule)``:
``p - lr * (adam + wd * p)``, which is ``torch.optim.AdamW`` (eps 1e-8)
with the LR set before each update from the update count. A step runs in
PyTorch's deterministic mode (two states from one seed given the same
batches reach the same bits).

Given a process group (``create_gmw_state(..., process_group=...)``) the
step is data-parallel, as the JAX command line's over its local devices: each
rank holds an equal slice of the batch, and ``DistributedDataParallel``
averages the gradients. The losses are batch means and ``gcn_norm`` works
per sample, so that mean is the gradient of the global batch's loss. Whether
the step is finite is decided on the global loss, and the logs are the
global ones.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from ..models import gmw as G
from ..parallel.mesh import all_reduce_sum, replicate
from .infer import resolve_device
from .train import deterministic_algorithms


@dataclass(frozen=True)
class GMWConfig:
    """Mirrors GMW/main.py argparse defaults (:47-93)."""

    num_kpts: int = 73
    features: int = 128
    depth: int = 12
    lr: float = 1e-4
    weight_decay: float = 1e-4
    epochs: int = 100
    batch_size: int = 8
    cls_weight: float = 1.0
    reg_weight: float = 0.1
    reg_loss_start_epoch: int = 50
    topk: int = 1500
    sinkhorn_lambda: float = 10.0


@dataclass
class GMWState:
    """The optimizer, its LR schedule and the update count."""

    optimizer: torch.optim.AdamW
    schedule: Callable[[int], float]
    device: torch.device
    step: int = 0
    # data parallelism: the group, and the model's DDP wrapper
    process_group: Optional[dist.ProcessGroup] = None
    ddp: Optional[DistributedDataParallel] = None


def epoch_cosine_lr(cfg: GMWConfig, steps_per_epoch: int) -> Callable[[int], float]:
    """Cosine LR annealed per *epoch*, evaluated at the update count before
    the update (as optax's ``scale_by_learning_rate`` does):
    lr(count) = 0.5 lr (1 + cos(pi epoch / epochs)), epoch = count //
    steps_per_epoch, capped at ``epochs``: the reference's
    CosineAnnealingLR(T_max=epochs) stepped once per epoch."""
    steps_per_epoch = max(int(steps_per_epoch), 1)

    def schedule(count: int) -> float:
        epoch = min(int(count) // steps_per_epoch, cfg.epochs)
        return 0.5 * cfg.lr * (1.0 + math.cos(math.pi * epoch / cfg.epochs))

    return schedule


def create_gmw_state(cfg: GMWConfig, seed: int = 0, steps_per_epoch: int = 1,
                     device: Union[str, torch.device, None] = None,
                     process_group: Optional[dist.ProcessGroup] = None) -> Tuple[G.GMW, GMWState]:
    """The GMW on ``device`` (``cuda`` unless the caller names another;
    raises without a card) with flax-initialised weights drawn from
    ``torch.Generator`` ``seed``, and its optimizer state.
    ``steps_per_epoch`` drives the per-epoch LR schedule. Sets
    ``CUBLAS_WORKSPACE_CONFIG`` for the process when it is not set, as
    ``build_trainer`` does, for the deterministic mode's cuBLAS. With
    ``process_group`` every rank starts from rank 0's weights and the step
    is data-parallel (module docstring)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    dev = resolve_device(device)
    model = G.GMW(cfg.num_kpts, cfg.features, cfg.depth, cfg.sinkhorn_lambda)
    G.init_weights(model, torch.Generator().manual_seed(seed))
    model = model.to(dev)
    schedule = epoch_cosine_lr(cfg, steps_per_epoch)
    opt = torch.optim.AdamW(model.parameters(), lr=schedule(0), betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay)
    state = GMWState(opt, schedule, dev)
    if process_group is not None:
        replicate(model, process_group)
        state.process_group = process_group
        state.ddp = DistributedDataParallel(
            model, device_ids=[dev.index] if dev.type == "cuda" else None,
            process_group=process_group)
    return model, state


def _to_device(batch: Mapping, dev: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                               dtype=torch.float32).to(dev) for k, v in batch.items()}


def make_gmw_train_step(cfg: GMWConfig, model: G.GMW):
    """``step(state, batch, cls_w, reg_w) -> logs``: one AdamW update of
    ``model`` and ``state`` in place. batch: kpts_2d (B, n, 2), kpts_3d
    (B, n, 3), pred_rot (B,), gt_depth (B,), numpy or tensors. When the
    loss is not finite the gradients become zeros and the optimizer still
    steps (moments decay, weight decay applies, the count advances), as the
    JAX step does; nothing waits for the device to decide it. With a process
    group the batch is this rank's slice and the logs are the global batch's."""
    E = cfg.num_kpts * (cfg.num_kpts - 1) // 2

    def step(state: GMWState, batch: Mapping, cls_w: float, reg_w: float) -> Dict[str, torch.Tensor]:
        batch = _to_device(batch, state.device)
        with deterministic_algorithms():
            pre_depths, good_idx = G.compute_z(batch["kpts_2d"], batch["kpts_3d"],
                                               batch["pred_rot"], cfg.topk)
            model.train()
            model.zero_grad(set_to_none=True)
            net = model if state.ddp is None else state.ddp
            reg_weights, P = net(batch["kpts_2d"], batch["kpts_3d"])
            eye = torch.eye(E, device=state.device)  # broadcast over the batch
            cls_loss = G.correspondence_loss(P, eye)
            reg_loss, pred_depth = G.compute_reg_loss(pre_depths, reg_weights, batch["gt_depth"],
                                                      good_idx)
            total = cls_w * cls_loss + reg_w * reg_loss
            total.backward()
            mae = (torch.abs(pred_depth - batch["gt_depth"]) / batch["gt_depth"]).mean()
            logs = torch.stack([total, cls_loss, reg_loss, mae]).detach()
            if state.process_group is not None:  # the ranks' means, averaged
                logs = all_reduce_sum(logs, state.process_group) / dist.get_world_size(
                    state.process_group)
            finite = torch.isfinite(logs[0])
            for p in model.parameters():
                p.grad = torch.where(finite, p.grad, torch.zeros_like(p.grad))
            for group in state.optimizer.param_groups:
                group["lr"] = state.schedule(state.step)
            state.optimizer.step()
            state.step += 1
        return dict(zip(("loss", "cls_loss", "reg_loss", "depth_MAE"), logs.unbind()))

    return step


def make_gmw_predict(cfg: GMWConfig, model: G.GMW) -> Callable[[Mapping], torch.Tensor]:
    """``predict(batch) -> refined depth (B,)`` on the model's device
    (GMW/main.py:524-547 before the location rescale). The transport P
    does not enter the depth, so the Sinkhorn layer is not run."""

    @torch.no_grad()
    def predict(batch: Mapping) -> torch.Tensor:
        batch = _to_device(batch, next(model.parameters()).device)
        pre_depths, good_idx = G.compute_z(batch["kpts_2d"], batch["kpts_3d"], batch["pred_rot"],
                                           cfg.topk)
        reg_weights, _ = model.cost(batch["kpts_2d"], batch["kpts_3d"])
        _, pred_depth = G.compute_reg_loss(pre_depths, reg_weights,
                                           torch.zeros_like(pre_depths[:, 0]), good_idx)
        return pred_depth

    return predict


def rescale_location(raw_location: np.ndarray, pred_depth: np.ndarray,
                     dims_hwl: np.ndarray) -> np.ndarray:
    """Move the detection along its camera ray to the refined depth
    (reference GMW/main.py:542-547): shift to the mid-height centre, scale
    by the depth ratio, shift back."""
    raw = np.asarray(raw_location, np.float64).copy()
    h = np.asarray(dims_hwl)[:, 0]
    scale = np.asarray(pred_depth) / raw[:, 2]
    raw[:, 1] -= h / 2
    out = scale[:, None] * raw
    out[:, 1] += h / 2
    return out


def loss_weights_for_epoch(cfg: GMWConfig, epoch: int) -> Tuple[float, float]:
    """(cls, reg) loss weights: the flip at reg_loss_start_epoch
    (GMW/main.py:312-315)."""
    if epoch >= cfg.reg_loss_start_epoch:
        return 0.1, 1.0
    return cfg.cls_weight, cfg.reg_weight
