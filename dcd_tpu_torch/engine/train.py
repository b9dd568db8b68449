"""Training: the detector with its optimizer, and one train step.

The counterpart of ``dcd_tpu/engine/train.py`` (``create_train_state``,
``make_grad_fn``, ``make_train_step``; the reference's loop body,
``DGDE/engine/trainer.py:121-155``). A step is the forward in train mode,
:func:`dcd_tpu_torch.engine.loss.compute_losses`, the backward (through the
DCN kernels' backward on the card), the global grad-norm clip, the AdamW
update and the BN running-statistics update.

With ``solver.grad_accum_steps = A > 1`` the batch is taken as A equal
microbatches in order: each one's gradient is added in with weight 1/A, BN
normalises each microbatch with its own moments and updates the running
statistics once per microbatch, and one optimizer update follows, as the
JAX package's ``lax.scan`` form does.

Not ported yet: ``remat`` (the JAX package's ``jax.checkpoint`` of the
forward) and loading the ImageNet DLA-34 pretrain; the trainer starts from
seeded random weights.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Union

import numpy as np
import torch

from ..config import Config
from ..models.detector import KeypointDetector
from .infer import build_detector, resolve_device
from .loss import compute_losses
from .solver import Optimizer, global_norm


@dataclass
class Trainer:
    cfg: Config
    model: KeypointDetector
    optimizer: Optimizer
    device: torch.device


def build_trainer(cfg: Config, device: Union[str, torch.device, None] = None, seed: int = 0,
                  iters_per_epoch: int = 1000) -> Trainer:
    """The detector in train mode on ``device`` (``cuda`` unless the caller
    names another; raises without a card), with weights drawn from ``seed``
    as :func:`build_detector` draws them, and its optimizer."""
    if cfg.model.pretrain_path is not None:
        raise NotImplementedError("loading a pretrained trunk is not ported")
    dev = resolve_device(device)
    model = build_detector(cfg, dev, seed).train()
    return Trainer(cfg, model, Optimizer(cfg, model, iters_per_epoch), dev)


def batch_to_device(batch: Mapping[str, Union[np.ndarray, torch.Tensor]],
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """A collated batch (numpy or torch) as tensors on ``device``, int64
    edge indices for the gathers."""
    out = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v).to(device)
           for k, v in batch.items()}
    out["edge_indices"] = out["edge_indices"].long()
    out["edge_len"] = out["edge_len"].long()
    return out


def compute_gradients(trainer: Trainer, batch: Mapping) -> Dict[str, torch.Tensor]:
    """Forward, loss and backward of one step, microbatched by
    ``solver.grad_accum_steps``; the gradients are left in the parameters'
    ``.grad``. Returns the log terms averaged over the microbatches, the
    total loss and the gradients' global norm (before the clip)."""
    cfg, model = trainer.cfg, trainer.model
    batch = batch_to_device(batch, trainer.device)
    accum = max(int(cfg.solver.grad_accum_steps), 1)
    B = batch["images"].shape[0]
    if B % accum:
        raise ValueError(f"batch {B} does not split into {accum} microbatches")
    n = B // accum
    model.train()
    model.zero_grad(set_to_none=True)
    sums: Dict[str, torch.Tensor] = {}
    for i in range(accum):
        mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
        preds = model(mb["images"], mb["edge_indices"], mb["edge_len"])
        total, _, logs = compute_losses(cfg, preds, mb)
        (total / accum).backward()
        for k, v in {**logs, "total_loss": total}.items():
            sums[k] = sums.get(k, 0.0) + v.detach()
    logs = {k: v / accum for k, v in sums.items()}
    logs["grad_norm"] = global_norm(p.grad for p in model.parameters() if p.grad is not None)
    return logs


def train_step(trainer: Trainer, batch: Mapping) -> Dict[str, torch.Tensor]:
    """One optimizer step on ``batch`` (a collated batch of
    :mod:`dcd_tpu_torch.data.target_encoder`): every loss and log term,
    ``total_loss``, the step's ``lr`` and the ``grad_norm`` before the clip."""
    logs = compute_gradients(trainer, batch)
    logs["lr"] = torch.tensor(trainer.optimizer.lr())
    trainer.optimizer.step()
    return logs
