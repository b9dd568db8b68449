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
forward) and bf16 training (``cfg.model.fp16``). The trainer starts from
seeded random weights, with the ImageNet DLA-34 trunk of
``cfg.model.pretrain_path`` loaded over them when that names a local file.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Dict, Iterator, Mapping, Union

import numpy as np
import torch

from ..config import Config
from ..models.detector import KeypointDetector
from ..utils.checkpoint import load_torch_dla34
from .infer import build_detector, resolve_device
from .loss import compute_losses
from .solver import Optimizer, global_norm


@dataclass
class Trainer:
    cfg: Config
    model: KeypointDetector
    optimizer: Optimizer
    device: torch.device
    # run each step in :func:`deterministic_algorithms` (repeatable steps)
    deterministic: bool = True


@contextlib.contextmanager
def deterministic_algorithms() -> Iterator[None]:
    """PyTorch's deterministic mode for the body, and the caller's settings
    back after it: ``torch.use_deterministic_algorithms(True)`` (gathers and
    scatters whose backward would add with atomics take PyTorch's sorted,
    ordered forms; ``torch.empty`` fills its memory) and deterministic cuDNN
    with ``benchmark`` off (the convolution backward adds in a fixed
    order)."""
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled(),
              torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = before[2:]


def _step_mode(trainer: Trainer):
    return deterministic_algorithms() if trainer.deterministic else contextlib.nullcontext()


def build_trainer(cfg: Config, device: Union[str, torch.device, None] = None, seed: int = 0,
                  iters_per_epoch: int = 1000) -> Trainer:
    """The detector in train mode on ``device`` (``cuda`` unless the caller
    names another; raises without a card), with weights drawn from ``seed``
    as :func:`build_detector` draws them, and its optimizer.

    A train step is made repeatable, as the JAX step is: two trainers built
    from one seed and given the same batches reach bitwise equal losses and
    parameters. For that each step runs in :func:`deterministic_algorithms`
    (``Trainer.deterministic``, on by default), which restores the caller's
    settings after the step; the DCN kernels add in a fixed order already.
    PyTorch refuses cuBLAS in that mode unless ``CUBLAS_WORKSPACE_CONFIG``
    names a fixed workspace, and reads it once, at the process's first
    cuBLAS call: this sets the one process-wide switch,
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` when it is not set, and a caller
    that used cuBLAS before sets it first. (On sm_90 it names PyTorch's
    default workspace, 8 of 4 MiB, so nothing else changes.)

    With ``cfg.model.pretrain`` and a ``pretrain_path``, the trunk is loaded
    from that ImageNet DLA-34 ``.pth`` (:func:`..utils.checkpoint.load_torch_dla34`).
    Without a path the trunk keeps its random weights: the JAX package would
    try the reference's download URL, and the port downloads nothing.
    """
    if cfg.model.fp16:
        raise NotImplementedError("bf16 training is not ported; fp16 runs inference only")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    dev = resolve_device(device)
    model = build_detector(cfg, dev, seed).train()
    if cfg.model.pretrain and cfg.model.pretrain_path is not None:
        load_torch_dla34(model, cfg.model.pretrain_path)
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
    with _step_mode(trainer):
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
    with _step_mode(trainer):
        logs = compute_gradients(trainer, batch)
        logs["lr"] = torch.tensor(trainer.optimizer.lr())
        trainer.optimizer.step()
    return logs
