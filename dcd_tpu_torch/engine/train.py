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

With ``cfg.model.fp16`` the step trains as the JAX package's does under
the same switch (``dcd_tpu/engine/train.py:1-8,47``): bf16 activations
(the detector's forward in bf16, the DCN kernels' bf16 entry points
forward and backward), fp32 parameters and optimizer state (each layer
casts its weights to bf16 and autograd brings their gradients back to
fp32), fp32 losses (the heads' outputs that the loss reads are fp32), and
no loss scaling. With ``cfg.model.remat`` the forward of each microbatch
runs under ``torch.utils.checkpoint`` and is recomputed in the backward,
as the JAX package's ``jax.checkpoint``; the recomputation leaves BN's
running statistics alone (``models/layers.py::frozen_running_stats``), so
the step equals the one without remat. The trainer starts from seeded
random weights, with the ImageNet DLA-34 trunk of
``cfg.model.pretrain_path`` loaded over them when that names a local file.

Given a process group (``build_trainer(..., process_group=...)``, one
process per card, :mod:`dcd_tpu_torch.parallel`), the step is data-parallel
as the JAX package's over its ``data`` mesh: each rank holds its slice of
the global batch (``parallel.shard_batch``), BN takes the global batch's
moments, the loss divides by the global batch's counts and each rank's
objective is its share of the global loss times the group's size, so that
``DistributedDataParallel``'s mean of the gradients is the gradient of the
global loss; the clip and the update follow the reduction, as optax's
follow the psum. The logs are the global ones. With A microbatches the
first A - 1 backward passes run under ``no_sync`` and one all-reduce
follows the last.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Mapping, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel
from torch.utils.checkpoint import checkpoint

from ..config import Config
from ..models.detector import KeypointDetector
from ..models.dla import Tree
from ..models.layers import frozen_running_stats, use_process_group
from ..parallel.mesh import all_reduce_sum, replicate
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
    # data parallelism: the group, and the model's DDP wrapper
    process_group: Optional[dist.ProcessGroup] = None
    ddp: Optional[DistributedDataParallel] = None


class _Forward(nn.Module):
    """The detector's train-mode forward, recomputed in the backward with
    ``remat``: the module that DDP wraps, so that the recomputation stays
    inside one DDP forward."""

    def __init__(self, model: KeypointDetector, remat: bool):
        super().__init__()
        self.model = model
        self.remat = remat

    def forward(self, images, edge_indices, edge_len):
        if not self.remat:
            return self.model(images, edge_indices, edge_len)
        return checkpoint(self.model, images, edge_indices, edge_len, use_reentrant=False,
                          context_fn=lambda: (contextlib.nullcontext(),
                                              frozen_running_stats(self.model)))


def unused_in_training(model: KeypointDetector) -> List[str]:
    """Names of the parameters that a training step gives no gradient: the
    projection of each inner DLA tree, which computes a residual that only
    leaves use (``models/dla.py::Tree``; its BN statistics still move)."""
    names = []
    for prefix, mod in model.named_modules():
        if isinstance(mod, Tree) and mod.levels > 1 and mod.project is not None:
            names += [f"{prefix}.project.{n}" for n, _ in mod.project.named_parameters()]
    return names


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
                  iters_per_epoch: int = 1000,
                  process_group: Optional[dist.ProcessGroup] = None) -> Trainer:
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

    ``cfg.model.fp16`` trains with bf16 activations and fp32 parameters,
    ``cfg.model.remat`` recomputes each microbatch's forward in the backward
    (module docstring).

    With ``process_group`` every rank starts from rank 0's weights and
    buffers, BN reduces its moments over the group, and the model is wrapped
    in ``DistributedDataParallel`` (buffers not broadcast: BN's statistics
    agree already; the parameters of :func:`unused_in_training` left out of
    the reduction). ``trainer.model`` stays the detector.
    """
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    dev = resolve_device(device)
    model = build_detector(cfg, dev, seed).train()
    if cfg.model.pretrain and cfg.model.pretrain_path is not None:
        load_torch_dla34(model, cfg.model.pretrain_path)
    trainer = Trainer(cfg, model, Optimizer(cfg, model, iters_per_epoch), dev)
    if process_group is not None:
        replicate(model, process_group)
        use_process_group(model, process_group)
        forward = _Forward(model, bool(cfg.model.remat))
        DistributedDataParallel._set_params_and_buffers_to_ignore_for_model(
            forward, [f"model.{n}" for n in unused_in_training(model)])
        trainer.ddp = DistributedDataParallel(
            forward, device_ids=[dev.index] if dev.type == "cuda" else None,
            process_group=process_group, broadcast_buffers=False)
        trainer.process_group = process_group
    return trainer


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
    total loss and the gradients' global norm (before the clip). With a
    process group ``batch`` is this rank's slice, and the gradients and logs
    are those of the global batch (module docstring)."""
    cfg, model, group = trainer.cfg, trainer.model, trainer.process_group
    forward = trainer.ddp if trainer.ddp is not None else _Forward(model, bool(cfg.model.remat))
    share = 1.0 if group is None else float(dist.get_world_size(group))
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
            sync = trainer.ddp is None or i == accum - 1
            with contextlib.nullcontext() if sync else trainer.ddp.no_sync():
                preds = forward(mb["images"], mb["edge_indices"], mb["edge_len"])
                total, _, logs = compute_losses(cfg, preds, mb, group)
                (total * share / accum).backward()
            for k, v in {**logs, "total_loss": total}.items():
                sums[k] = sums.get(k, 0.0) + v.detach()
        if group is not None:  # the ranks' shares summed: the global logs
            keys = list(sums)
            summed = all_reduce_sum(torch.stack([sums[k] for k in keys]), group)
            sums = dict(zip(keys, summed.unbind()))
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
