"""Learning-rate schedules and the optimizer.

The counterpart of ``dcd_tpu/engine/solver.py``, which mirrors the reference
solver (``DGDE/solver/__init__.py:27-92``):

* the multistep schedule: cosine warmup from ``base_lr / 10`` over
  ``warmup_steps`` (CosineWarmupLR, learning_schedules_fastai.py:85-93),
  then x ``lr_decay`` at each epoch of ``decay_epoch_steps``, floored at
  ``lr_clip``;
* OneCycle (learning_schedules_fastai.py:61-85) for the lr and, mirrored,
  the momentum;
* the update of the JAX package's optax chain: the global grad-norm clip
  over every trained parameter first (``clip_grad_norm_``, trainer.py:144),
  then Adam (b1 0.9, b2 0.99, eps 1e-8), decoupled weight decay and the
  step of -lr, with biases at ``bias_lr_factor`` x lr. That is
  ``torch.optim.AdamW`` with two parameter groups. ``adam_onecycle`` is
  AdamW in one group with b1 set to the momentum schedule at every step;
  ``freeze_names`` keeps the named top-level modules out of the optimizer
  and out of the clip's norm, as optax's ``multi_transform`` does.

Schedules take the 0-based update count, as optax's ``scale_by_schedule``.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List, Tuple

import torch

from ..config import Config
from ..utils.profiling import span

Schedule = Callable[[int], float]


def make_lr_schedule(cfg: Config, iters_per_epoch: int) -> Schedule:
    s = cfg.solver
    if s.optimizer == "adam_onecycle":
        return make_onecycle_schedules(cfg)[0]
    base_lr = s.base_lr
    warmup_steps = s.warmup_steps if s.lr_warmup else 0
    decay_steps = [int(e * iters_per_epoch) for e in s.decay_epoch_steps]
    eta_min = base_lr / 10.0  # DIV_FACTOR=10 (solver/__init__.py:86-89)

    def schedule(step: int) -> float:
        if warmup_steps > 0 and step < warmup_steps:
            return eta_min + (base_lr - eta_min) * (1.0 - math.cos(math.pi * step / warmup_steps)) / 2.0
        decay = 1.0
        for ds in decay_steps:
            if step >= ds:
                decay *= s.lr_decay
        return max(base_lr * decay, s.lr_clip)

    return schedule


def _annealing_cos(start: float, end: float, pct: float) -> float:
    """Cosine anneal from start to end as pct goes 0 -> 1."""
    return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)


def make_onecycle_schedules(cfg: Config) -> Tuple[Schedule, Schedule]:
    """(lr, momentum): the lr ramps by cosine from ``base_lr / div_factor``
    to ``base_lr`` over the first ``pct_start`` of ``max_iteration``, then
    falls to ``base_lr / div_factor / 1e4``; the momentum runs the mirror
    cycle moms[0] -> moms[1] -> moms[0]."""
    s = cfg.solver
    T = int(s.max_iteration)
    a1 = int(s.pct_start * T)
    low_lr = s.base_lr / s.div_factor
    m0, m1 = s.moms

    def phase(step: int, up: Tuple[float, float], down: Tuple[float, float]) -> float:
        if step >= a1:
            return _annealing_cos(*down, (step - a1) / max(T - a1, 1))
        return _annealing_cos(*up, step / max(a1, 1))

    def lr(step: int) -> float:
        return phase(step, (low_lr, s.base_lr), (s.base_lr, low_lr / 1e4))

    def mom(step: int) -> float:
        return phase(step, (m0, m1), (m1, m0))

    return lr, mom


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, as optax.global_norm."""
    return torch.sqrt(sum(g.float().pow(2).sum() for g in grads))


class Optimizer:
    """The JAX package's optax chain over a module's parameters.

    ``step()`` applies one update from the parameters' ``.grad``: the clip,
    then AdamW at the schedules' values for the current update count."""

    def __init__(self, cfg: Config, model: torch.nn.Module, iters_per_epoch: int):
        s = cfg.solver
        frozen = set(cfg.model.freeze_names)
        live = [(n, p) for n, p in model.named_parameters() if n.split(".")[0] not in frozen]
        self.params: List[torch.Tensor] = [p for _, p in live]
        self.clip = s.grad_norm_clip
        self.count = 0
        self.lr_schedule = make_lr_schedule(cfg, iters_per_epoch)
        self.mom_schedule = None
        if s.optimizer == "adam_onecycle":
            # the fastai wrapper lumps the whole model into one group
            self.mom_schedule = make_onecycle_schedules(cfg)[1]
            groups = [{"params": self.params, "lr_factor": 1.0}]
        elif s.bias_lr_factor != 1.0:
            groups = [
                {"params": [p for n, p in live if not n.endswith(".bias")], "lr_factor": 1.0},
                {"params": [p for n, p in live if n.endswith(".bias")],
                 "lr_factor": s.bias_lr_factor},
            ]
        else:
            groups = [{"params": self.params, "lr_factor": 1.0}]
        self.adamw = torch.optim.AdamW(groups, lr=s.base_lr, betas=(0.9, 0.99), eps=1e-8,
                                       weight_decay=s.weight_decay)

    def lr(self) -> float:
        """The lr of the next update (the schedule at the update count)."""
        return self.lr_schedule(self.count)

    @torch.no_grad()
    def step(self) -> None:
        with span("dcd.optimizer"):
            grads = []
            for p in self.params:
                if p.grad is None:  # optax updates (decays) every leaf
                    p.grad = torch.zeros_like(p)
                grads.append(p.grad)
            if self.clip > 0:
                # optax.clip_by_global_norm: g * clip / norm where norm >= clip
                with span("dcd.optimizer.clip"):
                    norm = global_norm(grads)
                    factor = torch.where(norm < self.clip, torch.ones_like(norm), self.clip / norm)
                    torch._foreach_mul_(grads, factor)
            lr = self.lr()
            for group in self.adamw.param_groups:
                group["lr"] = lr * group["lr_factor"]
                if self.mom_schedule is not None:
                    group["betas"] = (self.mom_schedule(self.count), 0.99)
            self.adamw.step()
            self.count += 1
