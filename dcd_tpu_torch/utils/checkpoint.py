"""Checkpoints of a trainer, and the reference's torch weight files.

:class:`Checkpointer` is the counterpart of the JAX package's orbax
checkpointer (``dcd_tpu/utils/checkpoint.py:24-112``; the reference's
``DetectronCheckpointer``, DGDE/utils/check_point.py:12-178) with
``torch.save`` in place of orbax. A checkpoint holds the model's state dict
(parameters and BN buffers), the AdamW state and the update count, under the
same names: ``model_checkpoint_N``, ``model_final`` and the ``last_checkpoint``
tag file that ``--resume`` reads. Restored into a trainer built from the same
config, the next steps are bitwise those the saved trainer would have taken.
Under several processes the command lines save on process 0 alone (the
ranks hold the same weights), and every rank restores from its file.
The GMW command line saves its model, AdamW state, update count and epoch
the same way (:meth:`Checkpointer.save_gmw`), under the JAX GMW command
line's names (``checkpoint_epoch_N``, ``model_best``, ``checkpoint_final``).

:func:`load_torch_dgde` reads a reference DGDE ``.pth``: the port's state
dict already has the reference's names and layout (the DCN offset convs
interleaved, as the reference's CUDA kernel reads them), so it loads as is.
:func:`load_torch_dla34` loads the reference's ImageNet DLA-34 weights into
the detector's trunk, the counterpart of ``import_torch_dla34`` (:297).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from .weights import load_state

SUFFIX = ".pt"
TRUNK = "backbone.base."


class Checkpointer:
    """Saves and restores a :class:`dcd_tpu_torch.engine.train.Trainer`, or a
    GMW and its state, under ``save_dir``; at most ``max_to_keep`` ``model_checkpoint_*`` files are
    kept (the oldest go first; ``model_final`` stays)."""

    def __init__(self, save_dir: str, max_to_keep: int = 10):
        self.save_dir = os.path.abspath(save_dir)
        self.max_to_keep = max_to_keep
        os.makedirs(self.save_dir, exist_ok=True)

    def _tag_file(self) -> str:
        return os.path.join(self.save_dir, "last_checkpoint")

    def _write(self, name: str, tree: Dict) -> str:
        path = os.path.join(self.save_dir, name + SUFFIX)
        tmp = path + ".tmp"
        torch.save(tree, tmp)
        os.replace(tmp, path)
        with open(self._tag_file(), "w") as f:
            f.write(name + SUFFIX)
        if name.startswith("model_checkpoint_"):
            self._prune()
        return path

    def save(self, name: str, trainer) -> str:
        return self._write(name, {
            "step": trainer.optimizer.count,
            "model": trainer.model.state_dict(),
            "optimizer": trainer.optimizer.adamw.state_dict(),
        })

    def save_gmw(self, name: str, model: torch.nn.Module, state, epoch: int) -> str:
        """A GMW model and its :class:`..engine.gmw_train.GMWState` at the end
        of ``epoch``. The epoch and the update count are kept apart: the JAX
        command line saves the epoch in ``step`` and keeps optax's update
        count, which its LR schedule reads, inside ``opt_state``; the port's
        ``GMWState.step`` is that count and the schedule's input."""
        return self._write(name, {
            "epoch": int(epoch),
            "step": state.step,
            "model": model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
        })

    def _prune(self) -> None:
        kept = sorted(Path(self.save_dir).glob(f"model_checkpoint_*{SUFFIX}"),
                      key=lambda p: int(p.stem[len("model_checkpoint_"):]))
        for old in kept[:max(len(kept) - self.max_to_keep, 0)]:
            old.unlink()

    def has_checkpoint(self) -> bool:
        return os.path.exists(self._tag_file())

    def last_checkpoint(self) -> Optional[str]:
        if not self.has_checkpoint():
            return None
        with open(self._tag_file(), "r") as f:
            return os.path.join(self.save_dir, f.read().strip())

    def resolve(self, path: str) -> str:
        """A checkpoint file by path, or by bare name (``model_final``) in the
        checkpoint directory, as the JAX package resolves ``--ckpt``. An
        orbax checkpoint (a directory) cannot be read by the port: raises."""
        for cand in (path, path + SUFFIX, os.path.join(self.save_dir, path),
                     os.path.join(self.save_dir, path + SUFFIX)):
            if os.path.isfile(cand):
                return os.path.abspath(cand)
            if os.path.isdir(cand):
                raise NotImplementedError(
                    f"{cand} is a directory, an orbax checkpoint of the JAX package; the port "
                    "reads torch.save checkpoints only (convert the weights with "
                    "utils/weights.py::from_jax_variables where JAX runs)")
        raise FileNotFoundError(f"no checkpoint {path!r} (nor under {self.save_dir})")

    def _read(self, path: Optional[str], device) -> Optional[Dict]:
        path = self.last_checkpoint() if path is None else path
        if path is None:
            return None
        return torch.load(self.resolve(path), map_location=device, weights_only=True)

    def load(self, trainer, path: Optional[str] = None, model_only: bool = False) -> bool:
        """Restore the last checkpoint (or ``path``) into ``trainer`` in
        place; returns False when there is none. ``model_only`` loads the
        weights and BN buffers and keeps the trainer's optimizer state and
        update count (the reference's finetune, check_point.py:98-114)."""
        tree = self._read(path, trainer.device)
        if tree is None:
            return False
        trainer.model.load_state_dict(tree["model"])
        if not model_only:
            trainer.optimizer.adamw.load_state_dict(tree["optimizer"])
            trainer.optimizer.count = int(tree["step"])
        return True

    def load_model(self, model: torch.nn.Module, path: Optional[str] = None) -> bool:
        """The weights and BN buffers of the last checkpoint (or ``path``)
        into ``model``; returns False when there is none."""
        tree = self._read(path, next(model.parameters()).device)
        if tree is None:
            return False
        model.load_state_dict(tree["model"])
        return True

    def load_gmw(self, model: torch.nn.Module, state, path: Optional[str] = None) -> Optional[int]:
        """Restore a :meth:`save_gmw` checkpoint (the last one unless
        ``path``) into ``model`` and ``state`` in place: the weights, the
        AdamW state and the update count. Returns the epoch it was saved at,
        or None when there is no checkpoint."""
        tree = self._read(path, state.device)
        if tree is None:
            return None
        model.load_state_dict(tree["model"])
        state.optimizer.load_state_dict(tree["optimizer"])
        state.step = int(tree["step"])
        return int(tree["epoch"])


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A torch ``.pth`` as a flat numpy state dict: unwraps ``{"model": ...}``
    and ``{"state_dict": ...}`` containers, drops the ``module.`` prefix of a
    ``DataParallel`` model and BN's ``num_batches_tracked`` counters, and
    keeps tensors alone (the JAX package's ``load_torch_checkpoint``).
    Local files only: the catalog and URL sources of the JAX package need a
    download."""
    if path.startswith(("catalog://", "http://", "https://")):
        raise NotImplementedError(f"{path}: the port reads local .pth files only (no downloads)")
    loaded = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model", "state_dict"):
        if isinstance(loaded, dict) and isinstance(loaded.get(key), dict):
            loaded = loaded[key]
    out = {}
    for k, v in loaded.items():
        if not torch.is_tensor(v) or k.endswith("num_batches_tracked"):
            continue
        out[k[len("module."):] if k.startswith("module.") else k] = v.detach().numpy()
    return out


def load_torch_dgde(model: torch.nn.Module, path: str) -> None:
    """Load a reference DGDE checkpoint (the whole KeypointDetector) into
    ``model``; every parameter and BN buffer must be in the file."""
    load_state(model, load_torch_checkpoint(path))


@torch.no_grad()
def load_torch_dla34(model: torch.nn.Module, path: str) -> int:
    """Load ImageNet DLA-34 weights (the reference's ``dla34`` state dict,
    dla_dcn.py:344-358) into the detector's trunk, ``backbone.base``; the
    classifier (``fc``) and anything else outside the trunk are ignored.
    Every trunk parameter and BN buffer must be in the file, at its shape.
    Returns the number of tensors loaded."""
    sd = load_torch_checkpoint(path)
    own = {k: v for k, v in model.state_dict().items()
           if k.startswith(TRUNK) and not k.endswith("num_batches_tracked")}
    missing = [k for k in own if k[len(TRUNK):] not in sd]
    if missing:
        raise KeyError(f"{path} lacks trunk tensors {[k[len(TRUNK):] for k in missing[:5]]}")
    for k, t in own.items():
        src = torch.from_numpy(np.asarray(sd[k[len(TRUNK):]], np.float32))
        if tuple(src.shape) != tuple(t.shape):
            raise ValueError(f"{k}: file has {tuple(src.shape)}, model {tuple(t.shape)}")
        t.copy_(src)
    return len(own)
