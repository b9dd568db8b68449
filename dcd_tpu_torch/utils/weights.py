"""Weights: the carry from the JAX package, and offsets with trained statistics.

:func:`from_jax_variables` turns the flax variables of
``dcd_tpu.models.detector.KeypointDetector`` into a state dict of the port's
detector, whose names are the reference torch model's. It is the inverse of
``dcd_tpu.utils.checkpoint.import_torch_dgde``:

* conv kernels (kh, kw, Cin, Cout) -> (Cout, Cin, kh, kw); Conv1d kernels
  (k, Cin, Cout) -> (Cout, Cin, k); BN scale/bias/mean/var ->
  weight/bias/running_mean/running_var;
* a DCN's offset conv: flax reads its offsets in block layout (dy_t = ch[t],
  dx_t = ch[K+t]), the reference and the port interleaved (dy_t = ch[2t],
  dx_t = ch[2t+1]), so the carry applies the inverse of the importer's
  channel permutation.

:func:`from_jax_gmw_params` does the same for the stage-2 GMW, the inverse
of ``import_torch_gmw``. Everything here is numpy on the carry side; nothing imports JAX.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from ..config import Config
from ..models.layers import DCN

_BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def offset_conv_perm(K: int) -> np.ndarray:
    """Importer's permutation: flax channel i takes torch channel perm[i]."""
    t = np.arange(K)
    return np.concatenate([2 * t, 2 * t + 1, 2 * K + t])


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _torch_segments(mods, key_index) -> list:
    """Rewrite the flax module path into the reference's module names."""
    out = []
    i = 0
    while i < len(mods):
        m = mods[i]
        nxt = mods[i + 1] if i + 1 < len(mods) else None
        parent = mods[i - 1] if i else None
        pair = {"conv": 0, "bn": 1}
        if m == "base_layer" and nxt in pair:
            out += ["base_layer", str(pair[nxt])]
            i += 2
            continue
        lv = re.fullmatch(r"level([01])_(\d+)", m)
        if lv and nxt in pair:
            out += [f"level{lv[1]}", str(3 * int(lv[2]) + pair[nxt])]
            i += 2
            continue
        if m in ("conv1", "conv2") and parent and parent.startswith("trunc_"):
            out.append("0" if m == "conv1" else "3")
        elif m == "bn" and parent and parent.startswith("trunc_"):
            out.append("1")
        elif m in ("conv1", "conv2") and nxt in pair:
            n = m[-1]
            out.append(f"conv{n}" if nxt == "conv" else f"bn{n}")
            i += 2
            continue
        elif re.fullmatch(r"(cls|reg)_head_pre_conv", m) and nxt in pair:
            out += [m[: -len("_conv")], str(pair[nxt])]
            i += 2
            continue
        elif re.fullmatch(r"(cls|reg)_head_pre_(dcn|bn)", m):
            out += [m[: m.rindex("_")], "3" if m.endswith("_dcn") else "4"]
        elif m == "class_feat" and nxt in pair:
            out += ["class_head", str(pair[nxt])]
            i += 2
            continue
        elif m == "class_out":
            out += ["class_head", "3"]
        elif re.fullmatch(r"reg_feat_\d+", m) and nxt in pair:
            out += ["reg_features", m.split("_")[-1], str(pair[nxt])]
            i += 2
            continue
        elif m.startswith("reg_out_"):
            gi, key = re.fullmatch(r"reg_out_(\d+)_(.+)", m).groups()
            out += ["reg_heads", gi, str(key_index[(int(gi), key)])]
        elif m in ("project_conv", "project_bn"):
            out += ["project", "0" if m == "project_conv" else "1"]
        elif m == "actf_bn":
            out += ["actf", "0"]
        else:
            out.append(m)
        i += 1
    return out


def from_jax_variables(variables: Mapping, cfg: Config) -> Dict[str, np.ndarray]:
    """Flax ``{"params", "batch_stats"}`` of the JAX detector -> the port's
    state dict (numpy arrays, reference torch names). ``cfg`` names the
    regression keys of each head group.

    The deeper head's stems (``heads/{cls,reg}_head_pre_{conv,dcn,bn}``) map
    to ``heads.{cls,reg}_head_pre.{0,1,3,4}``. ``import_torch_dgde`` does not
    know these names, so a deeper head carries from JAX to the port only."""
    head = cfg.model.head
    key_index = {
        (gi, key): ki
        for gi, group in enumerate(head.regression_heads)
        for ki, key in enumerate(group)
    }
    leaves = _flatten(variables["params"])
    leaves.update(_flatten(variables.get("batch_stats", {})))
    sd = {}
    for path, value in leaves.items():
        mods, leaf = [m for m in path[:-1] if m != "BatchNorm_0"], path[-1]
        if "BatchNorm_0" in path:
            name = _BN_LEAVES[leaf]
        else:
            name = "weight" if leaf == "kernel" else leaf
        value = np.asarray(value, np.float32)
        if leaf == "kernel":
            value = np.transpose(value, (3, 2, 0, 1) if value.ndim == 4 else (2, 1, 0))
        if mods[-1] == "conv_offset_mask":
            inv = np.argsort(offset_conv_perm(value.shape[0] // 3))
            value = value[inv]
        sd[".".join(_torch_segments(mods, key_index) + [name])] = np.ascontiguousarray(value)
    return sd


def from_jax_gmw_params(params: Mapping) -> Dict[str, np.ndarray]:
    """Flax params of ``dcd_tpu.models.gmw.GMW`` (with or without the
    ``"params"`` level) -> the port's GMW state dict, whose names are the
    reference's: a Dense kernel (in, out) becomes a Conv1d weight
    (out, in, 1). The inverse of ``dcd_tpu.utils.checkpoint.import_torch_gmw``."""
    leaves = _flatten(params.get("params", params))
    sd = {}
    for path, value in leaves.items():
        *mods, leaf = path
        value = np.asarray(value, np.float32)
        if leaf == "kernel":
            value = np.transpose(value)[:, :, None]
        sd[".".join(mods + ["0", "weight" if leaf == "kernel" else leaf])] = np.ascontiguousarray(value)
    return sd


def load_state(model: torch.nn.Module, state: Mapping[str, np.ndarray]) -> None:
    """Load a numpy state dict whose keys are exactly the model's (BN's
    ``num_batches_tracked`` counters aside), after dropping the ``module.``
    prefix that a checkpoint saved from a ``DistributedDataParallel``
    model carries."""
    state = {k[len("module."):] if k.startswith("module.") else k: v for k, v in state.items()}
    want = {k for k in model.state_dict() if not k.endswith("num_batches_tracked")}
    missing, extra = want - set(state), set(state) - want
    if missing or extra:
        raise KeyError(f"state dict mismatch: missing {sorted(missing)[:5]}, "
                       f"unexpected {sorted(extra)[:5]}")
    model.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in state.items()},
                          strict=False)


@torch.no_grad()
def realistic_offsets(model: torch.nn.Module, gen: torch.Generator) -> None:
    """Perturb every zero-initialised offset conv so that it emits offsets
    with the statistics of trained checkpoints (the JAX package's
    ``bench._realistic_offsets``): a bias draw of std 0.45 px plus kernel
    noise of std 0.3 / sqrt(fan_in) on the offset channels. With zero offset
    convs every DCN is a plain conv and a run would test nothing."""
    for mod in model.modules():
        if isinstance(mod, DCN):
            conv = mod.conv_offset_mask
            n_off = 2 * conv.out_channels // 3
            fan_in = conv.weight[0].numel()
            conv.bias[:n_off] += 0.45 * torch.randn(n_off, generator=gen).to(conv.bias.device)
            noise = torch.randn((n_off, *conv.weight.shape[1:]), generator=gen)
            conv.weight[:n_off] += (0.3 / fan_in ** 0.5) * noise.to(conv.weight.device)


@torch.no_grad()
def calibrate_batch_norm(model: torch.nn.Module, *inputs) -> None:
    """Set every BN's running statistics to the batch statistics of one
    forward on ``inputs``, then return the model to eval mode.

    Random weights make activations grow layer by layer (through residual
    sums), so offset convs meant to emit sub-pixel offsets would emit tens of
    pixels. A trained model's BN statistics normalise every layer; one
    calibration pass gives random weights the same property."""
    bns = [m for m in model.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    momenta = [m.momentum for m in bns]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None  # cumulative average: after one batch, its statistics
    model.train()
    try:
        model(*inputs)
    finally:
        for m, mom in zip(bns, momenta):
            m.momentum = mom
        model.eval()
