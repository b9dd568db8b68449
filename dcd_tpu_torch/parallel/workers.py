"""The data-parallel steps run in spawned processes, and their one-process
counterparts: what ``entry.dryrun_multichip``, ``chip_smoke.py`` and the
tests compare. Each ``*_worker(rank, world, ...)`` runs inside a process
group (:func:`dcd_tpu_torch.parallel.launch`) on its slice of a global batch
and returns numpy results; :func:`dgde_step` and :func:`gmw_step` run the
same work in one process without a group.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..utils.weights import load_state
from .mesh import shard_batch


def digest(arrays: Mapping[str, np.ndarray]) -> str:
    """A digest of named arrays (names, types, shapes and bytes): two ranks'
    weights compared bit for bit without moving them."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(arrays):
        a = np.ascontiguousarray(arrays[k])
        h.update(f"{k}:{a.dtype}:{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _numpy(d: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().float().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
            for k, v in d.items()}


def rank_device(device: str, rank: int) -> str:
    """The device of ``rank``: ``cuda`` without an index means card
    ``rank % device_count``; any other device as it is named."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return str(dev)


def _group() -> Optional[dist.ProcessGroup]:
    return dist.group.WORLD if dist.is_initialized() else None


def dgde_step(cfg, batch: Mapping, steps: int = 1, seed: int = 0, device: str = "cpu",
              rank: int = 0, world: int = 1, repeat: bool = False, timed: int = 0,
              weights: Optional[Mapping[str, np.ndarray]] = None, profiled: bool = False) -> Dict:
    """``steps`` DGDE train steps on ``batch`` (a collated global batch of
    numpy arrays; with a process group this rank's slice of it, cut by
    :func:`shard_batch` with the config's microbatches): each step's logs,
    the first step's gradients, and the parameters and buffers after the
    first and the last update (``first_state``, ``state``), as numpy; the DCN kernels' launches by entry point, counted
    over the steps. ``weights`` (a numpy state dict) replaces the seeded
    weights and buffers. With ``repeat`` the trainer then computes one
    step's gradients twice on the same weights and batch, and ``bitwise``
    says whether the two gave the same losses and gradients bit for bit. With ``timed`` N > 0 the trainer then
    takes N more steps, each timed on the host's clock after the device's
    work (``step_ms``); with ``profiled`` (on rank 0) one more step runs
    under the profiler (``profile``: its wall ms, the calls and host ms of
    the ``parallel.all_reduce_sum`` spans (BN moments, loss counts and
    logs; they block until every rank has sent), and the ms of one
    all-reduce of every gradient as one tensor, the volume DDP reduces in
    its buckets). ``seconds`` holds the host's seconds of each part (the
    trainer's build, the steps, the timed steps, the repeat)."""
    from ..engine.train import build_trainer, compute_gradients
    from ..ops import dcn_cuda

    group = _group()
    accum = max(int(cfg.solver.grad_accum_steps), 1)
    local = shard_batch(batch, rank, world, accum) if group is not None else dict(batch)
    local.pop("img_ids", None)

    def run():
        t0 = time.perf_counter()
        trainer = build_trainer(cfg, device=device, seed=seed, process_group=group)
        if weights is not None:
            load_state(trainer.model, weights)
        seconds["build"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        logs, grads, states = [], None, []
        for i in range(steps):
            step_logs = compute_gradients(trainer, local)
            step_logs["lr"] = torch.tensor(trainer.optimizer.lr())
            if i == 0:
                grads = {n: p.grad.detach().cpu().numpy().copy()
                         for n, p in trainer.model.named_parameters() if p.grad is not None}
            trainer.optimizer.step()
            logs.append({k: float(v) for k, v in step_logs.items()})
            if i in (0, steps - 1):
                states.append({k: v.detach().cpu().numpy().copy()
                               for k, v in trainer.model.state_dict().items()})
        launches.update({**dcn_cuda.deform_conv2d.launches_by_kernel,
                         **dcn_cuda.dcn_bwd_pom.launches_by_kernel,
                         **dcn_cuda.dcn_bwd_x.launches_by_kernel})
        seconds["steps"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if timed or profiled:
            out.update(_time_steps(trainer, local, timed, profiled, rank == 0))
            seconds["timed"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if repeat:
            twice = [(compute_gradients(trainer, local),
                      [p.grad.clone() for p in trainer.model.parameters() if p.grad is not None])
                     for _ in range(2)]
            (l1, g1), (l2, g2) = twice
            out["bitwise"] = all(torch.equal(l1[k], l2[k]) for k in l1) and all(
                torch.equal(a, b) for a, b in zip(g1, g2))
            seconds["repeat"] = time.perf_counter() - t0
        return logs, grads, states[0], states[-1]

    out: Dict = {}
    launches: Dict[str, int] = {}
    seconds: Dict[str, float] = {}
    dcn_cuda.reset_launch_counts()
    logs, grads, first, state = run()
    out.update(logs=logs, grads=grads, first_state=first, state=state, launches=dict(launches),
               seconds=seconds)
    return out


# Limits of an n-rank DGDE step against the one-process step on the global
# batch: those that tests/test_torch_train.py states and measures for the
# port's step against the JAX package's (the same fp32 arithmetic in another
# order, by a switch in the up-sampling path that a rounding flips): loss
# and log terms 5e-4 relative (the edge-pair terms 5e-3), gradients 5e-3 of
# each tensor's scale (a bias's: see gradient_errors), 2.5e-2 in the trunk
# and dla_up and 1.2e-2 there as one
# vector per part, the heads that feed the pair solve 5e-2 as one vector,
# BN running statistics 1e-4 of their scale. The gradients' global norm is a
# norm of the whole vector, most of it the switched parts': it is held to
# their 1.2e-2 (|d|g|| <= |dg|).
LOSS_REL, PAIR_REL = 5e-4, 5e-3
GRAD_REL, GRAD_SWITCH_REL, GRAD_SWITCH_FRO, PAIR_HEADS_FRO = 5e-3, 2.5e-2, 1.2e-2, 5e-2
STAT_REL = 1e-4
SWITCHED_PARTS = ("backbone.base.", "backbone.dla_up.")
PAIR_TERMS = {"pairs_kpts_depth_loss", "extra_all_MAE", "edges_MAE", "corner_loss"}
# Parameters after the first AdamW update: Adam moves each element by
# lr g / (|g| + 1e-8), about lr sign(g), so an element whose gradient is
# rounding noise (a bias before BN) may move the other way, 2 lr apart (lr
# times the bias group's factor); no element may be further apart, and at
# most 1 % of them may differ by more than 1e-6 of the tensor's scale and
# 1e-3 of the step.
PARAM_REL, PARAM_STEP_REL, PARAM_FLIPPED = 1e-6, 1e-3, 1e-2


def _pair_heads(cfg):
    """Name prefixes of the head groups that feed the edge-pair solve."""
    return tuple(f"heads.{kind}.{gi}." for gi, g in enumerate(cfg.model.head.regression_heads)
                 if "extra_kpts_2d" in g or "extra_kpts_3d" in g
                 for kind in ("reg_features", "reg_heads"))


def _rel_err(got, want, scale=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max()) if scale is None else scale
    return float(np.abs(got - want).max()) / max(scale, 1e-30)


def dgde_step_agreement(cfg, got: Dict, want: Dict) -> Dict[str, float]:
    """How far one rank's :func:`dgde_step` result lies from the one-process
    result ``want``, by category, each over its limit (<= 1 passes): the
    loss and log terms of the first step, the first step's gradients (each,
    the switched parts, the pair heads), the BN running statistics and the
    parameters after the first update."""
    pair_heads = _pair_heads(cfg)
    out = {}
    logs, wlogs = got["logs"][0], want["logs"][0]
    def log_limit(k):
        return GRAD_SWITCH_FRO if k == "grad_norm" else PAIR_REL if k in PAIR_TERMS else LOSS_REL

    out["logs"] = max(abs(logs[k] - v) / (log_limit(k) * max(abs(v), 1e-12))
                      for k, v in wlogs.items())
    grads, wgrads = got["grads"], want["grads"]
    if set(grads) != set(wgrads):
        raise AssertionError(f"gradients of {sorted(set(grads) ^ set(wgrads))} on one side only")
    fro_parts = {}
    for name, g in grads.items():
        part = "pair_heads" if name.startswith(pair_heads) else next(
            (p for p in SWITCHED_PARTS if name.startswith(p)), None)
        if part:
            fro_parts.setdefault(part, []).append((g, wgrads[name]))
    out["grads"] = max(r for r, _ in gradient_errors(cfg, got, want))
    for part, pairs in fro_parts.items():
        a = np.concatenate([np.asarray(g, np.float64).ravel() for g, _ in pairs])
        b = np.concatenate([np.asarray(w, np.float64).ravel() for _, w in pairs])
        limit = PAIR_HEADS_FRO if part == "pair_heads" else GRAD_SWITCH_FRO
        out[f"grads_fro {part}"] = float(np.linalg.norm(a - b) / np.linalg.norm(b)) / limit
    first, wfirst = got["first_state"], want["first_state"]
    stats = [k for k in wfirst if k.endswith(("running_mean", "running_var"))]
    out["bn_stats"] = max(_rel_err(first[k], wfirst[k]) for k in stats) / STAT_REL
    lr = want["logs"][0]["lr"] * max(1.0, cfg.solver.bias_lr_factor)
    flipped, total, worst = 0, 0, 0.0
    for k in wfirst:
        if k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            continue
        a, b = np.asarray(first[k], np.float64), np.asarray(wfirst[k], np.float64)
        diff = np.abs(a - b)
        flipped += int((diff > max(PARAM_REL * np.abs(b).max(), PARAM_STEP_REL * lr)).sum())
        total += diff.size
        worst = max(worst, float(diff.max()) / (2.0 * lr * (1.0 + cfg.solver.weight_decay) + 1e-12))
    out["params_flipped"] = flipped / total / PARAM_FLIPPED
    out["params_max"] = worst  # an element moved beyond a flipped Adam step
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_steps(trainer, batch: Mapping, n: int, profiled: bool, record: bool) -> Dict:
    """``n`` timed train steps, and one profiled one (:func:`dgde_step`).
    Every rank takes the same steps and collectives; only where ``record``
    the profiler runs and the numbers are kept."""
    from torch.profiler import ProfilerActivity, profile

    from ..engine.train import train_step

    def timed_step():
        _sync(trainer.device)
        t0 = time.perf_counter()
        train_step(trainer, batch)
        _sync(trainer.device)
        return 1e3 * (time.perf_counter() - t0)

    out = dict(step_ms=[timed_step() for _ in range(n)])
    if not profiled:
        return out
    # the host's spans only: the device's activity would start CUPTI, which
    # costs seconds in a fresh process
    with profile(activities=[ProfilerActivity.CPU]) if record else contextlib.nullcontext() as prof:
        wall = timed_step()
    group = trainer.process_group
    flat = None
    if group is not None:  # the gradients' volume, all-reduced at once on every rank
        flat = torch.cat([p.grad.reshape(-1) for p in trainer.model.parameters()
                          if p.grad is not None])
        _sync(trainer.device)
        t0 = time.perf_counter()
        dist.all_reduce(flat, group=group)
        _sync(trainer.device)
        grad_ms = 1e3 * (time.perf_counter() - t0)
    if not record:
        return out
    prof_out = dict(wall_ms=wall, all_reduce_sum_calls=0, all_reduce_sum_ms=0.0)
    # the profiler's raw events: building its event tree (``events()``,
    # ``key_averages()``) for the ~5e4 ops of a step takes seconds
    for e in prof.profiler.kineto_results.events():
        if e.name() == "parallel.all_reduce_sum":
            prof_out["all_reduce_sum_calls"] += 1
            prof_out["all_reduce_sum_ms"] += e.duration_ns() / 1e6
    if flat is not None:
        prof_out["grad_all_reduce_ms"] = grad_ms
        prof_out["grad_all_reduce_mb"] = flat.numel() * flat.element_size() / 1e6
    out["profile"] = prof_out
    return out


def gradient_errors(cfg, got: Dict, want: Dict):
    """(error over its limit, name) of each first-step gradient of ``got``
    against ``want`` that is held tensor by tensor (all but the heads that
    feed the pair solve), worst last: the max abs error of the tensor's
    scale; a bias's of the larger of its own scale and its layer's weight
    gradient's (a bias that a following BN removes has a gradient of
    rounding noise: every DCN's, and with BNs in their linear range the
    trunk BNs' too)."""
    pair_heads = _pair_heads(cfg)
    out = []
    for name, g in got["grads"].items():
        if name.startswith(pair_heads):
            continue
        w = want["grads"][name]
        scale = float(np.abs(w).max())
        sibling = name[: -len("bias")] + "weight"
        if name.endswith(".bias") and sibling in want["grads"]:
            scale = max(scale, float(np.abs(want["grads"][sibling]).max()))
        limit = GRAD_SWITCH_REL if name.startswith(SWITCHED_PARTS) else GRAD_REL
        out.append((_rel_err(g, w, scale) / limit, name))
    return sorted(out)


def dgde_step_worker(rank: int, world: int, cfg, batch: Mapping, steps: int = 1, seed: int = 0,
                     device: str = "cpu", repeat: bool = False, timed: int = 0,
                     weights: Optional[Mapping[str, np.ndarray]] = None,
                     profiled: bool = False) -> Dict:
    """:func:`dgde_step` on this rank's slice, in the process group, on
    :func:`rank_device`."""
    return dgde_step(cfg, batch, steps, seed, rank_device(device, rank), rank, world, repeat,
                     timed, weights, profiled)


def gmw_step(gcfg, batch: Mapping, steps: int = 1, seed: int = 0, device: str = "cpu",
             rank: int = 0, world: int = 1, loss_weights: Sequence[float] = (1.0, 1.0)) -> Dict:
    """``steps`` GMW train steps with the (cls, reg) ``loss_weights`` on
    ``batch`` (numpy kpts_2d, kpts_3d, pred_rot, gt_depth; with a process
    group this rank's slice of it): each step's logs, the first step's
    gradients and the parameters after the last update, as numpy."""
    from ..engine.gmw_train import create_gmw_state, make_gmw_train_step

    group = _group()
    local = shard_batch(batch, rank, world) if group is not None else dict(batch)
    model, state = create_gmw_state(gcfg, seed, steps_per_epoch=10, device=device,
                                    process_group=group)
    step = make_gmw_train_step(gcfg, model)
    logs, grads = [], None
    for i in range(steps):
        logs.append({k: float(v) for k, v in step(state, local, *loss_weights).items()})
        if i == 0:
            grads = {n: p.grad.detach().cpu().numpy().copy() for n, p in model.named_parameters()}
    params = {k: v.detach().cpu().numpy().copy() for k, v in model.state_dict().items()}
    return dict(logs=logs, grads=grads, state=params)


def gmw_step_worker(rank: int, world: int, gcfg, batch: Mapping, steps: int = 1, seed: int = 0,
                    device: str = "cpu", loss_weights: Sequence[float] = (1.0, 1.0)) -> Dict:
    """:func:`gmw_step` on this rank's slice, in the process group, on
    :func:`rank_device`."""
    return gmw_step(gcfg, batch, steps, seed, rank_device(device, rank), rank, world,
                    loss_weights)


def batch_norm_worker(rank: int, world: int, x: np.ndarray, cotangent: np.ndarray,
                      weight: np.ndarray, bias: np.ndarray, steps: int = 1,
                      dtype: str = "float32") -> Dict:
    """The port's BN in training over the process group, on this rank's
    slice of the global NCHW batch ``x`` cast to ``dtype`` (the activations'
    type; the gain, shift and statistics stay fp32): the output, the
    gradients of sum(out * cotangent) with respect to the input slice, the
    gain and the shift (the gain's and shift's summed over the group, as a
    data-parallel step's are), and the running statistics after ``steps``
    forwards; arrays in fp32."""
    from ..models.layers import batch_norm, use_process_group

    group = _group()
    kind = getattr(torch, dtype)
    xs = torch.from_numpy(shard_batch({"x": x}, rank, world)["x"]).to(kind).requires_grad_(True)
    ct = torch.from_numpy(shard_batch({"c": cotangent}, rank, world)["c"]).to(kind)
    bn = batch_norm(x.shape[1]).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    use_process_group(bn, group)
    out = None
    for _ in range(steps):
        out = bn(xs)
    (out * ct).sum().backward()
    gw, gb = bn.weight.grad.clone(), bn.bias.grad.clone()
    if group is not None:
        dist.all_reduce(gw, group=group)
        dist.all_reduce(gb, group=group)
    return dict(out=out.detach().float().numpy(), grad_x=xs.grad.float().numpy(),
                dtype=str(out.dtype), grad_weight=gw.numpy(),
                grad_bias=gb.numpy(), running_mean=bn.running_mean.numpy().copy(),
                running_var=bn.running_var.numpy().copy())


def loss_worker(rank: int, world: int, cfg, predictions: Mapping[str, np.ndarray],
                targets: Mapping[str, np.ndarray]) -> Dict:
    """The DGDE loss of this rank's slice of a global batch over the
    process group: the rank's shares of every loss and log term (their sum
    over the ranks is the global term) and of the total, and the gradient
    of the total share with respect to the rank's predictions."""
    from ..engine.loss import compute_losses

    group = _group()
    preds = {k: torch.from_numpy(v) for k, v in shard_batch(predictions, rank, world).items()}
    tgts = shard_batch({k: v for k, v in targets.items() if k != "img_ids"}, rank, world)
    tgts = {k: torch.as_tensor(v) for k, v in tgts.items()}
    for v in preds.values():
        v.requires_grad_(True)
    total, _, logs = compute_losses(cfg, preds, tgts, group)
    total.backward()
    return dict(terms=_numpy({**logs, "total_loss": total}),
                grads={k: v.grad.numpy() for k, v in preds.items()})


def suite_worker(rank: int, world: int, jobs) -> list:
    """Each ``(name, args)`` of ``jobs`` in turn, ``name`` a ``*_worker`` of
    this module, in one process group: one spawn serves several checks."""
    return [globals()[name](rank, world, *args) for name, args in jobs]


def small_dgde_config(cfg, height: int = 64, width: int = 96, max_objects: int = 4,
                      channels=(4, 8, 8, 8, 8, 8), head_channels: int = 16, pairs_topk: int = 64,
                      **solver):
    """``cfg`` cut to a tiny size, as ``__graft_entry__._small_cfg`` cuts the
    JAX package's for its multichip dry run; ``solver`` overrides solver
    fields (``grad_accum_steps``, ``ims_per_batch``)."""
    return dataclasses.replace(
        cfg,
        input=dataclasses.replace(cfg.input, height_train=height, width_train=width),
        datasets=dataclasses.replace(cfg.datasets, max_objects=max_objects),
        model=dataclasses.replace(
            cfg.model, pretrain=False,
            head=dataclasses.replace(cfg.model.head, num_channel=head_channels,
                                     pairs_topk=pairs_topk),
            backbone=dataclasses.replace(cfg.model.backbone, channels=tuple(channels)),
        ),
        solver=dataclasses.replace(cfg.solver, **solver),
    )
