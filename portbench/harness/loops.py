"""The two loops that drive the program, chosen by the traffic's ``loop``.

``infer``: a closed loop of one client. Each call is the program's
``infer`` on one batch of frames from a pool of distinct batches, cycled;
the call ends when its rows and validity are on the host. Set-up draws the
weights, calibrates BN with the reference, builds the program's detector,
loads the weights and runs every pool batch once.

``train``: a closed loop of the program's ``train_step`` on a pool of
encoded scene batches, cycled. Each batch is copied from pinned host memory
to the card without a wait, as a prefetching loader hands it, and each
step's total loss is read back ``ahead_steps`` steps later, as a training
loop that logs every step without stalling on it: the card keeps the steps
queued while the host stands still. Set-up builds the trainer, loads the
weights and drives it through its first three steps, on three distinct
batches, through the same feed and call: the steps that the reference
follows.

Both then measure for the window's seconds, and with ``trace`` profile a
few more steady steps. Once the window has closed and the peak memory has
been read, the program's state is freed and the reference judges what the
timed path produced.
"""

from __future__ import annotations

import gc
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..reference import config as ref_config
from ..reference.layers import DCN
from ..reference.post import postprocess as ref_postprocess
from ..reference.precision import fp8_e4m3, set_quantizer
from . import counts, inputs, judge, weights
from .program import program_config
from .spec import Cell
from .trace import Reading, module_spans, profile_steps, read_trace


# frames or scenes whose batch statistics set BN's running statistics
CALIBRATION_IMAGES = 4
# images a block of the reference's deformable convolutions holds at once
REFERENCE_BLOCK = 8
# inference: batches judged, drawn from the seed among the window's first
CHECK_BATCHES, CHECK_FROM_FIRST = 2, 16
# training: the first steps, driven in set-up, that the reference follows
CHECK_STEPS = 3


@dataclass
class Outcome:
    end_to_end: Dict[str, float]
    reading: Optional[Reading]
    numbers: Dict[str, float]
    attempted: int
    memory_peak_bytes: int
    info: Dict[str, object] = field(default_factory=dict)
    # not printed: the run's inputs, weights and judged outputs, for the
    # readings that set the limits (portbench/tools/readings.py)
    kept: Dict[str, object] = field(default_factory=dict)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _free(dev: torch.device) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _peak(dev: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0


def _reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _mark(phases: Dict, name: str, setup_done: Callable[[], float]) -> float:
    """Record set-up phase ``name``: seconds since the process started, and
    the process's CPU seconds (all threads) so far."""
    now = setup_done()
    phases[name] = [now, time.process_time()]
    return now


def _set_block(model, block: int) -> None:
    for m in model.modules():
        if isinstance(m, DCN):
            m.block = block


def _window(step: Callable[[int], None], seconds: float, least: int = 1) -> List[float]:
    """Call ``step(i)`` for i = 0, 1, ... until ``seconds`` have passed at
    the end of a call and ``least`` calls are done; the seconds of each."""
    times = []
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        step(len(times))
        t1 = time.perf_counter()
        times.append(t1 - t0)
        if t1 - start >= seconds and len(times) >= least:
            return times


def _window_ahead(step: Callable[[int], torch.Tensor], seconds: float, ahead: int,
                  least: int = 1) -> Tuple[int, float]:
    """Call ``step(i)`` for i = 0, 1, ..., each returning a number on the
    card that is read back ``ahead`` calls later, until ``seconds`` have
    passed after a call and ``least`` calls are done. Then nothing more is
    dispatched, every number still due is read, and the clock stops after
    the last: the calls made, and the seconds from the first call to then."""
    due: deque = deque()
    start = time.perf_counter()
    n = 0
    while True:
        due.append(step(n))
        n += 1
        while len(due) > ahead:
            float(due.popleft())
        if time.perf_counter() - start >= seconds and n >= least:
            break
    while due:
        float(due.popleft())
    return n, time.perf_counter() - start


def _window_shape(times: List[float]) -> Dict[str, object]:
    """The window's first and last call times and its median, in ms: a
    warm-up left inside the window shows as slow first calls."""
    ms = [1e3 * t for t in times]
    return {"first": ms[:8], "last": ms[-4:], "median": float(np.median(ms))}


def _make_state(cell: Cell, seed: int, dev, images, edge_indices, edge_len):
    """The run's weights: drawn from ``seed`` into the reference detector and
    its BN calibrated on the given frames in fp32."""
    tree = dict(cell.tree)
    tree["model"] = dict(tree["model"], fp16=False)
    ref = weights.reference_model(tree, dev)
    weights.draw(ref, seed)
    _set_block(ref, REFERENCE_BLOCK)
    with judge.reference_precision():
        weights.calibrate(ref, images, edge_indices, edge_len)
    state = weights.state_dict(ref)
    del ref
    return state


def _reference(cell: Cell, state, dev, quantize: bool = False, bf16: Optional[bool] = None):
    tree = cell.tree
    if bf16 is not None:
        tree["model"]["fp16"] = bf16
    ref = weights.reference_model(tree, dev)
    ref.load_state_dict(state)
    _set_block(ref, REFERENCE_BLOCK)
    if quantize:
        set_quantizer(ref, fp8_e4m3)
    return ref.eval()


def _dcn_launches() -> Dict[str, int]:
    from dcd_tpu_torch.ops import dcn_cuda

    out = dict(dcn_cuda.deform_conv2d.launches_by_kernel)
    for fn in (dcn_cuda.dcn_bwd_pom, dcn_cuda.dcn_bwd_x):
        out.update(fn.launches_by_kernel)
    return out


def _reset_dcn_launches() -> None:
    from dcd_tpu_torch.ops import dcn_cuda

    dcn_cuda.reset_launch_counts()


# ---------------------------------------------------------------- inference

def _sample(seed: int, first: int, n: int) -> List[int]:
    return sorted(np.random.default_rng(seed).choice(first, size=n, replace=False).tolist())


def infer_cell(cell: Cell, seed: int, seconds: float, trace: bool, dev: torch.device,
               setup_done: Callable[[], float]) -> Outcome:
    phases: Dict[str, List[float]] = {}
    _mark(phases, "start", setup_done)
    from dcd_tpu_torch.engine import infer as program

    traffic = cell.traffic
    rcfg = ref_config.load(cell.tree)
    _mark(phases, "imports", setup_done)
    pool = inputs.frame_batches(rcfg, traffic, seed, dev, pin=dev.type == "cuda")
    _mark(phases, "inputs", setup_done)
    cal = pool[0].narrow(0, CALIBRATION_IMAGES).to(dev)
    state = _make_state(cell, seed, dev, cal.images, cal.edge_indices, cal.edge_len)
    del cal
    _free(dev)
    _reset_peak(dev)
    _mark(phases, "weights", setup_done)

    model = program.build_detector(program_config(cell.tree), device=dev, seed=0)
    model.load_state_dict(state, strict=True)
    _mark(phases, "build", setup_done)
    heads_out: Dict[str, torch.Tensor] = {}
    hook = model.heads.register_forward_hook(lambda m, i, o: heads_out.update(o))

    def call(b):
        out = program.infer(model, b.images, b.edge_indices, b.edge_len, b.calib_P, b.pad_size,
                            b.img_size)
        return out["dets"].cpu(), out["valid"].cpu()

    for b in pool:
        call(b)
    _reset_dcn_launches()
    call(pool[0])
    launches = _dcn_launches()
    _sync(dev)
    setup_s = _mark(phases, "warm", setup_done)

    P, B = len(pool), traffic["batch"]
    keep = set(_sample(seed, CHECK_FROM_FIRST, CHECK_BATCHES))
    kept = []

    def step(i):
        dets, valid = call(pool[i % P])
        if i in keep:
            if "points_xy" in heads_out:
                points, clses = heads_out["points_xy"], heads_out["clses"]
            else:  # the dense path: its peaks are postprocess's top-K
                from ..reference.codec import nms_hm, select_topk
                _, _, clses, ys, xs = select_topk(nms_hm(heads_out["cls"]),
                                                  K=rcfg.test.detections_per_img)
                points = torch.stack([xs, ys], dim=-1)
            kept.append((i % P, dets.numpy(), valid.numpy(), points.cpu(), clses.cpu()))

    times = _window(step, seconds, CHECK_FROM_FIRST)
    window_s = sum(times)
    e2e = {"infer_images_per_s": B * len(times) / window_s,
           "infer_batch_ms_p95": 1e3 * float(np.percentile(times, 95)),
           "setup_s": setup_s}
    reading = None
    if trace:
        t0 = time.perf_counter()
        count = counts.count_forward(cell.tree, B, lazy=rcfg.test.lazy_reg_heads)
        with module_spans(model):
            raw = profile_steps(lambda i: call(pool[i % P]), traffic["trace_steps"], dev)
        reading = read_trace(raw, kind="infer", steps=traffic["trace_steps"], batch=B,
                             bf16=bool(cell.tree["model"]["fp16"]), count=count,
                             images_per_s=e2e["infer_images_per_s"],
                             launches=launches)
        phases["trace_s"] = [time.perf_counter() - t0]
    peak = _peak(dev)
    hook.remove()
    del model, heads_out, hook
    _free(dev)

    ref = _reference(cell, state, dev)
    blocks = judge_infer(ref, pool, kept, dev, REFERENCE_BLOCK)
    del ref
    _free(dev)
    numbers, shown = judge.infer_numbers(blocks, cell.limits["margins"])
    return Outcome(e2e, reading, numbers, len(times), peak,
                   {"launches": launches, "checked_batches": [k[0] for k in kept],
                    "batches": len(times), "phases_s": phases, "shown": shown,
                    "window_ms": _window_shape(times)},
                   {"pool": pool, "state": state, "blocks": blocks})


def judge_infer(ref, pool, kept, dev, block: int) -> List[Dict[str, np.ndarray]]:
    """The reference at the kept batches' peaks (pool index, rows, validity,
    points, classes), in blocks of ``block`` frames, beside the program's
    rows and validity of the same frames: the blocks that
    :func:`judge.infer_numbers` reads."""
    out = []
    with judge.reference_precision():
        for p, dets, valid, points, clses in kept:
            frames = pool[p]
            for s in range(0, frames.images.shape[0], block):
                n = min(block, frames.images.shape[0] - s)
                r = judge.reference_at_peaks(ref, frames.narrow(s, n).to(dev),
                                             points[s:s + n].to(dev), clses[s:s + n].to(dev))
                out.append({k: v.cpu().numpy() for k, v in r.items()})
                out[-1].update(got_rows=dets[s:s + n], got_valid=valid[s:s + n])
    return out


@torch.no_grad()
def control_infer(ref, frames, block: int):
    """The control in the program's place: the reference's own inference
    (lazy top-K path, postprocess) over ``frames``; rows, validity, points,
    classes."""
    rows, valid, points, clses = [], [], [], []
    for s in range(0, frames.images.shape[0], block):
        f = frames.narrow(s, min(block, frames.images.shape[0] - s))
        preds = ref(f.images, f.edge_indices, f.edge_len, lazy_topk=True)
        out = ref_postprocess(ref.cfg, preds, f.calib_P, f.pad_size, f.img_size)
        rows.append(out["dets"].cpu())
        valid.append(out["valid"].cpu())
        points.append(preds["points_xy"].cpu())
        clses.append(preds["clses"].cpu())
    return (torch.cat(rows).numpy(), torch.cat(valid).numpy(), torch.cat(points),
            torch.cat(clses))


# ----------------------------------------------------------------- training

def _grad_norms(optimizer, named) -> Dict[str, float]:
    """Each leaf's first gradient as AdamW got it: the first moment after
    one step over (1 - beta1)."""
    out = {}
    for name, p in named:
        st = optimizer.state.get(p, {})
        group = next(g for g in optimizer.param_groups if any(q is p for q in g["params"]))
        moment = st.get("exp_avg")  # none where the step never reached the optimizer
        out[name] = 0.0 if moment is None else float(moment.float().norm()) / (1.0 - group["betas"][0])
    return out


def _first_steps(model, optimizer_of, step, batches) -> Dict:
    """Drive three steps on three batches; the record the judge compares:
    each step's total loss, the first gradient by leaf, each leaf's change
    over the three steps."""
    named = list(model.named_parameters())
    start = {n: p.detach().clone() for n, p in named}
    losses, grads = [], {}
    for i, batch in enumerate(batches):
        losses.append(step(batch))
        if i == 0:
            grads = _grad_norms(optimizer_of(), named)
    changes = {n: float((p.detach() - start[n]).float().norm()) for n, p in named}
    return judge.train_record(losses, grads, changes)


def train_cell(cell: Cell, seed: int, seconds: float, trace: bool, dev: torch.device,
               setup_done: Callable[[], float]) -> Outcome:
    phases: Dict[str, List[float]] = {}
    _mark(phases, "start", setup_done)
    # build_trainer's switch for the process, set before the first cuBLAS
    # call (the reference's BN calibration below is one), as it documents
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from dcd_tpu_torch.engine import train as program

    traffic = cell.traffic
    rcfg = ref_config.load(cell.tree)
    _mark(phases, "imports", setup_done)
    pool = inputs.scene_batches(rcfg, traffic, seed, pin=dev.type == "cuda")
    _mark(phases, "inputs", setup_done)
    n = CALIBRATION_IMAGES
    cal = {k: pool[0][k][:n].to(dev) for k in ("images", "edge_indices", "edge_len")}
    state = _make_state(cell, seed, dev, cal["images"], cal["edge_indices"], cal["edge_len"])
    del cal
    _free(dev)
    _reset_peak(dev)
    _mark(phases, "weights", setup_done)

    trainer = program.build_trainer(program_config(cell.tree), device=dev, seed=0)
    trainer.model.load_state_dict(state, strict=True)
    _mark(phases, "build", setup_done)

    def call(batch) -> torch.Tensor:
        # the program's own copy of a host batch would wait for the step before
        on_card = {k: v.to(dev, non_blocking=True) for k, v in batch.items()}
        return program.train_step(trainer, on_card)["total_loss"]

    checked = CHECK_STEPS
    _reset_dcn_launches()
    record = _first_steps(trainer.model, lambda: trainer.optimizer.adamw,
                          lambda b: float(call(b)), pool[:checked])
    launches = {k: v // checked for k, v in _dcn_launches().items()}
    _sync(dev)
    setup_s = _mark(phases, "warm", setup_done)

    P, B = len(pool), traffic["batch"]
    steps, window_s = _window_ahead(lambda i: call(pool[(checked + i) % P]), seconds,
                                    traffic["ahead_steps"])
    e2e = {"train_images_per_s": B * steps / window_s, "setup_s": setup_s}
    reading = None
    if trace:
        t0 = time.perf_counter()
        count = counts.count_forward(cell.tree, B, lazy=False)
        raw = profile_steps(lambda i: float(call(pool[i % P])), traffic["trace_steps"], dev)
        reading = read_trace(raw, kind="train", steps=traffic["trace_steps"], batch=B,
                             bf16=bool(cell.tree["model"]["fp16"]), count=count,
                             images_per_s=e2e["train_images_per_s"], launches=launches)
        phases["trace_s"] = [time.perf_counter() - t0]
    peak = _peak(dev)
    del trainer
    _free(dev)

    want = reference_steps(cell, state, pool[:checked], dev)
    numbers = judge.train_numbers(record, want, worst=True)
    shown = {k: numbers.pop(k) for k in ("first_loss_gap", "loss_gap", "grad_gap",
                                         "median_grad_gap", "worst_change_gap")}
    return Outcome(e2e, reading, numbers, steps, peak,
                   {"launches": launches, "losses": record["losses"],
                    "reference_losses": want["losses"], "shown": shown,
                    "phases_s": phases, "window_ms": {"step": 1e3 * window_s / steps}},
                   {"pool": pool, "state": state, "record": record, "want": want})


def reference_steps(cell: Cell, state, batches, dev, bf16: Optional[bool] = None) -> Dict:
    """The reference's record of the same first steps from ``state``
    (``bf16``: with bf16 activations, the control of an fp32 cell)."""
    from ..reference.loss import compute_losses
    from ..reference.solver import Optimizer

    ref = _reference(cell, state, dev, bf16=bf16).train()
    opt = Optimizer(ref.cfg, ref, 1000)

    def step(batch) -> float:
        b = {k: v.to(dev) for k, v in batch.items()}
        b["edge_indices"] = b["edge_indices"].long()
        b["edge_len"] = b["edge_len"].long()
        ref.zero_grad(set_to_none=True)
        preds = ref(b["images"], b["edge_indices"], b["edge_len"])
        total, _, _ = compute_losses(ref.cfg, preds, b)
        total.backward()
        opt.step()
        return float(total.detach())

    with judge.reference_precision():
        record = _first_steps(ref, lambda: opt.adamw, step, batches)
    del ref, opt
    _free(dev)
    return record


LOOPS = {"infer": infer_cell, "train": train_cell}
