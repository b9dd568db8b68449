"""The port's train step and solver against the JAX package's.

One train step: the same numpy weights (carried with ``from_jax_variables``)
and the same encoded batch go through the port's ``compute_gradients``
(its DCNs through ``DeformConv2dFunction``, here on the CPU) and the JAX
package's ``make_grad_fn``. Every loss and log term must agree to 5e-4
relative, every BN running statistic to 1e-4 of its largest magnitude,
every parameter's gradient to 5e-3 (in the trunk and ``dla_up``, which a
switch of the step moves, to 2.5e-2 each and 1.2e-2 as one vector per
part), the terms built on edge-pair depths to 5e-3, and the gradients of the heads that feed
the pair solve to 5e-2 in relative Frobenius norm: fp32 arithmetic in
another order through a deep
network, amplified and switched as the constants below say. The
JAX side samples with the unbounded gather form, which equals the port's
clamped form while no offset reaches the clamp; the test checks that none
does. The model is the small configuration of ``torch_port_common`` cut to
output stride 8 (8 DCN blocks instead of 16): compiling the JAX gradient of
the gather form costs about 5 s per DCN block on a CPU.

``grad_accum_steps=2`` is held to the composition that
``tests/test_train_step.py::test_grad_accum_matches_microbatch_oracle``
proves equal to the JAX package's scan form: the gradient of microbatch 0
with the incoming BN statistics, that of microbatch 1 with the updated
ones, averaged, and the running statistics after both.

The solver: the optimizer's updates from the same numpy gradients against
the optax chain of ``build_optimizer`` (bias group, clipping, frozen
subtrees, ``adam_onecycle``) to 1e-6, and the schedules against
``make_lr_schedule`` and ``make_onecycle_schedules``.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dcd_tpu.config import dgde_run_config as jax_run_config
from dcd_tpu.data import synthetic
from dcd_tpu.data.target_encoder import collate, encode_targets
from dcd_tpu.engine import solver as jax_solver
from dcd_tpu.engine.infer import postprocess as jax_postprocess
from dcd_tpu.engine.train import make_grad_fn
from dcd_tpu_torch.config import dgde_run_config as torch_run_config
from dcd_tpu_torch.engine import solver as port_solver
from dcd_tpu_torch.engine.infer import infer
from dcd_tpu_torch.engine.train import (build_trainer, compute_gradients,
                                         deterministic_algorithms, train_step)
from dcd_tpu_torch.models.layers import DCN
from dcd_tpu_torch.ops import dcn_cuda
from dcd_tpu_torch.utils.weights import from_jax_variables, load_state
from torch_port_common import numpy_variables, one_torch_thread, small_configs  # noqa: F401

REL = 1e-4
RADIUS = 3


def _mode():
    return (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)


def test_build_trainer_sets_the_deterministic_mode():
    """The switches that make a train step repeatable on the card: the
    cuBLAS workspace for the process, and PyTorch's deterministic mode for
    the steps only, the caller's settings back after each."""
    _, tcfg = _configs()
    before = _mode()
    trainer = build_trainer(tcfg, device="cpu")
    assert trainer.deterministic and _mode() == before
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] in (":4096:8", ":16:8")
    with deterministic_algorithms():
        assert _mode() == (True, True, False)
    assert _mode() == before
    # bf16 training: bf16 activations, fp32 parameters (test_torch_train_bf16.py)
    bf16 = build_trainer(dataclasses.replace(tcfg, model=dataclasses.replace(tcfg.model, fp16=True)),
                         device="cpu")
    assert bf16.deterministic and bf16.model.dtype == torch.bfloat16
    assert {p.dtype for p in bf16.model.parameters()} == {torch.float32}
# The two packages' forward passes in train mode differ by 3e-5 of the
# DLASeg feature's scale (measured at these weights): convolutions and BN
# moments summed in another order through 30 layers. The gradients inherit
# that: up to 4.1e-4 of a tensor's scale (median 4e-5) against JAX, where a
# rounding-size perturbation of the port's own weights (1e-7 relative)
# moves them by up to 3.2e-4 (median 1e-4), so 1e-4 would sit below the
# step's conditioning. The edge-pair depths |dH| / |dy| amplify it through
# small row differences: the terms built on them differ from JAX by up to
# 1.1e-3. Their gradient is moreover discontinuous: the top-k of pairs by
# |dy|, the clamp of each depth to [2, 80] m and |dH| at 0 are switches that
# a rounding-size difference can flip. So the gradients of the heads that
# feed the pair solve (extra keypoints 2d and 3d) are compared as a whole,
# by the relative Frobenius norm of their difference (up to 2.3e-2 measured;
# the same perturbation of the port's own weights moves one element of them
# by 1.3e-2 of its tensor's scale). test_torch_losses.py holds the pair
# solve and its gradient to JAX on equal predictions, where none of this
# arises.
# The loss terms and the other gradients have switches too. Measured with
# tests/conditioning_probe.py --train on these weights and this microbatch
# (the port's own step, 3 draws): the step sits by a switch in the
# up-sampling path. One intra-op thread against eight flips it, and so does
# every weight times (1 + 1e-7 randn) at one thread in two draws of three.
# Flipped, it moves a loss term by up to 1.5e-4 relative, the BN running
# statistics by under 2.4e-5, and 28 weight gradients (44 with the biases)
# of the trunk and of dla_up by over 5e-3 of their scale, up to 1.22e-2 (the
# BN weight of dla_up.ida_1.proj_1) and 8.6e-3 in the trunk: as one vector
# 5.6e-3 (trunk) and 3.7e-3 (dla_up) in relative Frobenius norm; the
# gradients of ida_up and the heads by 6.1e-4 at most. Unflipped the port
# parts from JAX by 4.1e-4 at most in any gradient (torch's default pool of
# eight threads lands on JAX's side of the switch; one thread does not). So
# the loss terms are held to LOSS_REL, about three times the switch's reach;
# the gradients of ida_up and the heads each to GRAD_REL; those of the trunk
# and dla_up each to GRAD_SWITCH_REL and, as one vector per part, to
# GRAD_SWITCH_FRO, about twice the switch's reach; the BN statistics stay at
# REL.
LOSS_REL = 5e-4
GRAD_REL = 5e-3
GRAD_SWITCH_REL = 2.5e-2
GRAD_SWITCH_FRO = 1.2e-2
SWITCHED_PARTS = ("backbone.base.", "backbone.dla_up.")
PAIR_REL = 5e-3
PAIR_HEADS_FRO = 5e-2
PAIR_TERMS = {"pairs_kpts_depth_loss", "extra_all_MAE", "edges_MAE", "corner_loss"}


def _configs(accum=1):
    jcfg, tcfg = small_configs()

    def cut(cfg, dcn_impl):
        bb = dataclasses.replace(cfg.model.backbone, down_ratio=8, dcn_impl=dcn_impl)
        solver = dataclasses.replace(cfg.solver, grad_accum_steps=accum)
        return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, backbone=bb),
                                   solver=solver)

    return cut(jcfg, "gather"), cut(tcfg, "auto")


def _close(got, want, name, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale + 1e-12, f"{name}: max abs err {err} vs scale {scale}"


@pytest.fixture(scope="module")
def reference():
    return jax_reference()


def jax_reference():
    """The JAX package's gradients of microbatch 0 (one image) with the
    initial BN statistics and of microbatch 1 with the statistics after
    microbatch 0, from one compiled ``make_grad_fn``."""
    jcfg, _ = _configs()
    jmodel, variables = numpy_variables(jcfg, seed=3)
    samples = [encode_targets(*synthetic.make_scene(seed=s, num_objs=3, image_size=(120, 60),
                                                   depth_range=(6.0, 20.0)), jcfg)
               for s in range(2)]
    batch = collate(samples)
    assert batch["reg_mask"].sum() >= 4
    grad_fn = jax.jit(make_grad_fn(jcfg, jmodel))
    steps, stats = [], variables["batch_stats"]
    for i in range(2):
        mb = {k: v[i:i + 1] for k, v in batch.items()}
        (total, (stats, logs)), grads = grad_fn(variables["params"], stats, mb)
        steps.append(dict(total=float(total), logs=jax.tree.map(np.asarray, logs),
                          grads=jax.tree.map(np.asarray, grads),
                          stats=jax.tree.map(np.asarray, stats)))
    return dict(variables=variables, batch=batch, steps=steps, jmodel=jmodel, grad_fn=grad_fn)


def _port(reference, accum=1, batch=None):
    """A CPU trainer on the reference weights, its gradients on ``batch``
    (microbatch 0 by default) and the largest offset any DCN emitted."""
    _, tcfg = _configs(accum)
    trainer = build_trainer(tcfg, device="cpu")
    load_state(trainer.model, from_jax_variables(reference["variables"], tcfg))
    offsets = []
    hooks = [m.conv_offset_mask.register_forward_hook(
        lambda _m, _i, o: offsets.append(float(o[:, :18].detach().abs().max())))
        for m in trainer.model.modules() if isinstance(m, DCN)]
    if batch is None:
        batch = {k: v[:1] for k, v in reference["batch"].items()}
    logs = compute_gradients(trainer, batch)
    for h in hooks:
        h.remove()
    assert len(offsets) == 8 * accum and max(offsets) < RADIUS, offsets
    # the trunk's unused level4.project leaves get None where JAX has zeros
    grads = {n: np.zeros(tuple(p.shape), np.float32) if p.grad is None else p.grad.numpy()
             for n, p in trainer.model.named_parameters()}
    return trainer, {k: float(v) for k, v in logs.items()}, grads


def _jax_state(tree, tcfg):
    """A JAX ``params`` (or params-shaped) tree under the port's names."""
    return from_jax_variables({"params": tree}, tcfg)


def _pair_heads(cfg):
    """Name prefixes of the head groups that feed the edge-pair solve."""
    groups = [gi for gi, g in enumerate(cfg.model.head.regression_heads)
              if "extra_kpts_2d" in g or "extra_kpts_3d" in g]
    return tuple(f"heads.{kind}.{gi}." for gi in groups for kind in ("reg_features", "reg_heads"))


def _biases_before_bn(names):
    """The biases of layers followed by BN: every DCN's (inside DeformConv)
    and the first conv of each edge-fusion tower."""
    return {n for n in names if n.endswith(".bias") and (
        n[: -len("bias")] + "conv_offset_mask.weight" in names
        or (n.startswith("heads.trunc_") and n.endswith("_conv.0.bias")))}


def _check_step(trainer, logs, grads, want_logs, want_total, want_grads, want_stats):
    tcfg = trainer.cfg
    for k, v in want_logs.items():
        _close(logs[k], v, k, PAIR_REL if k in PAIR_TERMS else LOSS_REL)
    _close(logs["total_loss"], want_total, "total_loss", LOSS_REL)
    want = _jax_state(want_grads, tcfg)
    assert set(want) == set(grads)
    rel = {}  # each gradient's max abs error over its scale
    for name, g in grads.items():
        if name.startswith(_pair_heads(tcfg)):
            fro = np.linalg.norm(g - want[name]) / np.linalg.norm(want[name])
            assert fro <= PAIR_HEADS_FRO, f"grad {name}: relative Frobenius error {fro}"
            continue
        scale = float(np.abs(want[name]).max())
        if name in _biases_before_bn(want):
            # a train-mode BN removes this bias: its exact gradient is 0 and
            # both sides give rounding noise, held to the scale of the same
            # layer's weight gradient
            scale = max(scale, float(np.abs(want[name[: -len("bias")] + "weight"]).max()))
        err = float(np.abs(np.asarray(g, np.float64) - want[name]).max())
        rel[name] = max(err - 1e-12, 0.0) / max(scale, 1e-30)
    assert len(rel) > 100
    worse = {n: r for n, r in rel.items()
             if r > (GRAD_SWITCH_REL if n.startswith(SWITCHED_PARTS) else GRAD_REL)}
    assert not worse, sorted(worse.items(), key=lambda kv: -kv[1])[:5]
    for part in SWITCHED_PARTS:
        names = sorted(n for n in rel if n.startswith(part))
        a = np.concatenate([np.asarray(grads[n], np.float64).ravel() for n in names])
        b = np.concatenate([np.asarray(want[n], np.float64).ravel() for n in names])
        fro = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        assert names and fro <= GRAD_SWITCH_FRO, f"grads {part}*: relative Frobenius error {fro}"
    stats = from_jax_variables({"params": {}, "batch_stats": want_stats}, tcfg)
    sd = trainer.model.state_dict()
    assert len(stats) > 20
    for name, v in stats.items():
        _close(sd[name].numpy(), v, name)


def test_one_step_matches_make_grad_fn(reference):
    trainer, logs, grads = _port(reference)
    r = reference["steps"][0]
    _check_step(trainer, logs, grads, r["logs"], r["total"], r["grads"], r["stats"])
    flat = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads.values()))
    _close(logs["grad_norm"], flat, "grad_norm")


def test_grad_accum_matches_microbatch_composition(reference):
    trainer, logs, grads = _port(reference, accum=2, batch=reference["batch"])
    r0, r1 = reference["steps"]
    want_logs = {k: (r0["logs"][k] + r1["logs"][k]) / 2 for k in r0["logs"]}
    want_grads = jax.tree.map(lambda a, b: a / 2 + b / 2, r0["grads"], r1["grads"])
    _check_step(trainer, logs, grads, want_logs, (r0["total"] + r1["total"]) / 2, want_grads,
                r1["stats"])


def test_port_step_is_deterministic_and_updates(reference):
    """Two runs of the step from the same weights give bitwise equal
    gradients (a twin of tests/test_bf16_and_determinism.py's check), the
    step runs in the deterministic mode and leaves the caller's settings as
    they were, and the update moves every parameter by a finite amount at
    the JAX schedule's lr."""
    _, _, g1 = _port(reference)
    trainer, _, g2 = _port(reference)
    for name in g1:
        assert np.array_equal(g1[name], g2[name]), name
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    jcfg, _ = _configs()
    mode, seen = _mode(), []
    hook = trainer.model.register_forward_pre_hook(lambda *_: seen.append(_mode()))
    logs = train_step(trainer, {k: v[:1] for k, v in reference["batch"].items()})
    hook.remove()
    assert seen == [(True, True, False)] and _mode() == mode  # the step alone ran in the mode
    assert np.isclose(float(logs["lr"]), float(jax_solver.make_lr_schedule(jcfg, 1000)(0)),
                      rtol=1e-6)
    moved = [float((p.detach() - before[n]).abs().max())
             for n, p in trainer.model.named_parameters()]
    assert all(np.isfinite(moved)) and sum(m > 0 for m in moved) > 0.9 * len(moved)
    assert not any(dcn_cuda.deform_conv2d.launches_by_kernel.values())  # CPU tensors never launch


# A few steps of the convergence tools' solver (tools/convergence_run.py:65-73:
# warm-up of 100 steps to a base LR of 3e-4, two microbatches per step) from
# the JAX package's own initial weights (model.init, where the convergence
# run starts) on the test's batch: JAX's side is the fixture's compiled
# gradient composed as make_train_step composes it, with build_optimizer's
# update. Measured with tests/conditioning_probe.py --steps (one intra-op
# thread against eight, and every weight times (1 + 1e-7 randn) in four
# draws at each thread count), the port's own run moves each step's loss
# terms by up to 4.5e-3 relative, the other logged metrics by 8.0e-3, the
# pair-depth terms by 3.1e-3, the BN running statistics after the last step
# by 5.7e-4 of their largest magnitude and the eval-mode rows then by 7.3e-5
# of theirs. In two of the eight perturbed runs (one thread) a switch flips
# and moves them by up to 5.9e-2, 0.14, 0.17, 1.4e-2 and 2.8e-4: Adam's
# first steps move every weight by about the LR whatever its gradient's
# size, and the warm-up LR grows. The port against JAX reads 3.1e-3, 1.7e-3,
# 1.8e-2 (edges_MAE: the top-k of pairs), 6.6e-4 and 4.1e-5, on the
# unflipped side. Limits: about twice the unflipped reach, and for the pair
# terms the switched reach's third.
CONVERGENCE_STEPS = 4
STEPS_LOSS_REL, STEPS_METRIC_REL, STEPS_PAIR_REL = 1e-2, 1.6e-2, 5e-2
STEPS_STATS_REL, STEPS_ROWS_REL = 1.5e-3, 1.5e-4


def _convergence_configs():
    def solver(cfg):
        return dataclasses.replace(cfg, solver=dataclasses.replace(
            cfg.solver, lr_warmup=True, warmup_steps=100, base_lr=3e-4))

    return tuple(map(solver, _configs(accum=2)))


def _row_inputs(batch):
    return [batch[k] for k in ("images", "edge_indices", "edge_len", "calib_P_full", "pad_size",
                               "image_size")]


def flax_init_variables(seed=0):
    """The JAX package's own initial weights of the test's configuration
    (``model.init``, as the convergence tool starts from them); the
    parameters' shapes do not depend on the DCN form, and the offset-free
    one initialises in a fraction of the time."""
    from torch_port_common import edge_inputs, with_dcn

    from dcd_tpu.models.detector import KeypointDetector as JaxDetector

    jcfg, _ = _configs()
    model = JaxDetector(with_dcn(jcfg, "plain"))
    ei, el = edge_inputs(jcfg, 1, np.random.RandomState(0))
    img = jnp.zeros((1, jcfg.input.height_train, jcfg.input.width_train, 3), jnp.float32)
    return jax.jit(lambda r: model.init(r, img, ei, el, train=False))(jax.random.PRNGKey(seed))


def jax_convergence_steps(reference, variables):
    """JAX's logs of each step from ``variables``, its BN running statistics
    after the last and its eval-mode rows (lazy top-K path, as inference
    runs) then."""
    jcfg, _ = _convergence_configs()
    params, stats = variables["params"], variables["batch_stats"]
    tx = jax_solver.build_optimizer(jcfg, params, 1000)
    opt_state = tx.init(params)

    @jax.jit
    def update(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    batch, logs = reference["batch"], []
    for _ in range(CONVERGENCE_STEPS):
        micro = []
        for i in range(2):
            (total, (stats, lg)), g = reference["grad_fn"](
                params, stats, {k: v[i:i + 1] for k, v in batch.items()})
            micro.append((total, lg, g))
        grads = jax.tree.map(lambda a, b: a / 2 + b / 2, micro[0][2], micro[1][2])
        step_logs = {k: (float(micro[0][1][k]) + float(micro[1][1][k])) / 2 for k in micro[0][1]}
        step_logs["total_loss"] = (float(micro[0][0]) + float(micro[1][0])) / 2
        logs.append(step_logs)
        params, opt_state = update(grads, opt_state, params)
    jmodel = reference["jmodel"]
    rows = jax.jit(lambda v, im, ei, el, *post: jax_postprocess(
        jcfg, jmodel.apply(v, im, ei, el, train=False, lazy_topk=True), *post))(
        {"params": params, "batch_stats": stats}, *_row_inputs(batch))
    return logs, jax.tree.map(np.asarray, stats), jax.tree.map(np.asarray, rows)


def port_convergence_steps(reference, variables, perturb=None):
    """The port's logs of each ``train_step`` from ``variables``, its BN
    running statistics after the last and its eval-mode rows then;
    ``perturb`` (a RandomState) multiplies every weight by (1 + 1e-7 randn)
    first."""
    _, tcfg = _convergence_configs()
    trainer = build_trainer(tcfg, device="cpu")
    load_state(trainer.model, from_jax_variables(variables, tcfg))
    if perturb is not None:
        with torch.no_grad():
            for p in trainer.model.parameters():
                p.mul_(1 + 1e-7 * torch.from_numpy(perturb.randn(*p.shape)).float())
    logs = [{k: float(v) for k, v in train_step(trainer, reference["batch"]).items()}
            for _ in range(CONVERGENCE_STEPS)]
    stats = {n: b.numpy().copy() for n, b in trainer.model.named_buffers()
             if n.endswith(("running_mean", "running_var"))}
    trainer.model.eval()
    im, ei, el, *post = (torch.from_numpy(np.asarray(a)) for a in _row_inputs(reference["batch"]))
    rows = infer(trainer.model, im, ei.long(), el.long(), *post, cfg=tcfg)
    return logs, stats, {k: v.numpy() for k, v in rows.items()}


@pytest.fixture(scope="module")
def convergence_steps(reference):
    variables = flax_init_variables()
    return (jax_convergence_steps(reference, variables),
            port_convergence_steps(reference, variables))


def test_convergence_solver_steps_match_jax(convergence_steps):
    """Four steps of the convergence solver from JAX's initial weights: each
    step's loss terms and metrics, the BN running statistics after the last,
    and the eval-mode rows then (the same valid rows; every row's values)."""
    (jlogs, jstats, jrows), (logs, stats, rows) = convergence_steps
    _, tcfg = _convergence_configs()
    assert len(logs) == len(jlogs) == CONVERGENCE_STEPS
    assert logs[-1]["lr"] > logs[0]["lr"] > 0  # the warm-up
    for i, (got, want) in enumerate(zip(logs, jlogs)):
        for k, v in want.items():
            rel = (STEPS_PAIR_REL if k in PAIR_TERMS else
                   STEPS_LOSS_REL if k.endswith("_loss") else STEPS_METRIC_REL)
            _close(got[k], v, f"step {i} {k}", rel)
    want_stats = from_jax_variables({"params": {}, "batch_stats": jstats}, tcfg)
    assert len(want_stats) > 20 and set(want_stats) <= set(stats)
    for name, v in want_stats.items():
        _close(stats[name], v, name, STEPS_STATS_REL)
    np.testing.assert_array_equal(rows["valid"], jrows["valid"])
    _close(rows["dets"], jrows["dets"], "rows", STEPS_ROWS_REL)


def test_build_trainer_refuses_cpu_fallback(monkeypatch):
    _, tcfg = _configs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_trainer(tcfg)
    trainer = build_trainer(tcfg, device="cpu")
    assert trainer.model.training and trainer.device.type == "cpu"


# ---------------------------------------------------------------- solver


def _solver_cfgs(**solver):
    """(JAX config, port config) with the same solver and model overrides."""
    model = solver.pop("model", {})
    out = []
    for make in (jax_run_config, torch_run_config):
        cfg = make()
        out.append(dataclasses.replace(
            cfg, solver=dataclasses.replace(cfg.solver, **solver),
            model=dataclasses.replace(cfg.model, **model)))
    return out


class _Tiny(torch.nn.Module):
    def __init__(self, shapes):
        super().__init__()
        for top, leaves in shapes.items():
            sub = torch.nn.Module()
            for leaf, shape in leaves.items():
                sub.register_parameter(leaf, torch.nn.Parameter(torch.zeros(shape)))
            self.add_module(top, sub)


SHAPES = {"backbone": {"weight": (4, 3), "bias": (4,)}, "heads": {"weight": (2, 4), "bias": (2,)}}


@pytest.mark.parametrize("case", ["adamw", "adamw_clipped", "adamw_frozen", "adamw_frozen_clipped",
                                  "adam_onecycle"])
def test_optimizer_matches_optax_chain(case):
    """The port's Optimizer against optax's chain. ``adamw_frozen_clipped``
    is ``--finetune``'s optimizer: optax clips inside the live branch of
    ``multi_transform``, so the norm leaves the frozen gradients out (here
    ten times the live ones, which would change every step's clip factor)."""
    overrides = dict(base_lr=1e-2, lr_warmup=False)
    if case.endswith("clipped"):
        overrides["grad_norm_clip"] = 0.5
    if case.startswith("adamw_frozen"):
        overrides["model"] = dict(freeze_names=("backbone",))
    if case == "adam_onecycle":
        overrides.update(optimizer="adam_onecycle", max_iteration=10, base_lr=3e-2)
    jcfg, tcfg = _solver_cfgs(**overrides)
    rng = np.random.RandomState(5)
    params = {top: {leaf: rng.randn(*shape).astype(np.float32) for leaf, shape in leaves.items()}
              for top, leaves in SHAPES.items()}
    model = _Tiny(SHAPES)
    with torch.no_grad():
        for n, p in model.named_parameters():
            top, leaf = n.split(".")
            p.copy_(torch.from_numpy(params[top][leaf]))
    opt = port_solver.Optimizer(tcfg, model, iters_per_epoch=4)
    tx = jax_solver.build_optimizer(jcfg, params, iters_per_epoch=4)
    state = tx.init(params)
    jparams = jax.tree.map(jnp.asarray, params)
    clipped = []
    for step in range(3):
        grads = jax.tree.map(lambda a: (rng.randn(*a.shape) * (step + 1)).astype(np.float32), params)
        if case == "adamw_frozen_clipped":
            grads["backbone"] = jax.tree.map(lambda a: a * 10, grads["backbone"])
        live = {k: v for k, v in grads.items() if k not in tcfg.model.freeze_names}
        clipped.append(float(optax.global_norm(live)) > tcfg.solver.grad_norm_clip)
        updates, state = tx.update(jax.tree.map(jnp.asarray, grads), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for n, p in model.named_parameters():
            top, leaf = n.split(".")
            p.grad = torch.from_numpy(grads[top][leaf].copy())
        opt.step()
        for n, p in model.named_parameters():
            top, leaf = n.split(".")
            got, want = p.detach().numpy(), np.asarray(jparams[top][leaf])
            assert np.abs(got - want).max() <= 1e-6 * max(1.0, np.abs(want).max()), (case, step, n)
    if case.startswith("adamw_frozen"):
        assert np.array_equal(model.backbone.weight.detach().numpy(), params["backbone"]["weight"])
        assert np.array_equal(model.backbone.bias.detach().numpy(), params["backbone"]["bias"])
    if case.endswith("clipped"):
        assert all(clipped)


@pytest.mark.parametrize("case", ["warmup_multistep", "multistep", "onecycle"])
def test_schedules_match_jax(case):
    overrides = dict(warmup_steps=100, decay_epoch_steps=(80.0, 90.0), lr_clip=4e-6)
    if case == "multistep":
        overrides["lr_warmup"] = False
    if case == "onecycle":
        overrides.update(optimizer="adam_onecycle", max_iteration=250, base_lr=3e-3)
    jcfg, tcfg = _solver_cfgs(**overrides)
    # the JAX schedules compute in fp32 and the port's in float64: they agree
    # to 1e-6 of the curve's largest value (the cosine's end points cancel)
    steps = range(0, 250)
    got = [port_solver.make_lr_schedule(tcfg, 2)(t) for t in steps]
    want = [float(jax_solver.make_lr_schedule(jcfg, 2)(t)) for t in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * max(want))
    assert len(set(want)) >= 3
    if case == "onecycle":
        got = [port_solver.make_onecycle_schedules(tcfg)[1](t) for t in steps]
        want = [float(jax_solver.make_onecycle_schedules(jcfg)[1](t)) for t in steps]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * max(want))
