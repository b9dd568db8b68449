"""The port's bf16 training and ``remat`` against the JAX package's.

* bf16 (``cfg.model.fp16``): the port's step (bf16 activations, fp32
  parameters, the DCNs through ``DeformConv2dFunction``'s plain versions on
  the CPU) against the JAX package's ``make_grad_fn`` with ``fp16=True`` on
  the same numpy weights and microbatch. The JAX side samples with the
  gather form, as tests/test_torch_train.py's does; the model is the small
  configuration of ``torch_port_common`` cut to output stride 16, so that
  JAX's bf16 gradient compiles in about a minute. Two bf16 steps that round
  in other places part by bf16's own rounding, grown through the network,
  so the limit is the precision's own, as tests/test_torch_bf16.py sets it
  for the forward: the port's gap to JAX's bf16 step may be at most
  GAP_FACTOR times JAX's bf16 step's gap to the fp32 step, for the
  gradients of each part of the network (trunk, up-sampling path, heads)
  as one vector each, the BN running statistics as one vector and the loss
  terms (the RMS of their relative differences). The weights are
  ``numpy_variables``' with every BN's gain and shift moved into the range
  where the step is well conditioned (``_linear_range_bn``), so that the
  fp32 gap is far below one and the limit binds. The fp32 step is the
  port's on the same weights, which stands for JAX's (at these weights the
  two parted by 1.8e-5 of the gradients' norm, measured), and spares the
  tier-1 budget a second JAX gradient compile. Parameters, gradients,
  Adam's state and BN statistics stay fp32; the heat map is fp32 and the
  regression map stays bf16 for the loss to gather from, as in JAX.
* ``remat``: the step with the forward recomputed in the backward equals the
  step without it, with BN's running statistics updated once per
  microbatch (``frozen_running_stats``), in fp32 and bf16.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from dcd_tpu.config import load_yaml_config as jax_load_yaml_config
from dcd_tpu.data import synthetic
from dcd_tpu.data.target_encoder import collate, encode_targets
from dcd_tpu.engine.train import build_model, make_grad_fn
from dcd_tpu_torch.config import load_yaml_config
from dcd_tpu_torch.engine.train import build_trainer, compute_gradients, train_step
from dcd_tpu_torch.models.layers import DCN
from dcd_tpu_torch.ops import dcn_cuda
from dcd_tpu_torch.utils.weights import from_jax_variables, load_state
from torch_port_common import numpy_variables, one_torch_thread, small_configs  # noqa: F401

# Train-mode BN at numpy_variables' draws (gains 0.5-1.5, shifts about 0)
# amplifies a perturbation layer by layer: noise on the input moves the
# trunk's last level 60 times as much (2 times in eval mode), and the bf16
# step's gradients part from the fp32 step's by 1.02 of their norm, in the
# port and in JAX alike, where no limit would bind. With every BN's gain cut
# to LINEAR_BN_GAIN of its draw and its shift at LINEAR_BN_SHIFT, most ReLUs
# work in their linear range and the gap falls to a few percent. Measured
# at these weights, port against JAX's bf16 step over JAX's bf16 against the
# fp32 step: gradients 0.0386 / 0.0351 as one vector, by part trunk 0.161 /
# 0.116, up-sampling path 0.074 / 0.070, heads 0.0078 / 0.0052; BN
# statistics 4.8e-4 / 4.8e-4; loss terms (RMS of the relative differences)
# 0.0021 / 0.0020. JAX's bf16 step at one XLA thread against eight: 4.8e-4
# of the gradients' norm, 0 in the heads. The limit is twice the own gap,
# and each own gap of the gradients must stay under OWN_GRAD_MAX, so that
# gradients that were all zero (a gap of 1) fail, and in the heads any
# wrong by more than about a percent of their norm.
GAP_FACTOR = 2.0
OWN_GRAD_MAX = 0.2
LINEAR_BN_GAIN, LINEAR_BN_SHIFT = 0.2, 1.0
REMAT_REL = 1e-6


def _configs(fp16=False, remat=False, accum=1, down_ratio=16):
    jcfg, tcfg = small_configs()

    def cut(cfg, dcn_impl):
        model = dataclasses.replace(
            cfg.model, fp16=fp16, remat=remat,
            backbone=dataclasses.replace(cfg.model.backbone, down_ratio=down_ratio, dcn_impl=dcn_impl))
        return dataclasses.replace(cfg, model=model, solver=dataclasses.replace(
            cfg.solver, grad_accum_steps=accum))

    return cut(jcfg, "gather"), cut(tcfg, "auto")


def _batch(cfg, n):
    samples = [encode_targets(*synthetic.make_scene(seed=s, num_objs=3, image_size=(120, 60),
                                                   depth_range=(6.0, 20.0)), cfg)
               for s in range(n)]
    return collate(samples)


def _linear_range_bn(tree):
    """Flax parameters with every BN's gain times LINEAR_BN_GAIN and its
    shift LINEAR_BN_SHIFT (a BN is a module with a ``scale`` and a
    ``bias``)."""
    if not hasattr(tree, "items"):
        return tree
    tree = {k: _linear_range_bn(v) for k, v in tree.items()}
    if "scale" in tree and "bias" in tree:
        tree["scale"] = np.asarray(tree["scale"]) * np.float32(LINEAR_BN_GAIN)
        tree["bias"] = np.full_like(np.asarray(tree["bias"]), LINEAR_BN_SHIFT)
    return tree


@pytest.fixture(scope="module")
def reference():
    """JAX's gradients, log terms and BN statistics of one bf16 microbatch,
    under the port's names, and the port's fp32 step from the same
    weights."""
    jcfg, tcfg = _configs()
    _, variables = numpy_variables(jcfg, seed=3)
    variables = {"params": _linear_range_bn(variables["params"]),
                 "batch_stats": variables["batch_stats"]}
    batch = {k: v[:1] for k, v in _batch(jcfg, 2).items()}
    assert batch["reg_mask"].sum() >= 2
    cfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, fp16=True))
    (total, (stats, logs)), grads = jax.jit(make_grad_fn(cfg, build_model(cfg)))(
        variables["params"], variables["batch_stats"], batch)
    ref = dict(variables=variables, batch=batch, jax_dtypes={str(np.asarray(g).dtype)
                                                             for g in jax.tree.leaves(grads)})
    ref["jax16"] = (
        {**{k: float(v) for k, v in logs.items()}, "total_loss": float(total)},
        from_jax_variables({"params": jax.tree.map(np.asarray, grads)}, tcfg),
        from_jax_variables({"params": {}, "batch_stats": jax.tree.map(np.asarray, stats)}, tcfg))
    ref["port32"] = _port_step(ref, fp16=False)[1]
    return ref


def _port_step(reference, fp16=True):
    """The port's step from the reference's weights; the JAX side samples
    with the unbounded gather form, which is the port's clamped form while
    no offset reaches the clamp, so the step checks that none does."""
    _, tcfg = _configs(fp16=fp16)
    trainer = build_trainer(tcfg, device="cpu")
    load_state(trainer.model, from_jax_variables(reference["variables"], tcfg))
    dtypes, offsets = [], []
    dcns = [m for m in trainer.model.modules() if isinstance(m, DCN)]
    hooks = [m.register_forward_pre_hook(lambda _m, a: dtypes.append(a[0].dtype)) for m in dcns]
    hooks += [m.conv_offset_mask.register_forward_hook(
        lambda _m, _i, o: offsets.append(float(o[:, :18].detach().abs().max()))) for m in dcns]
    logs = compute_gradients(trainer, reference["batch"])
    for h in hooks:
        h.remove()
    assert len(offsets) == len(dcns) > 0 and max(offsets) < tcfg.model.backbone.dcn_radius, offsets
    grads = {n: np.zeros(tuple(p.shape), np.float32) if p.grad is None else p.grad.numpy()
             for n, p in trainer.model.named_parameters()}
    sd = trainer.model.state_dict()
    stats = {k: sd[k].numpy() for k in reference["jax16"][2]}
    logs = {k: float(v) for k, v in logs.items() if k in reference["jax16"][0]}
    return trainer, (logs, grads, stats), dtypes


def _part(name):
    """The part of the network a parameter belongs to: the trunk
    (``backbone.base``), the up-sampling path, or the heads."""
    return "heads" if name.startswith("heads.") else ".".join(name.split(".")[:2])


def _gaps(a, b):
    """Relative differences of a against b: the RMS over the loss terms, and
    the relative Frobenius norms of all gradients, of the gradients of each
    part of the network and of all BN statistics, each taken as one
    vector."""
    (la, ga, sa), (lb, gb, sb) = a, b

    def fro(x, y, keys):
        vx = np.concatenate([np.asarray(x[k], np.float64).ravel() for k in keys])
        vy = np.concatenate([np.asarray(y[k], np.float64).ravel() for k in keys])
        return float(np.linalg.norm(vx - vy) / np.linalg.norm(vy))

    rel = [abs(la[k] - v) / max(abs(v), 1e-30) for k, v in lb.items()]
    gaps = {"loss": float(np.sqrt(np.mean(np.square(rel)))), "grad": fro(ga, gb, sorted(gb)),
            "stats": fro(sa, sb, sorted(sb))}
    for part in sorted({_part(k) for k in gb}):
        gaps[part] = fro(ga, gb, sorted(k for k in gb if _part(k) == part))
    return gaps


def test_bf16_step_gap_is_the_precisions_own(reference):
    """The port's bf16 step runs its DCNs on bf16 activations, gives fp32
    gradients as JAX's, and parts from JAX's bf16 step no further than
    GAP_FACTOR times JAX's bf16 step parts from the fp32 step, where that
    gap is small enough for the limit to bind."""
    _, got, dtypes = _port_step(reference)
    assert dtypes and set(dtypes) == {torch.bfloat16}
    assert {str(g.dtype) for g in got[1].values()} == reference["jax_dtypes"] == {"float32"}
    own = _gaps(reference["jax16"], reference["port32"])
    port = _gaps(got, reference["jax16"])
    assert set(own) == {"loss", "grad", "stats", "backbone.base", "backbone.dla_up", "heads"}, own
    assert 1e-2 < own["grad"] and max(own[k] for k in own if k != "loss") <= OWN_GRAD_MAX, own
    worse = {k: (port[k], own[k]) for k in own if not port[k] <= GAP_FACTOR * own[k]}
    assert not worse, (port, own)


def test_bf16_train_step_keeps_fp32_state(reference):
    """One bf16 update: parameters, Adam's moments and BN statistics stay
    fp32, every parameter moves by a finite amount, the heat map is fp32 and
    the regression map bf16 (as the JAX package's heads give them), the
    losses are fp32, nothing launches on the CPU, and a second run from the
    same weights is bitwise equal."""
    before = {k: dict(v) for k, v in (("pom", dcn_cuda.dcn_bwd_pom.launches_by_kernel),
                                       ("x", dcn_cuda.dcn_bwd_x.launches_by_kernel))}
    runs = []
    for _ in range(2):
        _, tcfg = _configs(fp16=True)
        trainer = build_trainer(tcfg, device="cpu")
        load_state(trainer.model, from_jax_variables(reference["variables"], tcfg))
        start = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
        seen = {}
        hook = trainer.model.heads.register_forward_hook(
            lambda _m, _i, out: seen.update({k: v.dtype for k, v in out.items()}))
        logs = train_step(trainer, reference["batch"])
        hook.remove()
        assert seen == {"cls": torch.float32, "reg": torch.bfloat16}
        assert {v.dtype for v in logs.values()} == {torch.float32}
        state = trainer.model.state_dict()
        assert {v.dtype for k, v in state.items() if not k.endswith("num_batches_tracked")} == {torch.float32}
        moments = [t for s in trainer.optimizer.adamw.state.values() for t in s.values()
                   if torch.is_tensor(t) and t.numel() > 1]
        assert moments and {t.dtype for t in moments} == {torch.float32}
        moved = [float((p.detach() - start[n]).abs().max()) for n, p in trainer.model.named_parameters()]
        assert all(np.isfinite(moved)) and sum(m > 0 for m in moved) > 0.9 * len(moved)
        runs.append(({k: float(v) for k, v in logs.items()}, state))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(v, runs[1][1][k]) for k, v in runs[0][1].items())
    assert dcn_cuda.dcn_bwd_pom.launches_by_kernel == before["pom"]
    assert dcn_cuda.dcn_bwd_x.launches_by_kernel == before["x"]


@pytest.mark.parametrize("fp16", [False, True], ids=["fp32", "bf16"])
def test_remat_gives_the_same_step(fp16):
    """Two microbatches (grad_accum_steps=2) with and without ``remat`` from
    the same seeded weights: losses, gradients, updated parameters and BN
    buffers within REMAT_REL of scale, and ``num_batches_tracked`` advanced
    by 2, once per microbatch, although the forward ran twice."""
    _, tcfg = _configs()
    batch = _batch(tcfg, 2)
    out = {}
    for remat in (False, True):
        _, cfg = _configs(fp16=fp16, remat=remat, accum=2)
        trainer = build_trainer(cfg, device="cpu", seed=0)
        forwards = []
        hook = trainer.model.register_forward_pre_hook(lambda *_: forwards.append(1))
        logs = compute_gradients(trainer, batch)
        hook.remove()
        grads = {n: p.grad.clone() for n, p in trainer.model.named_parameters() if p.grad is not None}
        trainer.optimizer.step()
        out[remat] = ({k: float(v) for k, v in logs.items()}, grads, trainer.model.state_dict(),
                      len(forwards))
    (l0, g0, s0, f0), (l1, g1, s1, f1) = out[False], out[True]
    assert (f0, f1) == (2, 4)  # remat recomputes each microbatch's forward
    for k, v in l0.items():
        assert abs(l1[k] - v) <= REMAT_REL * max(abs(v), 1e-30), k
    assert set(g0) == set(g1)
    for tree_a, tree_b in ((g0, g1), (s0, s1)):
        for k, v in tree_b.items():
            if k.endswith("num_batches_tracked"):
                assert int(v) == int(tree_a[k]) == 2, k
                continue
            scale = float(tree_a[k].abs().max())
            assert float((v - tree_a[k]).abs().max()) <= REMAT_REL * scale, k


def test_fp16_and_remat_read_from_yaml(tmp_path):
    """``MODEL: {FP16: true, REMAT: true}`` sets both knobs in both
    packages' loaders (the command lines' route to bf16 training)."""
    path = tmp_path / "exp.yaml"
    path.write_text("MODEL:\n  FP16: true\n  REMAT: true\n")
    port, jax_cfg = load_yaml_config(str(path)), jax_load_yaml_config(str(path))
    assert (port.model.fp16, port.model.remat) == (jax_cfg.model.fp16, jax_cfg.model.remat) == (True, True)
