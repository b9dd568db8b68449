"""The port's data parallelism over two gloo processes on the CPU against one
process, and its cross-process BN against flax's ``axis_name`` BN.

One spawn of two workers (``dcd_tpu_torch.parallel.launch`` with
``parallel.workers.suite_worker``) serves every case of the file:

* BN over the process group against the JAX package's ``BatchNorm(axis_name=
  "data")`` under ``jax.vmap(..., axis_name="data")`` over the same two
  shards: outputs, input and parameter gradients, running statistics, to
  1e-5 of their scale; and in bf16 (flax's BN with ``dtype=bfloat16``), the
  bf16 output and input gradient to one bf16 rounding;
* the DGDE loss over two ranks with the objects spread unevenly (5 and 6
  objects on rank 0, 1 and 0 on rank 1): the ranks' shares of every term
  and log, summed, and their gradients with respect to the predictions,
  against the port's one-process loss on the global batch (which
  tests/test_torch_losses.py holds to JAX), to 1e-5;
* the DGDE train step over two ranks, with and without two microbatches,
  against one process on the global batch, within
  ``parallel.workers.dgde_step_agreement``'s limits (those of
  tests/test_torch_train.py), and both ranks' weights bitwise equal; with
  ``remat`` (the forward recomputed inside DDP's backward) bitwise the step
  without;
* the GMW train step over two ranks against one process, to 1e-5 of scale
  (a bias's gradient of its weight's gradient's scale: ``gcn_norm``
  removes it).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcd_tpu.models.layers import BatchNorm as JaxBatchNorm
from dcd_tpu_torch.config import dgde_run_config
from dcd_tpu_torch.data import synthetic
from dcd_tpu_torch.data.target_encoder import collate, encode_targets
from dcd_tpu_torch.engine.gmw_train import GMWConfig
from dcd_tpu_torch.engine.loss import compute_losses
from dcd_tpu_torch.engine.train import batch_to_device
from dcd_tpu_torch.parallel import launch, shard_batch
from dcd_tpu_torch.parallel.workers import (dgde_step, dgde_step_agreement, gmw_step,
                                            small_dgde_config, suite_worker)
from torch_port_common import one_torch_thread  # noqa: F401  (autouse)

WORLD = 2
REL = 1e-5
# objects per scene of the loss's global batch: rank 0 holds 11, rank 1 one
LOSS_OBJECTS = (5, 6, 1, 0)


def _close(got, want, name, rel=REL, scale=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = float(np.abs(want).max()) if scale is None else scale
    err = float(np.abs(got - want).max())
    assert err <= rel * scale + 1e-12, f"{name}: max abs err {err} vs scale {scale}"


def _bn_inputs(dtype="float32"):
    """NCHW x with its mean far from 0, a cotangent, gain and shift; with
    ``dtype`` bfloat16, x and the cotangent rounded to bf16 values."""
    rng = np.random.RandomState(0)
    x = (rng.randn(4, 6, 5, 7) * 2.0 + 3.0).astype(np.float32)
    cot = rng.randn(*x.shape).astype(np.float32)
    if dtype == "bfloat16":
        x, cot = (torch.from_numpy(a).bfloat16().float().numpy() for a in (x, cot))
    return x, cot, rng.uniform(0.5, 1.5, 6).astype(np.float32), rng.randn(6).astype(np.float32)


def _bn_remat_cfg():
    cfg, _ = _step_inputs(1)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, remat=True))


def _loss_inputs():
    cfg = dgde_run_config()
    cfg = dataclasses.replace(cfg, input=dataclasses.replace(cfg.input, height_train=128,
                                                             width_train=384))
    samples = [encode_targets(*synthetic.make_scene(seed=s, num_objs=n, image_size=(380, 124),
                                                    depth_range=(6.0, 30.0)), cfg)
               for s, n in enumerate(LOSS_OBJECTS)]
    batch = {k: v for k, v in collate(samples).items() if k != "img_ids"}
    rng = np.random.RandomState(1)
    B, C, Ho, Wo = batch["hm"].shape
    R = sum(sum(g) for g in cfg.model.head.regression_channels)
    logits = rng.randn(B, Ho, Wo, C).astype(np.float32) * 2.0
    preds = {"cls": np.clip(1.0 / (1.0 + np.exp(-logits)), 1e-4, 1 - 1e-4).astype(np.float32),
             "reg": (rng.randn(B, Ho, Wo, R) * 0.5).astype(np.float32)}
    return cfg, preds, batch


def _step_inputs(accum):
    """A global batch of 4 scenes per microbatch: 2 per rank. With one scene
    per rank and microbatch the tiny step sits by a switch (one process on
    1 against 8 intra-op threads: ida_up gradients 5.65e-3 apart, over
    GRAD_REL); with two, 0.2 of the limits."""
    B = 4 * accum
    cfg = small_dgde_config(dgde_run_config(), ims_per_batch=B, grad_accum_steps=accum)
    samples = [encode_targets(*synthetic.make_scene(seed=s, num_objs=3, image_size=(90, 60)), cfg)
               for s in range(B)]
    return cfg, {k: v for k, v in collate(samples).items() if k != "img_ids"}


def _gmw_inputs():
    n_kpts = 10
    gcfg = GMWConfig(num_kpts=n_kpts, features=16, depth=2, topk=16, batch_size=4)
    rng = np.random.RandomState(2)
    batch = {"kpts_2d": rng.randn(4, n_kpts, 2).astype(np.float32) * 0.1,
             "kpts_3d": rng.randn(4, n_kpts, 3).astype(np.float32),
             "pred_rot": rng.randn(4).astype(np.float32),
             "gt_depth": (10.0 + rng.rand(4) * 20).astype(np.float32)}
    return gcfg, batch


@pytest.fixture(scope="module")
def ranks():
    """Every job of the file, run by two gloo ranks in one spawn."""
    loss_cfg, preds, targets = _loss_inputs()
    jobs = [("batch_norm_worker", _bn_inputs()),
            ("loss_worker", (loss_cfg, preds, targets)),
            ("dgde_step_worker", (*_step_inputs(1), 2)),
            ("dgde_step_worker", (*_step_inputs(2), 1)),
            ("gmw_step_worker", (*_gmw_inputs(), 2, 1)),
            ("batch_norm_worker", (*_bn_inputs("bfloat16"), 1, "bfloat16")),
            ("dgde_step_worker", (_bn_remat_cfg(), _step_inputs(1)[1], 2))]
    out = launch(suite_worker, WORLD, (jobs,))
    return dict(zip(("bn", "loss", "step", "step_accum", "gmw", "bn_bf16", "step_remat"),
                    zip(*out)))


def _flax_bn_over_shards(x, cot, weight, bias, dtype=jnp.float32):
    """flax's ``BatchNorm(axis_name="data")`` of the JAX package in training,
    under ``jax.vmap`` over WORLD shards of ``x`` in ``dtype``: the output
    and the input's gradient (NCHW, fp32), the parameters' gradients per
    shard and the running statistics per shard."""
    module = JaxBatchNorm(axis_name="data", dtype=dtype)
    shards = jnp.asarray(x.reshape(WORLD, 2, *x.shape[1:]).transpose(0, 1, 3, 4, 2), dtype)  # NHWC
    cots = jnp.asarray(cot.reshape(WORLD, 2, *x.shape[1:]).transpose(0, 1, 3, 4, 2), dtype)
    variables = module.init(jax.random.PRNGKey(0), shards[0], train=False)
    params = {"BatchNorm_0": {"scale": jnp.asarray(weight), "bias": jnp.asarray(bias)}}

    def objective(params, xs, ct):
        out, mutated = module.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                    xs, train=True, mutable=["batch_stats"])
        return (out * ct).sum(), (out, mutated["batch_stats"])

    grad = jax.vmap(jax.grad(objective, argnums=(0, 1), has_aux=True), in_axes=(None, 0, 0),
                    axis_name="data")
    (gp, gx), (out, stats) = grad(params, shards, cots)
    to_nchw = lambda a: np.asarray(a, np.float32).transpose(0, 1, 4, 2, 3).reshape(x.shape)  # noqa: E731
    return to_nchw(out), to_nchw(gx), gp, stats


def test_cross_process_bn_matches_flax_axis_name(ranks):
    x, cot, weight, bias = _bn_inputs()
    C = x.shape[1]
    out, gx, gp, stats = _flax_bn_over_shards(x, cot, weight, bias)
    for r, got in enumerate(ranks["bn"]):
        rows = slice(2 * r, 2 * r + 2)
        _close(got["out"], out[rows], "out", scale=float(np.abs(out).max()))
        _close(got["grad_x"], gx[rows], "grad_x", scale=float(np.abs(gx).max()))
        _close(got["grad_weight"], np.asarray(gp["BatchNorm_0"]["scale"]).sum(0), "grad_weight")
        _close(got["grad_bias"], np.asarray(gp["BatchNorm_0"]["bias"]).sum(0), "grad_bias")
        _close(got["running_mean"], np.asarray(stats["BatchNorm_0"]["mean"])[r], "running_mean")
        _close(got["running_var"], np.asarray(stats["BatchNorm_0"]["var"])[r], "running_var")
    assert C == got["grad_weight"].shape[0]
    # the global moments: far from either shard's own
    shard_var = x[:2].transpose(1, 0, 2, 3).reshape(C, -1).var(1)
    assert np.abs(ranks["bn"][0]["running_var"] - (0.9 + 0.1 * shard_var)).max() > 1e-2


# bf16 activations: both sides take the moments and normalise in fp32 and
# round the output (and the input's gradient) to bf16 once; an fp32 value
# by a rounding boundary may go either way, so those agree to one bf16 unit
# in the last place at the largest value (2^-7 of the scale); the fp32
# parameter gradients and statistics to REL.
BF16_REL = 2.0 ** -7


def test_cross_process_bn_in_bf16_matches_flax_axis_name(ranks):
    x, cot, weight, bias = _bn_inputs("bfloat16")
    out, gx, gp, stats = _flax_bn_over_shards(x, cot, weight, bias, jnp.bfloat16)
    for r, got in enumerate(ranks["bn_bf16"]):
        assert got["dtype"] == "torch.bfloat16"
        rows = slice(2 * r, 2 * r + 2)
        _close(got["out"], out[rows], "out", rel=BF16_REL, scale=float(np.abs(out).max()))
        _close(got["grad_x"], gx[rows], "grad_x", rel=BF16_REL, scale=float(np.abs(gx).max()))
        _close(got["grad_weight"], np.asarray(gp["BatchNorm_0"]["scale"]).sum(0), "grad_weight")
        _close(got["grad_bias"], np.asarray(gp["BatchNorm_0"]["bias"]).sum(0), "grad_bias")
        _close(got["running_mean"], np.asarray(stats["BatchNorm_0"]["mean"])[r], "running_mean")
        _close(got["running_var"], np.asarray(stats["BatchNorm_0"]["var"])[r], "running_var")


def test_loss_shares_sum_to_the_one_process_loss(ranks):
    cfg, preds, targets = _loss_inputs()
    assert [int(m.sum()) for m in shard_batch(targets, 0, WORLD)["reg_mask"]] == [5, 6]
    leaves = {k: torch.from_numpy(v).requires_grad_() for k, v in preds.items()}
    total, _, logs = compute_losses(cfg, leaves, batch_to_device(targets, torch.device("cpu")))
    total.backward()
    want = {k: float(v) for k, v in {**logs, "total_loss": total}.items()}
    got = {k: sum(float(r["terms"][k]) for r in ranks["loss"]) for k in want}
    assert set(ranks["loss"][0]["terms"]) == set(want)
    for k, v in want.items():
        _close(got[k], v, k, scale=max(abs(v), 1e-6))
    for k, leaf in leaves.items():
        grad = np.concatenate([r["grads"][k] for r in ranks["loss"]])
        _close(grad, leaf.grad.numpy(), f"d total / d {k}")
    # per-rank denominators would give other terms: the shares are not the
    # ranks' own losses
    own = compute_losses(cfg, {k: torch.from_numpy(v[2:]) for k, v in preds.items()},
                         batch_to_device(shard_batch(targets, 1, WORLD), torch.device("cpu")))[0]
    assert abs(float(own) - ranks["loss"][1]["terms"]["total_loss"]) > 1e-2 * abs(float(own))


@pytest.mark.parametrize("accum", [1, 2])
def test_dgde_step_over_two_ranks_matches_one_process(ranks, accum):
    cfg, batch = _step_inputs(accum)
    results = ranks["step" if accum == 1 else "step_accum"]
    one = dgde_step(cfg, batch, len(results[0]["logs"]), 0, "cpu")
    for r, got in enumerate(results):
        worst = dgde_step_agreement(cfg, got, one)
        assert max(worst.values()) <= 1.0, (r, worst)
        assert all(np.isfinite(s["total_loss"]) for s in got["logs"])
        for k, v in got["state"].items():
            assert np.array_equal(v, results[0]["state"][k]), (r, k)
        assert not any(got["launches"].values())  # CPU tensors never launch
    if accum == 1:  # two steps: the second's loss too
        _close(results[0]["logs"][1]["total_loss"], one["logs"][1]["total_loss"], "step 2",
               rel=5e-4)


def test_gmw_step_over_two_ranks_matches_one_process(ranks):
    gcfg, batch = _gmw_inputs()
    results = ranks["gmw"]
    one = gmw_step(gcfg, batch, len(results[0]["logs"]), 1, "cpu")
    for got in results:
        for step, want in enumerate(one["logs"]):
            for k, v in want.items():
                _close(got["logs"][step][k], v, f"step {step} {k}", scale=abs(v))
        for k, v in one["grads"].items():
            scale = float(np.abs(v).max())
            if k.endswith(".bias"):
                scale = max(scale, float(np.abs(one["grads"][k[:-4] + "weight"]).max()))
            _close(got["grads"][k], v, k, scale=scale)
        for k, v in got["state"].items():
            assert np.array_equal(v, results[0]["state"][k]), k


def test_dgde_step_over_two_ranks_with_remat_is_the_step_without(ranks):
    """Recomputing the forward in the backward inside DDP (BN's all-reduces
    between DDP's bucket reductions) gives the same two steps, bit for bit."""
    for got, want in zip(ranks["step_remat"], ranks["step"]):
        assert got["logs"] == want["logs"]
        for key in ("grads", "first_state", "state"):
            assert set(got[key]) == set(want[key]), key
            for k, v in want[key].items():
                assert np.array_equal(got[key][k], v), (key, k)
