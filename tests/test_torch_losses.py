"""The port's training targets, codec and losses against the JAX package's.

* ``encode_targets`` + ``collate`` on ``make_scene`` inputs: the same
  arrays, exactly (the port splats with the numpy functions to which the
  JAX package's compiled splat is bit-compatible, and runs the same float64
  numpy otherwise).
* ``compute_losses`` on the same random predictions and targets: every loss
  and log term to 1e-5 relative, and its gradient with respect to the
  predictions to 1e-5 of its largest magnitude (fp32 sums in another
  order; on equal predictions the pair top-k and the orientation bins
  select alike).
* each loss function and the training codec (box corners, pair depths with
  their top-k and mask, points of interest at (x, y)) to 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcd_tpu.config import dgde_run_config as jax_run_config
from dcd_tpu.data import synthetic as jax_synthetic
from dcd_tpu.data import target_encoder as jax_encoder
from dcd_tpu.engine.loss import compute_losses as jax_compute_losses
from dcd_tpu.ops import codec as jax_codec
from dcd_tpu.ops import losses as jax_losses
from dcd_tpu.ops import nms as jax_nms
from dcd_tpu_torch.config import dgde_run_config as torch_run_config
from dcd_tpu_torch.data import synthetic as port_synthetic
from dcd_tpu_torch.data import target_encoder as port_encoder
from dcd_tpu_torch.engine.loss import compute_losses as port_compute_losses
from dcd_tpu_torch.engine.train import batch_to_device
from dcd_tpu_torch.ops import codec as port_codec
from dcd_tpu_torch.ops import losses as port_losses
from dcd_tpu_torch.ops import nms as port_nms

REL = 1e-5


def _close(got, want, name, rel=REL):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= rel * scale + 1e-7, f"{name}: max abs err {err} vs scale {scale}"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encode_targets_matches_jax(seed):
    scene_j = jax_synthetic.make_scene(seed=seed, num_objs=6)
    scene_t = port_synthetic.make_scene(seed=seed, num_objs=6)
    np.testing.assert_array_equal(scene_t[0], scene_j[0])
    want = jax_encoder.encode_targets(*scene_j, jax_run_config(), img_id=f"{seed:06d}")
    got = port_encoder.encode_targets(*scene_t, torch_run_config(), img_id=f"{seed:06d}")
    assert set(got.targets) == set(want.targets)
    assert want.targets["reg_mask"].sum() >= 3
    for k, w in want.targets.items():
        g = got.targets[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got.image, want.image, rtol=0, atol=1e-6)
    assert got.image_size == want.image_size


def test_collate_matches_jax():
    scenes = [(jax_synthetic.make_scene(seed=s), port_synthetic.make_scene(seed=s)) for s in (3, 4)]
    want = jax_encoder.collate([jax_encoder.encode_targets(*j, jax_run_config()) for j, _ in scenes])
    got = port_encoder.collate([port_encoder.encode_targets(*t, torch_run_config()) for _, t in scenes])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_encoder_refuses_an_image_larger_than_the_canvas():
    """(The name is the one this test had while the port refused such an
    image.) An image wider than the canvas is scaled down with its boxes and
    calibration, as the JAX encoder's resize branch does: the targets match
    JAX's."""
    scene_j = jax_synthetic.make_scene(seed=0, image_size=(1400, 375))
    scene_t = port_synthetic.make_scene(seed=0, image_size=(1400, 375))
    want = jax_encoder.encode_targets(*scene_j, jax_run_config())
    got = port_encoder.encode_targets(*scene_t, torch_run_config())
    assert want.image_size != (1400, 375) and got.image_size == want.image_size
    assert want.targets["reg_mask"].sum() >= 1
    for k, w in want.targets.items():
        g = got.targets[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got.image, want.image, rtol=0, atol=1e-6)


# ---------------------------------------------------------------- compute_losses


def _loss_cfgs():
    """The shipped configuration on a 128x384 canvas (32x96 feature map)."""
    out = []
    for make in (jax_run_config, torch_run_config):
        cfg = make()
        out.append(dataclasses.replace(
            cfg, input=dataclasses.replace(cfg.input, height_train=128, width_train=384)))
    return out


@pytest.fixture(scope="module")
def loss_case():
    jcfg, tcfg = _loss_cfgs()
    samples = [jax_encoder.encode_targets(*jax_synthetic.make_scene(
        seed=s, num_objs=6, image_size=(380, 124), depth_range=(6.0, 30.0)), jcfg) for s in range(2)]
    batch = jax_encoder.collate(samples)
    assert batch["reg_mask"].sum() >= 6
    rng = np.random.RandomState(0)
    B, C, Ho, Wo = batch["hm"].shape
    R = sum(sum(g) for g in jcfg.model.head.regression_channels)
    logits = rng.randn(B, Ho, Wo, C).astype(np.float32) * 2.0
    preds = {"cls": np.clip(1.0 / (1.0 + np.exp(-logits)), 1e-4, 1 - 1e-4).astype(np.float32),
             "reg": (rng.randn(B, Ho, Wo, R) * 0.5).astype(np.float32)}

    def total(p, b):
        t, loss_dict, log_dict = jax_compute_losses(jcfg, p, b)
        return t, (loss_dict, log_dict)

    (t_j, (loss_j, log_j)), grads_j = jax.jit(jax.value_and_grad(total, has_aux=True))(
        jax.tree.map(jnp.asarray, preds), batch)
    leaves = {k: torch.from_numpy(v).requires_grad_() for k, v in preds.items()}
    t_t, loss_t, log_t = port_compute_losses(tcfg, leaves, batch_to_device(batch, torch.device("cpu")))
    t_t.backward()
    return dict(want=(float(t_j), jax.tree.map(np.asarray, loss_j), jax.tree.map(np.asarray, log_j),
                      jax.tree.map(np.asarray, grads_j)),
                got=(float(t_t.detach()), loss_t, log_t, {k: v.grad.numpy() for k, v in leaves.items()}))


def test_compute_losses_terms_match_jax(loss_case):
    t_j, loss_j, log_j, _ = loss_case["want"]
    t_t, loss_t, log_t, _ = loss_case["got"]
    assert set(loss_t) == set(loss_j) and set(log_t) == set(log_j)
    for kind, got, want in (("loss", loss_t, loss_j), ("log", log_t, log_j)):
        for k, v in want.items():
            g = float(got[k].detach())
            assert abs(g - float(v)) <= REL * abs(float(v)) + 1e-7, (kind, k, g, float(v))
    assert abs(t_t - t_j) <= REL * abs(t_j)
    assert all(float(v) > 0 for k, v in loss_j.items() if k != "trunc_offset_loss")


@pytest.mark.parametrize("key", ["cls", "reg"])
def test_compute_losses_gradient_matches_jax(loss_case, key):
    got = loss_case["got"][3][key]
    want = loss_case["want"][3][key]
    assert np.abs(want).max() > 0
    _close(got, want, f"d total / d {key}")


def test_empty_batch_losses_are_finite():
    """All-padding targets (no objects) give finite losses, as in the JAX
    package's tests/test_train_step.py."""
    _, tcfg = _loss_cfgs()
    batch = port_encoder.collate([port_encoder.encode_targets(
        *port_synthetic.make_scene(seed=0, num_objs=0, image_size=(380, 124)), tcfg)])
    B, C, Ho, Wo = batch["hm"].shape
    R = sum(sum(g) for g in tcfg.model.head.regression_channels)
    preds = {"cls": torch.full((B, Ho, Wo, C), 0.5), "reg": torch.zeros(B, Ho, Wo, R)}
    total, loss_dict, _ = port_compute_losses(tcfg, preds, batch_to_device(batch, torch.device("cpu")))
    assert np.isfinite(float(total)) and all(np.isfinite(float(v)) for v in loss_dict.values())


# ---------------------------------------------------------------- loss functions


def test_focal_loss_is_finite_at_saturated_predictions():
    """The clamp stays below 1 in fp32: at p = 1 on a negative (and p = 0 on
    a positive) the loss is finite, and equal to the JAX package's."""
    pred = np.array([1.0, 0.0, 1.0, 0.5, 1.0 - 1e-10], np.float32)
    target = np.array([0.0, 1.0, 1.0, 0.3, 0.0], np.float32)
    loss_t, n_t = port_losses.penalty_reduced_focal_loss(torch.from_numpy(pred), torch.from_numpy(target))
    loss_j, n_j = jax_losses.penalty_reduced_focal_loss(jnp.asarray(pred), jnp.asarray(target))
    assert np.isfinite(float(loss_t)) and float(n_t) == float(n_j) == 2.0
    _close(loss_t, np.asarray(loss_j), "focal at saturation")


def _pair(shape, rng, low=None):
    a = rng.randn(*shape).astype(np.float32)
    return np.abs(a) + 0.1 if low == "positive" else a


LOSS_CASES = {
    "focal": lambda m, rng: m.penalty_reduced_focal_loss(
        *_t(m, 1.0 / (1.0 + np.exp(-_pair((2, 6, 8, 1), rng))),
            np.where(rng.rand(2, 6, 8, 1) > 0.9, 1.0, rng.rand(2, 6, 8, 1) * 0.9)), 2.0, 4.0)[0],
    "iou": lambda m, rng: m.iou_loss(*_t(m, _pair((9, 4), rng, "positive"),
                                         _pair((9, 4), rng, "positive")), "iou"),
    "linear_iou": lambda m, rng: m.iou_loss(*_t(m, _pair((9, 4), rng, "positive"),
                                                _pair((9, 4), rng, "positive")), "linear_iou"),
    "giou": lambda m, rng: m.iou_loss(*_t(m, _pair((9, 4), rng, "positive"),
                                          _pair((9, 4), rng, "positive")), "giou"),
    "smooth_l1": lambda m, rng: m.smooth_l1_loss(*_t(m, _pair((7, 3), rng), _pair((7, 3), rng))),
    "log_l1": lambda m, rng: m.log_l1_loss(*_t(m, _pair((7,), rng, "positive"),
                                               _pair((7,), rng, "positive"))),
    "berhu": lambda m, rng: m.berhu_loss(*_t(m, _pair((11,), rng), _pair((11,), rng))),
    "depth_reweight": lambda m, rng: m.depth_reweight(*_t(m, rng.uniform(1, 60, 13))),
    "reg_weighted_l1": lambda m, rng: m.reg_weighted_l1_loss(
        *_t(m, _pair((5, 4, 2), rng), _pair((5, 4, 2), rng), rng.uniform(1, 60, 5))),
    "multibin": lambda m, rng: m.multibin_orientation_loss(
        *_t(m, _pair((6, 16), rng), np.concatenate(
            [(rng.rand(6, 4) > 0.5), rng.uniform(-3, 3, (6, 4))], 1), (rng.rand(6) > 0.3)), 4),
    "multibin_unweighted": lambda m, rng: m.multibin_orientation_loss(
        *_t(m, _pair((6, 16), rng), np.concatenate(
            [(rng.rand(6, 4) > 0.5), rng.uniform(-3, 3, (6, 4))], 1))),
    "wing": lambda m, rng: m.wing_loss(*_t(m, _pair((9,), rng) * 8, _pair((9,), rng))),
    "laplace": lambda m, rng: m.laplace_loss(*_t(m, _pair((9,), rng), _pair((9,), rng, "positive"))),
    "uncertainty_reg": lambda m, rng: m.uncertainty_reg_loss(*_t(m, _pair((9,), rng),
                                                                 _pair((9,), rng))),
    "multitask_weighting": lambda m, rng: m.multitask_uncertainty_weighting(
        dict(zip(("a_loss", "b_loss"), _t(m, np.float32(1.5), np.float32(0.5)))),
        *_t(m, _pair((3,), rng)), ("a_loss", "b_loss", "c_loss")),
    # fewer log variances than keys: JAX's indexing clamps to the last one
    "multitask_weighting_short": lambda m, rng: m.multitask_uncertainty_weighting(
        dict(zip(("a_loss", "b_loss", "c_loss"), _t(m, np.float32(1.5), np.float32(0.5),
                                                    np.float32(2.0)))),
        *_t(m, _pair((2,), rng)), ("a_loss", "b_loss", "c_loss", "d_loss")),
}


def _t(module, *arrays):
    """The arrays in ``module``'s framework, fp32."""
    conv = torch.from_numpy if module is port_losses else jnp.asarray
    return tuple(conv(np.asarray(a, np.float32)) for a in arrays)


def _leaves(x):
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [v for item in x for v in _leaves(item)]
    return [x]


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_loss_functions_match_jax(name):
    got = LOSS_CASES[name](port_losses, np.random.RandomState(7))
    want = LOSS_CASES[name](jax_losses, np.random.RandomState(7))
    for i, (g, w) in enumerate(zip(_leaves(got), _leaves(want))):
        _close(g, np.asarray(w), f"{name}[{i}]")


# ---------------------------------------------------------------- codec


def test_encode_box3d_matches_jax():
    rng = np.random.RandomState(3)
    rot = rng.uniform(-np.pi, np.pi, 7).astype(np.float32)
    dims = rng.uniform(1, 5, (7, 3)).astype(np.float32)
    locs = (rng.randn(7, 3) * 10).astype(np.float32)
    _close(port_codec.rad_to_matrix(torch.from_numpy(rot)), np.asarray(jax_codec.rad_to_matrix(rot)),
           "rad_to_matrix")
    got = port_codec.encode_box3d(*map(torch.from_numpy, (rot, dims, locs)))
    _close(got, np.asarray(jax_codec.encode_box3d(rot, dims, locs)), "encode_box3d")


@pytest.mark.parametrize("with_mask", [True, False])
def test_pair_depths_training_form_matches_jax(with_mask):
    rng = np.random.RandomState(4)
    N, n = 3, 73
    P = np.tile(np.asarray(port_synthetic.KITTI_P2, np.float32)[None], (N, 1, 1))
    kpts_2d = (rng.rand(N, n, 2) * [1242, 375]).astype(np.float32)
    kpts_3d = (rng.randn(N, n, 3)).astype(np.float32)
    rot = rng.uniform(-3, 3, N).astype(np.float32)
    mask = (rng.rand(N, n) > 0.3).astype(np.float32) if with_mask else None
    got_d, got_m = port_codec.decode_pairs_kpts_depth(
        *map(torch.from_numpy, (kpts_2d, kpts_3d, rot, P)), training=True,
        kpts_2d_mask=None if mask is None else torch.from_numpy(mask), pairs_topk=1500)
    want_d, want_m = jax_codec.decode_pairs_kpts_depth(
        kpts_2d, kpts_3d, rot, P, training=True, kpts_2d_mask=mask, pairs_topk=1500)
    _close(got_d, np.asarray(want_d), "pair depths")
    if with_mask:
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    else:
        assert got_m is None and want_m is None


def test_points_of_interest_at_xy_match_jax():
    rng = np.random.RandomState(5)
    fmap = rng.randn(2, 6, 9, 4).astype(np.float32)
    pts = np.stack([rng.randint(0, 9, (2, 5)), rng.randint(0, 6, (2, 5))], -1).astype(np.int32)
    got = port_nms.select_point_of_interest(torch.from_numpy(pts), torch.from_numpy(fmap))
    want = jax_nms.select_point_of_interest(jnp.asarray(pts), jnp.asarray(fmap))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
