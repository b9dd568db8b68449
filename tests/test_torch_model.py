"""The port's detector against the JAX package's on shared weights.

Flax variables drawn with numpy (with trained-checkpoint offset statistics
and BN statistics calibrated on the images) are carried into the port with
``from_jax_variables``; the same numpy
images and boundary ring go through both. The DLASeg feature, the heatmap,
the peaks and every regression head at them must agree to 1e-4 of their
largest magnitude, fp32 on the CPU: the two packages run the same
arithmetic in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcd_tpu.data.synthetic import KITTI_P2
from dcd_tpu.engine.infer import postprocess as jax_postprocess
from dcd_tpu.models.dla import DLASeg as JaxDLASeg
from dcd_tpu_torch.engine.infer import infer
from dcd_tpu_torch.models.detector import KeypointDetector
from dcd_tpu_torch.models.layers import DCN
from dcd_tpu_torch.models.predictor import Converter_key2channel
from dcd_tpu_torch.ops.nms import nms_hm, select_point_of_interest, select_topk
from dcd_tpu_torch.utils.weights import from_jax_variables, load_state
from torch_port_common import HEIGHT, WIDTH, calibrated_variables, edge_inputs, small_configs
from torch_port_common import one_torch_thread  # noqa: F401  (autouse)

REL = 1e-4
B = 2


def _close(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= REL * scale, f"{name}: max abs err {err} vs scale {scale}"


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = small_configs()
    rng = np.random.RandomState(11)
    images = rng.randn(B, jcfg.input.height_train, jcfg.input.width_train, 3).astype(np.float32)
    ei, el = edge_inputs(jcfg, B, rng)
    jmodel, variables = calibrated_variables(jcfg, tcfg, images, ei, el, seed=2)

    # the lazy top-K path, the one inference runs: the class map densely,
    # every regression head at the 50 peaks (one jit: cheaper to compile
    # than to run eagerly)
    out_j, inter = jax.jit(lambda v, *a: jmodel.apply(
        v, *a, train=False, lazy_topk=True,
        capture_intermediates=lambda mdl, _: isinstance(mdl, JaxDLASeg),
    ))(variables, jnp.asarray(images), jnp.asarray(ei), jnp.asarray(el))
    feat_j = inter["intermediates"]["backbone"]["__call__"][0]
    out_j = jax.tree.map(np.asarray, out_j)

    model = KeypointDetector(tcfg).eval()
    load_state(model, from_jax_variables(variables, tcfg))
    offsets = []
    hooks = [m.conv_offset_mask.register_forward_hook(lambda _m, _i, o: offsets.append(o[:, :18]))
             for m in model.modules() if isinstance(m, DCN)]
    args = (torch.from_numpy(images), torch.from_numpy(ei).long(), torch.from_numpy(el).long())
    with torch.no_grad():
        feat_t = model.backbone(args[0].permute(0, 3, 1, 2))
        dense_t = model(*args)
        lazy_t = model(*args, lazy_topk=True)
    for h in hooks:
        h.remove()

    # the slice end to end: images -> rows, in both packages
    calib = np.tile(KITTI_P2[None], (B, 1, 1)).astype(np.float32)
    pad = np.tile([[4.0, 2.0]], (B, 1)).astype(np.float32)
    size = np.tile([[WIDTH - 8.0, HEIGHT - 4.0]], (B, 1)).astype(np.float32)
    rows_j = jax.jit(lambda p, *a: jax_postprocess(jcfg, p, *a))(out_j, calib, pad, size)
    rows_j = jax.tree.map(np.asarray, rows_j)
    rows_t = infer(model, *args, *map(torch.from_numpy, (calib, pad, size)))
    return dict(feat_j=np.asarray(feat_j), out_j=out_j, feat_t=feat_t, dense_t=dense_t,
                lazy_t=lazy_t, offsets=offsets, cfg=tcfg, rows_j=rows_j, rows_t=rows_t)


def test_offsets_stay_inside_the_clamp(pair):
    """All 16 DCNs ran, with offsets that move the samples but stay within
    +-R, where the port's clamped form and the JAX gather form agree."""
    offs = pair["offsets"]
    assert len(offs) == 3 * 16  # backbone, dense and lazy forwards
    biggest = max(float(o.abs().max()) for o in offs)
    assert 0.5 < biggest < pair["cfg"].model.backbone.dcn_radius


def test_backbone_feature_matches(pair):
    _close(pair["feat_t"].permute(0, 2, 3, 1).numpy(), pair["feat_j"], "DLASeg feature")


def test_heatmap_matches(pair):
    _close(pair["lazy_t"]["cls"].numpy(), pair["out_j"]["cls"], "cls")


def _matched_peaks(pair):
    """(b, port index, JAX index) of the peaks both packages chose. Random
    weights can leave two peaks' scores ~1e-9 apart; their order in the
    top-K then depends on the summation order, so peaks match by point."""
    pt, pj = pair["lazy_t"]["points_xy"].numpy(), pair["out_j"]["points_xy"]
    out = []
    for b in range(pt.shape[0]):
        where = {tuple(p): i for i, p in enumerate(pt[b])}
        out += [(b, where[tuple(p)], j) for j, p in enumerate(pj[b]) if tuple(p) in where]
    assert len(out) >= pt.shape[0] * (pt.shape[1] - 2)
    return tuple(np.array(x) for x in zip(*out))


def test_peaks_match(pair):
    lazy, out_j = pair["lazy_t"], pair["out_j"]
    b, it, ij = _matched_peaks(pair)
    np.testing.assert_array_equal(lazy["clses"].numpy()[b, it], out_j["clses"][b, ij])
    _close(lazy["scores"].numpy()[b, it], out_j["scores"][b, ij], "scores")
    _close(np.sort(lazy["scores"].numpy(), 1), np.sort(out_j["scores"], 1), "sorted scores")


@pytest.mark.parametrize("key", [k for k, _ in small_configs()[1].model.head.reg_channels_flat])
def test_regression_head_matches_at_peaks(pair, key):
    """Every regression head, by name, at the peaks both packages chose."""
    head = pair["cfg"].model.head
    sl = Converter_key2channel(head.regression_heads, head.regression_channels)(key)
    b, it, ij = _matched_peaks(pair)
    _close(pair["lazy_t"]["reg_pois"].numpy()[b, it, sl], pair["out_j"]["reg_pois"][b, ij, sl], key)


def test_lazy_topk_matches_dense(pair):
    """The lazy top-K path reproduces the dense path at the peaks
    (tests/test_predictor_details.py::test_lazy_topk_matches_dense)."""
    dense, lazy = pair["dense_t"], pair["lazy_t"]
    K = pair["cfg"].test.detections_per_img
    np.testing.assert_allclose(lazy["cls"].numpy(), dense["cls"].numpy(), atol=1e-6)
    scores, indexs, clses, ys, xs = select_topk(nms_hm(dense["cls"]), K=K)
    pois = select_point_of_interest(indexs, dense["reg"])
    np.testing.assert_allclose(lazy["scores"].numpy(), scores.numpy(), atol=1e-6)
    np.testing.assert_array_equal(lazy["clses"].numpy(), clses.numpy())
    np.testing.assert_array_equal(lazy["points_xy"].numpy(), torch.stack([xs, ys], -1).numpy())
    np.testing.assert_allclose(lazy["reg_pois"].numpy(), pois.numpy(), rtol=2e-5, atol=2e-5)


def test_end_to_end_rows_match(pair):
    """Images -> (B, 50, 14) KITTI rows in both packages. Rows are matched by
    their 2D box centre: random weights can leave two peaks' scores ~1e-9
    apart, and then the top-K order may differ."""
    dets_j, valid_j = pair["rows_j"]["dets"], pair["rows_j"]["valid"]
    dets_t, valid_t = pair["rows_t"]["dets"].numpy(), pair["rows_t"]["valid"].numpy()
    assert dets_t.shape == dets_j.shape == (B, 50, 14) and np.isfinite(dets_t).all()
    scale = np.abs(dets_j).max(axis=(0, 1))
    for b in range(B):
        centre = lambda d: np.stack([d[:, 2] + d[:, 4], d[:, 3] + d[:, 5], d[:, 11]], 1)
        cj, ct = centre(dets_j[b]), centre(dets_t[b])
        matched = 0
        for i in range(len(cj)):
            j = int(np.argmin(np.abs(ct - cj[i]).sum(1)))
            if np.all(np.abs(dets_t[b, j] - dets_j[b, i]) <= 1e-4 * scale + 1e-5):
                matched += 1
                assert valid_t[b, j] == valid_j[b, i]
        assert matched >= len(cj) - 2, f"image {b}: {matched} of {len(cj)} rows matched"
