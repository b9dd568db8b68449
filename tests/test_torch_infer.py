"""The port's inference post-processing against the JAX package's.

The JAX heads (``dcd_tpu.models.predictor.Predictor``, weights drawn with
numpy) make one set of predictions from numpy features, both the lazy top-K
form and the dense map; the same predictions, as numpy, go through both
packages' ``postprocess`` in every ``output_depth`` mode. Rows must agree
to 1e-4 relative (1e-4 absolute near zero), fp32 on the CPU. The slice end
to end (images -> rows on shared weights) is in test_torch_model.py, which
already holds the full JAX model.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from dcd_tpu.data.synthetic import KITTI_P2 as JAX_KITTI_P2
from dcd_tpu.data.target_encoder import get_edge_indices as jax_get_edge_indices
from dcd_tpu.engine.infer import format_kitti_lines as jax_format_kitti_lines
from dcd_tpu.engine.infer import postprocess as jax_postprocess
from dcd_tpu.models.predictor import Predictor as JaxPredictor
from dcd_tpu_torch.data.edges import KITTI_P2, get_edge_indices, padded_edge_indices
from dcd_tpu_torch.engine.infer import format_kitti_lines, postprocess
from torch_port_common import HEAD_CHANNELS, edge_inputs, small_configs
from torch_port_common import one_torch_thread  # noqa: F401  (autouse)

B = 2
MODES = ["edges", "soft", "hard", "direct"]


def _mode(cfg, mode):
    head = dataclasses.replace(cfg.model.head, output_depth=mode)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, head=head))


@pytest.fixture(scope="module")
def predictions():
    jcfg, tcfg = small_configs()
    rng = np.random.RandomState(21)
    H, W, C = jcfg.output_height, jcfg.output_width, HEAD_CHANNELS
    feats = np.maximum(rng.randn(B, H, W, C), 0).astype(np.float32)
    ei, el = edge_inputs(jcfg, B, rng)
    heads = JaxPredictor(jcfg)
    shapes = jax.eval_shape(lambda r: heads.init(r, feats, ei, el, train=False),
                            jax.random.PRNGKey(0))

    def draw(path, s):
        leaf = getattr(path[-1], "key", "")
        if leaf == "kernel":
            return (rng.randn(*s.shape) * np.sqrt(1.0 / np.prod(s.shape[:-1]))).astype(np.float32)
        if leaf in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.randn(*s.shape) * 0.3).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    run = jax.jit(lambda v, *a, lazy: heads.apply(v, *a, train=False, lazy_topk=lazy),
                  static_argnames="lazy")
    preds = {
        "lazy": jax.tree.map(np.array, run(variables, feats, ei, el, lazy=True)),
        "dense": jax.tree.map(np.array, run(variables, feats, ei, el, lazy=False)),
    }
    calib = np.stack([KITTI_P2, KITTI_P2 * [[1.1], [1.1], [1.0]]]).astype(np.float32)
    pad = np.array([[4.0, 2.0], [0.0, 6.0]], np.float32)
    size = np.array([[120.0, 60.0], [128.0, 52.0]], np.float32)
    return jcfg, tcfg, preds, (calib, pad, size)


@pytest.mark.parametrize("form", ["lazy", "dense"])
@pytest.mark.parametrize("mode", MODES)
def test_postprocess_matches_jax(predictions, mode, form):
    jcfg, tcfg, preds, calib = predictions
    jcfg, tcfg = _mode(jcfg, mode), _mode(tcfg, mode)
    want = jax.jit(lambda p, *a: jax_postprocess(jcfg, p, *a))(preds[form], *calib)
    want = jax.tree.map(np.asarray, want)
    got = postprocess(tcfg, {k: torch.from_numpy(v) for k, v in preds[form].items()},
                      *map(torch.from_numpy, calib))
    assert got["dets"].shape == (B, tcfg.test.detections_per_img, 14)
    for key in ("dets", "kpts_2d", "kpts_3d"):
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=1e-4, atol=1e-4, err_msg=key)
    np.testing.assert_array_equal(got["valid"].numpy(), want["valid"])
    assert want["valid"].any() and not want["valid"].all()


def test_depth_modes_differ(predictions):
    """The four modes give four final depths (the test above covers them
    all, not one path four times)."""
    _, tcfg, preds, calib = predictions
    pt = {k: torch.from_numpy(v) for k, v in preds["lazy"].items()}
    z = [postprocess(_mode(tcfg, m), pt, *map(torch.from_numpy, calib))["dets"][..., 11]
         for m in MODES]
    for i in range(len(z)):
        for j in range(i):
            assert not torch.allclose(z[i], z[j])


def test_kitti_lines_match(predictions):
    jcfg, tcfg, preds, calib = predictions
    got = postprocess(tcfg, {k: torch.from_numpy(v) for k, v in preds["lazy"].items()},
                      *map(torch.from_numpy, calib))
    for b in range(B):
        dets, valid = got["dets"][b].numpy(), got["valid"][b].numpy()
        lines = format_kitti_lines(dets, valid, ("Car",))
        assert lines == jax_format_kitti_lines(dets, valid, ("Car",))
        assert len(lines) == int(valid.sum()) and lines[0].startswith("Car 0.00 0 ")


@pytest.mark.parametrize("size,pad", [((1242, 375), (19, 4)), ((1224, 370), (28, 7)),
                                      ((120, 60), (4, 2))])
def test_edge_indices_match(size, pad):
    pad = np.array(pad)
    np.testing.assert_array_equal(get_edge_indices(size, pad), jax_get_edge_indices(size, pad))
    ring, n = padded_edge_indices(size, pad, 832)
    assert n == len(jax_get_edge_indices(size, pad)) and not ring[n:].any()
    np.testing.assert_array_equal(KITTI_P2, JAX_KITTI_P2)
