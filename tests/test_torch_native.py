"""The port's native heat-map encoder (``csrc/heatmap_native.cc`` through
``dcd_tpu_torch/data/native.py``) against its numpy versions and against the
JAX package's, bitwise: the splats of random objects (both kinds, radii up to
40, centres anywhere), objects on every border and corner, one-sided radii
(0 on one axis), a class id out of range, and the pad + normalise of a
KITTI-sized image, as tests/test_native.py checks the JAX package's (there
within 1e-6)."""

import dataclasses

import numpy as np
import pytest

from dcd_tpu import native as jax_native
from dcd_tpu.config import dgde_run_config as jax_dgde_run_config
from dcd_tpu.data import heatmap as jax_heatmap
from dcd_tpu.data.target_encoder import normalize_image as jax_normalize_image
from dcd_tpu.data.target_encoder import pad_image as jax_pad_image
from dcd_tpu_torch.config import dgde_run_config
from dcd_tpu_torch.data import heatmap, native
from dcd_tpu_torch.data.target_encoder import normalize_image, pad_image, pad_offset
from torch_port_common import one_torch_thread  # noqa: F401  (autouse)

H, W = 96, 320


def _objects(rng, n):
    centers = np.stack([rng.randint(0, W, n), rng.randint(0, H, n)], axis=1)
    return (rng.randint(0, 3, n), centers, rng.randint(0, 41, n), rng.randint(0, 41, n),
            rng.randint(0, 2, n))


def _all_three(objs, planes=3):
    """(port native, port numpy, JAX package) heat maps of the objects."""
    got = native.splat_batch(np.zeros((planes, H, W), np.float32), *objs)
    plain = heatmap.splat_batch(np.zeros((planes, H, W), np.float32), *objs)
    jax_side = jax_native.splat_batch(np.zeros((planes, H, W), np.float32), *objs)
    return got, plain, jax_side


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_splats_are_bitwise_numpy_and_jax(seed):
    objs = _objects(np.random.RandomState(seed), 40)
    got, plain, jax_side = _all_three(objs)
    assert (plain > 0).sum() > 1000
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, jax_side)


def test_border_clipping_and_one_sided_radii():
    cases = [(x, y) for x in (0, 1, W - 2, W - 1, W // 2) for y in (0, 1, H - 2, H - 1, H // 2)]
    radii = [(8, 8), (0, 6), (6, 0), (0, 0), (40, 3)]
    for kind in (0, 1):
        for rx, ry in radii:
            n = len(cases)
            objs = (np.zeros(n, np.int32), np.array(cases), np.full(n, rx), np.full(n, ry),
                    np.full(n, kind))
            got, plain, jax_side = _all_three(objs, planes=1)
            assert plain.max() == 1.0
            np.testing.assert_array_equal(got, plain, err_msg=f"kind {kind} radii {rx, ry}")
            np.testing.assert_array_equal(got, jax_side, err_msg=f"kind {kind} radii {rx, ry}")


def test_class_out_of_range_is_skipped_and_refusals():
    objs = (np.array([3, -1, 1]), np.array([[5, 5], [6, 6], [7, 7]]), np.array([2, 2, 2]),
            np.array([2, 2, 2]), np.array([0, 0, 0]))
    got, plain, _ = _all_three(objs)
    np.testing.assert_array_equal(got, plain)
    assert got[0].max() == 0 and got[2].max() == 0 and got[1].max() == 1.0
    with pytest.raises(ValueError, match="C-contiguous"):
        native.splat_batch(np.zeros((3, H, W), np.float64), *objs)
    with pytest.raises(TypeError, match="uint8"):
        native.pad_normalize_image(np.zeros((4, 4, 3), np.float32), 8, 8, (2, 2), (0, 0, 0),
                                   (1, 1, 1))
    with pytest.raises(ValueError, match="does not fit"):
        native.pad_normalize_image(np.zeros((4, 4, 3), np.uint8), 8, 8, (5, 2), (0, 0, 0),
                                   (1, 1, 1))


@pytest.mark.parametrize("to_bgr", [False, True])
def test_pad_normalize_is_bitwise_numpy_and_jax(to_bgr):
    cfg, jcfg = dgde_run_config(), jax_dgde_run_config()
    cfg = dataclasses.replace(cfg, input=dataclasses.replace(cfg.input, to_bgr=to_bgr))
    jcfg = dataclasses.replace(jcfg, input=dataclasses.replace(jcfg.input, to_bgr=to_bgr))
    Hc, Wc = cfg.input.height_train, cfg.input.width_train
    for shape in ((375, 1242, 3), (370, 1224, 3), (Hc, Wc, 3)):
        img = np.random.RandomState(1).randint(0, 256, shape, np.uint8)
        src = img[..., ::-1] if to_bgr else img
        pad = pad_offset(shape[1], shape[0], Wc, Hc)
        got = native.pad_normalize_image(src, Hc, Wc, pad, cfg.input.pixel_mean,
                                         cfg.input.pixel_std)
        want = normalize_image(pad_image(img, Hc, Wc)[0], cfg)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jax_normalize_image(jax_pad_image(img, Hc, Wc)[0], jcfg))
