"""The port's KITTI data path against the JAX package's, bitwise.

On a synthetic KITTI tree written by the JAX package's ``write_kitti_tree``
(the port's writes the same files): the label and calibration readers, the
dataset's samples in train mode with augmentation and in val mode (image and
every target array), the loader's first batches from one seed (plain,
two-bucket multi-scale, and resumed mid-stream), the bucket schedule, and the
YAML config loader.
"""

import dataclasses
import filecmp
import os

import numpy as np
import pytest

from dcd_tpu import config as jax_config
from dcd_tpu.data import kitti_dataset as jax_ds
from dcd_tpu.data import kitti_geometry as jax_geo
from dcd_tpu.data import multiscale as jax_ms
from dcd_tpu.data import synthetic as jax_synthetic
from dcd_tpu_torch import config as port_config
from dcd_tpu_torch.data import kitti_dataset, kitti_geometry, multiscale, synthetic
from torch_port_common import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.join(os.path.dirname(__file__), "..")
TRAIN_SEEDS, VAL_SEEDS = (0, 1, 2, 3), (4, 5)
MULTI = ((640, 192), (960, 288))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """(JAX tree, port tree): the ``training`` directories."""
    kw = dict(train_seeds=TRAIN_SEEDS, val_seeds=VAL_SEEDS, num_objs=5)
    jax_root = jax_synthetic.write_kitti_tree(str(tmp_path_factory.mktemp("jax_kitti")), **kw)
    port_root = synthetic.write_kitti_tree(str(tmp_path_factory.mktemp("port_kitti")), **kw)
    return jax_root, port_root


def _configs(batch=2, multi=()):
    out = []
    for make in (jax_config.dgde_run_config, port_config.dgde_run_config):
        cfg = make()
        out.append(dataclasses.replace(
            cfg, input=dataclasses.replace(cfg.input, multi_train_size=multi),
            solver=dataclasses.replace(cfg.solver, ims_per_batch=batch)))
    return out


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_port_writes_the_jax_tree_file_for_file(trees):
    jax_top, port_top = (os.path.dirname(t) for t in trees)
    names = _files(jax_top)
    assert names == _files(port_top)
    assert len([n for n in names if n.endswith(".png")]) == len(TRAIN_SEEDS + VAL_SEEDS)
    _, mismatch, errors = filecmp.cmpfiles(jax_top, port_top, names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


def test_label_and_calibration_readers_equal_jax(trees):
    root = trees[0]
    ids = [f"{s:06d}" for s in TRAIN_SEEDS + VAL_SEEDS]
    for img_id in ids:
        anns = [{"dim": [1.5, 1.6, 3.9], "3dkeypoints": list(np.arange(189.0)), "find_pcl": 1}]
        path = os.path.join(root, "label_2", f"{img_id}.txt")
        got, want = kitti_geometry.read_label(path, anns, 63), jax_geo.read_label(path, anns, 63)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            for f in dataclasses.fields(b):
                np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name), err_msg=f.name)
        path = os.path.join(root, "calib", f"{img_id}.txt")
        a = kitti_geometry.Calibration.from_kitti_file(path)
        b = jax_geo.Calibration.from_kitti_file(path)
        for k in ("P", "V2C", "R0", "c_u", "c_v", "f_u", "f_v", "b_x", "b_y"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
        uvd = np.array([[100.0, 50.0, 12.0], [700.0, 200.0, 40.0]])
        np.testing.assert_array_equal(a.project_image_to_rect(uvd), b.project_image_to_rect(uvd))
        np.testing.assert_array_equal(a.flip_horizontally(1242).P, b.flip_horizontally(1242).P)


def _assert_samples_equal(got, want):
    assert got.img_id == want.img_id
    np.testing.assert_array_equal(got.image, want.image)
    assert got.image.dtype == want.image.dtype
    assert got.targets.keys() == want.targets.keys()
    for k, v in want.targets.items():
        assert got.targets[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got.targets[k], v, err_msg=k)


@pytest.mark.parametrize("mode", ["train_augmented", "val"])
def test_dataset_samples_equal_jax(trees, mode):
    jcfg, tcfg = _configs()
    is_train = mode != "val"
    jds = jax_ds.KITTIDataset(jcfg, trees[0], is_train=is_train)
    tds = kitti_dataset.KITTIDataset(tcfg, trees[0], is_train=is_train)
    assert tds.ids == jds.ids and len(tds) == len(TRAIN_SEEDS if is_train else VAL_SEEDS)
    flips = []
    for i in range(len(tds)):
        rng_seed = 10 + i
        rngs = [np.random.RandomState(rng_seed) if is_train else None for _ in range(2)]
        want = jds.get_sample(i, rngs[0])
        got = tds.get_sample(i, rngs[1])
        _assert_samples_equal(got, want)
        if is_train:  # both drew the same numbers
            assert rngs[0].rand() == rngs[1].rand()
            flips.append(np.random.RandomState(rng_seed).rand() < 0.5)
    assert not is_train or (any(flips) and not all(flips)), flips  # both branches ran


def _batches(loader, n):
    it = iter(loader)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()  # stops the worker threads


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        assert a["img_ids"] == b["img_ids"]
        for k, v in b.items():
            if k != "img_ids":
                np.testing.assert_array_equal(a[k], v, err_msg=k)


@pytest.mark.parametrize("case", ["plain", "multiscale", "resumed"])
def test_loader_batches_equal_jax(trees, case):
    jcfg, tcfg = _configs(multi=MULTI if case == "multiscale" else ())
    jl = jax_ds.make_data_loader(jcfg, trees[0], is_train=True)
    tl = kitti_dataset.make_data_loader(tcfg, trees[0], is_train=True)
    start = 2 if case == "resumed" else 0
    jl.start_batch = tl.start_batch = start
    want, got = _batches(jl, 4), _batches(tl, 4)
    _assert_batches_equal(got, want)
    if case == "multiscale":
        shapes = {b["images"].shape[1:3] for b in got}
        assert shapes == {(h, w) for w, h in MULTI}, shapes
    if case == "resumed":  # batches 2 and 3 of the stream from the start
        straight = _batches(kitti_dataset.make_data_loader(tcfg, trees[0], is_train=True), 4)
        _assert_batches_equal(got[:2], straight[2:])


def test_bucket_schedule_and_buckets_equal_jax():
    for n, seed in ((2, 63), (3, 7)):
        np.testing.assert_array_equal(multiscale.bucket_schedule(n, seed, 1000),
                                      jax_ms.bucket_schedule(n, seed, 1000))
    jcfg, tcfg = _configs(multi=MULTI)
    assert [dataclasses.astuple(b) for b in multiscale.make_buckets(tcfg)] == \
        [dataclasses.astuple(b) for b in jax_ms.make_buckets(jcfg)]


@pytest.mark.parametrize("base", ["default_config", "dgde_run_config"])
def test_yaml_config_equals_jax(base):
    path = os.path.join(REPO, "runs", "DGDE.yaml")
    port_base, jax_base = getattr(port_config, base)(), getattr(jax_config, base)()
    got = dataclasses.asdict(port_config.load_yaml_config(path, base=port_base))
    want = dataclasses.asdict(jax_config.load_yaml_config(path, base=jax_base))
    # ``remat`` too (the port's torch.utils.checkpoint switch)
    assert got["model"]["remat"] is want["model"]["remat"] is False
    assert got == want
    if base == "default_config":  # the file changes the defaults
        assert got != dataclasses.asdict(port_base)
