"""The port's KITTI evaluator against the JAX package's.

``dcd_tpu_torch.evaluation`` is a copy of ``dcd_tpu.evaluation`` (numpy) with
its own build of the fused C++ matcher. On the same annotations both give the
identical result string and bitwise equal AP dictionaries, for R40 and R11,
on the scenes of tests/test_eval.py and on random protocol edge cases; the
port's native matcher equals its own Python protocol loop; the rotated IoU is
bitwise equal to JAX's and to the transcribed reference kernel.
"""

import os

import numpy as np
import pytest

from dcd_tpu.evaluation import kitti_eval as jax_eval
from dcd_tpu.evaluation.rotate_iou import rotate_iou_eval as jax_rotate_iou
from dcd_tpu_torch.evaluation import kitti_eval, native
from dcd_tpu_torch.evaluation.rotate_iou import rotate_iou_eval
from ref_rotate_iou_oracle import rotate_iou_gpu_eval as oracle
from test_eval import _make_annos, _near_perfect_dt
from test_eval_vs_reference import _rand_scene
from torch_port_common import one_torch_thread  # noqa: F401  (autouse)


def _empty_anno():
    return {
        "name": np.array([]), "truncated": np.array([]), "occluded": np.array([], np.int64),
        "alpha": np.array([]), "bbox": np.zeros((0, 4)), "dimensions": np.zeros((0, 3)),
        "location": np.zeros((0, 3)), "rotation_y": np.array([]), "score": np.array([]),
    }


def _copy(a):
    return {k: v.copy() for k, v in a.items()}


def _scene_perfect():
    gt = [_make_annos(12, rng=np.random.RandomState(i)) for i in range(5)]
    return gt, [_near_perfect_dt(a) for a in gt]


def _scene_empty():
    gt = [_make_annos(12, rng=np.random.RandomState(i)) for i in range(5)]
    return gt, [_empty_anno() for _ in gt]


def _scene_degraded():
    gt = [_make_annos(12, rng=np.random.RandomState(i)) for i in range(5)]
    dt = [_copy(a) for a in gt]
    for d in dt:
        d["location"] = d["location"] + np.array([1.5, 0, 1.5])
    return gt, dt


def _scene_messy():
    # tests/test_eval.py::TestNativeFusedMatcher's scene: ignored classes,
    # DontCare, occlusion and truncation levels, small boxes
    rng = np.random.RandomState(7)
    gts, dts = [], []
    for i in range(6):
        gt = _make_annos(12, rng=np.random.RandomState(100 + i))
        gt["name"][3] = "Van"
        gt["name"][4] = "DontCare"
        gt["occluded"][5] = 2
        gt["truncated"][6] = 0.4
        gt["bbox"][7] = [0, 0, 60, 30]
        dt = _make_annos(14, jitter=0.6, rng=np.random.RandomState(200 + i))
        dt["bbox"][:10] = gt["bbox"][:10] + rng.uniform(-6, 6, (10, 4))
        dt["location"][:10] = gt["location"][:10] + rng.uniform(-0.4, 0.4, (10, 3))
        dt["rotation_y"][:10] = gt["rotation_y"][:10] + rng.uniform(-0.2, 0.2, 10)
        dt["dimensions"][:10] = gt["dimensions"][:10]
        gts.append(gt)
        dts.append(dt)
    return gts, dts


def _scene_van_dontcare():
    # tests/test_eval.py::TestDifficultyRules: a Van matched by a Car
    # detection, a box below the easy height, and a DontCare region
    gt = _make_annos(50)
    gt["name"] = np.array(["Car"] * 48 + ["Van", "DontCare"])
    gt["bbox"][0] = [0, 0, 50, 30]
    dt = _near_perfect_dt(gt)
    dt["name"] = np.array(["Car"] * 50)
    return [gt], [dt]


def _scene_edge_cases():
    gt_a = _make_annos(45, rng=np.random.RandomState(1))
    none = {k: v[:0].copy() for k, v in gt_a.items()}
    return [gt_a, _copy(none)], [_copy(none), _make_annos(5, rng=np.random.RandomState(2))]


def _scene_random():
    # tests/test_eval_vs_reference.py's generator: DontCare, Van, Truck,
    # the 40/25 px heights, near-duplicate, identical, touching and
    # zero-size 3D boxes
    rng = np.random.RandomState(1234)
    pairs = [_rand_scene(rng) for _ in range(30)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


SCENES = {
    "perfect": _scene_perfect,
    "empty": _scene_empty,
    "degraded": _scene_degraded,
    "messy": _scene_messy,
    "van_dontcare": _scene_van_dontcare,
    "edge_cases": _scene_edge_cases,
    "random": _scene_random,
}


def _assert_same(got, want):
    (s_got, d_got), (s_want, d_want) = got, want
    assert s_got == s_want
    assert d_got.keys() == d_want.keys()
    for k in d_want:
        np.testing.assert_array_equal(d_got[k], d_want[k], err_msg=k)


@pytest.mark.parametrize("metric", ["R40", "R11"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_official_result_equals_jax(scene, metric):
    gt, dt = SCENES[scene]()
    want = jax_eval.get_official_eval_result(gt, dt, ["Car"], metric=metric)
    got = kitti_eval.get_official_eval_result(gt, dt, ["Car"], metric=metric)
    plain = kitti_eval.get_official_eval_result(gt, dt, ["Car"], metric=metric, use_native=False)
    _assert_same(got, want)
    _assert_same(plain, got)
    if scene == "perfect":
        assert set(float(v) for v in got[1].values()) == {100.0}, got[0]
    if scene == "empty":
        assert set(float(v) for v in got[1].values()) == {0.0}


def test_official_result_equals_jax_for_three_classes():
    gt, dt = _scene_random()
    want = jax_eval.get_official_eval_result(gt, dt, ["Car", "Pedestrian", "Cyclist"])
    _assert_same(kitti_eval.get_official_eval_result(gt, dt, ["Car", "Pedestrian", "Cyclist"]), want)


@pytest.mark.parametrize("criterion", [-1, 0, 1, 2])
def test_rotate_iou_bitwise_equals_jax_and_the_reference_kernel(criterion):
    rng = np.random.RandomState(criterion + 5)

    def rand_boxes(n):
        return np.stack([rng.uniform(-40, 40, n), rng.uniform(0, 70, n), rng.uniform(0.1, 5, n),
                         rng.uniform(0.1, 10, n), rng.uniform(-np.pi, np.pi, n)], 1)

    for _ in range(5):
        b, q = rand_boxes(12), rand_boxes(9)
        q[:6] = b[:6] + rng.uniform(-1, 1, (6, 5))
        b[0] = [0, 0, 2, 4, 0.3]; q[0] = b[0]              # identical rotated
        b[1] = [0, 0, 2, 4, 0.0]; q[1] = [2, 0, 2, 4, 0.0]   # touching edge
        b[2] = [0, 0, 0.0, 4, 0.5]; q[2] = [0, 0, 2, 0.0, 0.5]  # zero size
        b[3] = [0, 0, 10, 10, 0.0]; q[3] = [1, 1, 2, 2, 0.7]  # containment
        got = rotate_iou_eval(b, q, criterion)
        want = jax_rotate_iou(b, q, criterion)
        assert got.dtype == want.dtype
        assert np.array_equal(got, want, equal_nan=True)
        ref = oracle(b, q, criterion)
        assert np.array_equal(got.astype(np.float64), ref, equal_nan=True)


def _write_rows(path, anno):
    with open(path, "w") as f:
        for i in range(len(anno["name"])):
            h, w, l = anno["dimensions"][i][[1, 2, 0]]
            vals = [anno["truncated"][i], anno["occluded"][i], anno["alpha"][i],
                    *anno["bbox"][i], h, w, l, *anno["location"][i], anno["rotation_y"][i]]
            row = " ".join(f"{v:.2f}" for v in vals)
            score = f" {anno['score'][i]:.2f}" if anno["score"][i] >= 0 else ""
            f.write(f"{anno['name'][i]} {row}{score}\n")


def test_evaluate_from_files_equals_jax(tmp_path):
    gt, dt = _scene_messy()
    for sub in ("label", "det"):
        (tmp_path / sub).mkdir()
    ids = [f"{i:06d}" for i in range(len(gt))]
    for i, g, d in zip(ids, gt, dt):
        g = dict(g, score=np.full(len(g["name"]), -1.0))
        _write_rows(tmp_path / "label" / f"{i}.txt", g)
        _write_rows(tmp_path / "det" / f"{i}.txt", d)
    (tmp_path / "val.txt").write_text("\n".join(ids))
    args = (str(tmp_path / "label"), str(tmp_path / "det"), str(tmp_path / "val.txt"))
    want = jax_eval.evaluate_from_files(*args, current_class=0, metric="R40")
    got = kitti_eval.evaluate_from_files(*args, current_class=0, metric="R40")
    _assert_same(got, want)
    _assert_same(kitti_eval.evaluate_from_files(*args, current_class=0, use_native=False), got)
    assert got[1]["Car_3d_moderate_R40_0.70"] > 0  # not vacuous
    # the label reader too
    for i in ids:
        a = kitti_eval.get_label_anno(str(tmp_path / "det" / f"{i}.txt"))
        b = jax_eval.get_label_anno(str(tmp_path / "det" / f"{i}.txt"))
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_a_failed_native_build_raises(tmp_path, monkeypatch):
    """No silent fallback: a matcher that does not build raises."""
    bad = tmp_path / "eval_native.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "LIBRARY", tmp_path / "libeval_native.so")
    monkeypatch.setattr(native, "_lib", None)
    gt, dt = _scene_perfect()
    with pytest.raises(RuntimeError, match="failed"):
        kitti_eval.get_official_eval_result(gt, dt, ["Car"])
    assert not os.path.exists(tmp_path / "libeval_native.so")


def test_native_library_is_built_without_march_native():
    assert native.COMMAND == ["g++", "-O3", "-shared", "-fPIC"]
    lib = native.library()
    assert os.path.exists(native.LIBRARY) and lib.kitti_match_scores is not None
