"""The port's demo, visualization and profiling helpers on the CPU.

* ``utils/visualize.py`` draws bitwise what the JAX package's draws on the
  same rows and calibration (PIL on both sides).
* ``python -m dcd_tpu_torch.tools.demo`` (``run`` on parsed flags,
  ``--device cpu``) on a synthetic scene at the small configuration of
  tests/torch_port_common.py, from a port checkpoint of shared weights: its
  rows are JAX's forward (the dense heads, as JAX's ``tools/demo.py``) +
  ``postprocess`` on those weights, each column within ROWS_TOL of its
  largest magnitude, and the PNGs are its rows drawn.
* ``utils/profiling.py``: ``trace_session`` writes a chrome trace holding a
  ``span`` region; ``StepTimer`` leaves its warm-up out.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dcd_tpu.data import synthetic as jax_synthetic
from dcd_tpu.data.kitti_geometry import Calibration as JaxCalibration
from dcd_tpu.data.target_encoder import encode_targets as jax_encode_targets
from dcd_tpu.engine.infer import postprocess as jax_postprocess
from dcd_tpu.utils import visualize as jax_vis
from dcd_tpu_torch.config import dgde_run_config, load_yaml_config
from dcd_tpu_torch.data.kitti_geometry import Calibration
from dcd_tpu_torch.data.synthetic import make_scene
from dcd_tpu_torch.engine.train import build_trainer
from dcd_tpu_torch.tools import demo
from dcd_tpu_torch.utils import profiling
from dcd_tpu_torch.utils import visualize as port_vis
from dcd_tpu_torch.utils.checkpoint import Checkpointer
from dcd_tpu_torch.utils.weights import from_jax_variables, load_state
from torch_port_common import CHANNELS, HEAD_CHANNELS, HEIGHT, WIDTH, calibrated_variables, small_configs
from torch_port_common import one_torch_thread  # noqa: F401  (autouse)

SMALL_YAML = f"""\
INPUT:
  HEIGHT_TRAIN: {HEIGHT}
  WIDTH_TRAIN: {WIDTH}
MODEL:
  BACKBONE:
    CHANNELS: {list(CHANNELS)}
  HEAD:
    NUM_CHANNEL: {HEAD_CHANNELS}
TEST:
  DETECTIONS_THRESHOLD: 0.0
"""
SCENE = 3
# the demo's rows against JAX's, of each column's largest magnitude: measured
# 1.5e-4 at most (the width column; 9.3e-5 the score), the same with the lazy
# heads. The forward's features are held to 1e-4 of scale in
# tests/test_torch_model.py; the decode (exponentiated dimension offsets,
# the mean of the pair depths) grows their rounding in some rows.
ROWS_TOL = 5e-4


def _rows(n, rng):
    """KITTI det rows [cls, alpha, box(4), h, w, l, x, y, z, ry, score]: cars
    in front of the camera, one behind it (its wireframe is skipped)."""
    rows = np.zeros((n, 14))
    rows[:, 2:4] = rng.uniform(0, 600, (n, 2))
    rows[:, 4:6] = rows[:, 2:4] + rng.uniform(20, 200, (n, 2))
    rows[:, 6:9] = rng.uniform([1.4, 1.5, 3.4], [1.7, 1.8, 4.5], (n, 3))
    rows[:, 9:12] = np.stack([rng.uniform(-10, 10, n), rng.uniform(1.4, 1.9, n),
                              rng.uniform(5, 60, n)], 1)
    rows[-1, 11] = -3.0
    rows[:, 12] = rng.uniform(-np.pi, np.pi, n)
    rows[:, 13] = rng.uniform(0, 1, n)
    return rows


def test_visualize_draws_what_jax_draws(tmp_path):
    rng = np.random.RandomState(0)
    img, objs, calib = make_scene(seed=2, num_objs=5)
    jcalib = JaxCalibration(calib.P)
    dets = _rows(7, rng)
    valid = np.array([True, True, False, True, True, True, True])
    kpts = rng.uniform(0, 375, (7, 12, 2))
    gt = port_vis.gt_rows_from_objects(objs)
    np.testing.assert_array_equal(gt, jax_vis.gt_rows_from_objects(objs))
    assert gt.shape == (len(objs), 14) and len(objs) > 0
    for row in dets:
        np.testing.assert_array_equal(port_vis.corners_from_det(row), jax_vis.corners_from_det(row))
    pairs = [
        (port_vis.draw_detections(img, dets, valid, calib, kpts_2d=kpts),
         jax_vis.draw_detections(img, dets, valid, jcalib, kpts_2d=kpts)),
        (port_vis.draw_bev(dets, valid, gt_dets=gt), jax_vis.draw_bev(dets, valid, gt_dets=gt)),
    ]
    heat = rng.rand(img.shape[0] // 4, img.shape[1] // 4).astype(np.float32)
    pairs.append((port_vis.draw_heatmap(img, heat), jax_vis.draw_heatmap(img, heat)))
    for a, b in pairs:
        assert a.size == b.size
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    got = port_vis.render_scene(img, dets, valid, calib, gt_rows=gt, heatmap=heat, kpts_2d=kpts)
    np.testing.assert_array_equal(got, jax_vis.render_scene(img, dets, valid, jcalib, gt_rows=gt,
                                                            heatmap=heat, kpts_2d=kpts))
    port_vis.save_scene_visualization(str(tmp_path / "a.png"), img, dets, valid, calib, gt_rows=gt)
    jax_vis.save_scene_visualization(str(tmp_path / "b.png"), img, dets, valid, jcalib, gt_rows=gt)
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()


@pytest.fixture(scope="module")
def demo_run(tmp_path_factory):
    """The demo from a port checkpoint of calibrated shared weights, and
    JAX's forward + postprocess on the same weights and scene."""
    work = tmp_path_factory.mktemp("demo")
    (work / "small.yaml").write_text(SMALL_YAML)
    tcfg = load_yaml_config(str(work / "small.yaml"), base=dgde_run_config())
    jcfg, _ = small_configs()
    jcfg = dataclasses.replace(jcfg, test=dataclasses.replace(jcfg.test, detections_threshold=0.0))
    img, _, calib = jax_synthetic.make_scene(seed=SCENE, num_objs=6)
    s = jax_encode_targets(img, None, calib, jcfg, is_train=False)
    t = s.targets
    images, ei, el = s.image[None], t["edge_indices"][None], t["edge_len"][None]
    jmodel, variables = calibrated_variables(jcfg, tcfg, images, ei, el)
    post = [np.asarray(t[k][None], np.float32) for k in ("calib_P_full", "pad_size", "image_size")]
    want = jax.jit(lambda v, *a: jax_postprocess(jcfg, jmodel.apply(v, *a[:3], train=False), *a[3:]))(
        variables, jnp.asarray(images), jnp.asarray(ei), jnp.asarray(el), *post)

    trainer = build_trainer(tcfg, device="cpu")
    load_state(trainer.model, from_jax_variables(variables, tcfg))
    Checkpointer(str(work / "ckpt")).save("model_final", trainer)
    got = demo.run(demo.parse_args(
        ["--device", "cpu", "--config", str(work / "small.yaml"), "--synthetic", str(SCENE),
         "--ckpt", str(work / "ckpt"), "--out", str(work / "demo.png"), "--bev", str(work / "bev.png")]))
    return dict(got=got, want=jax.tree.map(np.asarray, want), work=work, calib=calib)


def test_demo_rows_match_jax(demo_run):
    got, want = demo_run["got"], demo_run["want"]
    np.testing.assert_array_equal(got["valid"], want["valid"][0])
    assert got["valid"].sum() > 0
    scale = np.abs(want["dets"][0]).max(axis=0)
    err = np.abs(got["dets"] - want["dets"][0]).max(axis=0)
    assert np.all(err <= ROWS_TOL * scale), str((err / np.maximum(scale, 1e-30)).round(7).tolist())


def test_demo_writes_its_rows_drawn(demo_run):
    got, work = demo_run["got"], demo_run["work"]
    assert got["written"] == [str(work / "demo.png"), str(work / "bev.png")]
    calib = Calibration(demo_run["calib"].P)
    drawn = port_vis.draw_detections(got["image"], got["dets"], got["valid"], calib)
    np.testing.assert_array_equal(np.asarray(Image.open(work / "demo.png")), np.asarray(drawn))
    bev = port_vis.draw_bev(got["dets"], got["valid"])
    np.testing.assert_array_equal(np.asarray(Image.open(work / "bev.png")), np.asarray(bev))


def test_demo_refuses_an_orbax_checkpoint_and_a_missing_card(demo_run, monkeypatch, tmp_path):
    (tmp_path / "model_final").mkdir()  # orbax writes a directory
    (tmp_path / "last_checkpoint").write_text("model_final")
    base = ["--config", str(demo_run["work"] / "small.yaml"), "--synthetic", str(SCENE),
            "--out", str(tmp_path / "x.png")]
    for ckpt in (tmp_path, tmp_path / "model_final"):
        with pytest.raises(NotImplementedError, match="orbax"):
            demo.run(demo.parse_args(["--device", "cpu", *base, "--ckpt", str(ckpt)]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        demo.run(demo.parse_args(base))
    assert not (tmp_path / "x.png").exists()


def test_trace_session_writes_a_chrome_trace_with_the_annotation(tmp_path):
    with profiling.trace_session(None) as prof:
        assert prof is None
    with profiling.trace_session(str(tmp_path / "trace")) as prof:
        with profiling.span("gmw_step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert any(e.key == "gmw_step" for e in prof.key_averages())
    with open(tmp_path / "trace" / profiling.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "gmw_step" for e in events)


def test_step_timer_leaves_out_the_warmup():
    timer = profiling.StepTimer(warmup=1)
    seconds = []
    for n in (1, 2, 3):
        timer.start()
        torch.ones(n * 100, 100).sum()
        seconds.append(timer.stop())
    assert timer.times == seconds[1:] and all(s > 0 for s in seconds)
    assert timer.mean == pytest.approx(sum(seconds[1:]) / 2)
    assert profiling.StepTimer().mean == 0.0
