"""The port's two-stage artifact (``dcd_tpu_torch/tools/two_stage_artifact.py``)
end to end on the CPU at a tiny size: a checkpoint of the small
configuration written as ``convergence_run --save_ckpt`` writes it, the gen
step over a pool of 1 scene, inference on 2 held-out scenes at detection
threshold 0 (the seeded weights score under the shipped threshold), one
epoch of a narrow GMW, the refinement and both stages' KITTI AP and
matched depth MAE. Every piece is held to the JAX package in its own test
file; this one holds the composition: the table, the counts it reports and
that stage 2 moves the depths of the detections it refines. (The GMW step
is most of the time: its Sinkhorn layer over the 2628 edges of the 73
keypoints costs about a second per object on the CPU.)"""

import dataclasses

import numpy as np

from dcd_tpu_torch.engine.gmw_train import GMWConfig
from dcd_tpu_torch.engine.train import build_trainer
from dcd_tpu_torch.tools import two_stage_artifact
from dcd_tpu_torch.utils.checkpoint import Checkpointer
from torch_port_common import one_torch_thread, small_configs  # noqa: F401

SCENES = dict(image_size=(120, 60), depth_range=(6.0, 20.0))


def test_two_stage_artifact_end_to_end(tmp_path):
    _, cfg = small_configs()
    cfg = dataclasses.replace(cfg, test=dataclasses.replace(cfg.test, detections_threshold=0.0,
                                                            detections_per_img=8))
    Checkpointer(str(tmp_path / "ckpt")).save("model_final", build_trainer(cfg, "cpu", seed=3))
    args = two_stage_artifact.parse_args([
        "--ckpt", str(tmp_path / "ckpt" / "model_final"), "--pool", "1", "--batch", "1",
        "--val_scenes", "2", "--epochs", "1", "--reg_start", "1", "--gmw_batch", "8",
        "--out", str(tmp_path / "TWO_STAGE.md"), "--device", "cpu"])
    out = two_stage_artifact.run(args, cfg, GMWConfig(features=16, depth=2, topk=64), SCENES)
    assert out["n_train_objs"] >= 4 and out["gmw_steps"] >= 1
    assert out["n_dets"] == 2 * 8  # every row valid at threshold 0
    for stage in ("stage1", "stage2"):
        assert all(np.isfinite(out["results"][stage][k]) for _, k in two_stage_artifact.AP_KEYS)
    # stage 2 moves every refined detection along its ray, finitely
    z1 = np.concatenate([a for a, _ in out["depths"].values()])
    z2 = np.concatenate([b for _, b in out["depths"].values()])
    assert z1.shape == z2.shape == (16,) and np.isfinite(z2).all() and not np.allclose(z1, z2)
    text = (tmp_path / "TWO_STAGE.md").read_text()
    assert text.count("\n|") >= 7 and "depth MAE of 2D-matched dets" in text


def test_matched_depth_errors_match_once_by_iou():
    class Ob:
        def __init__(self, box, z):
            self.box2d, self.t = np.array(box, np.float64), np.array([0.0, 0.0, z])

    gts = [Ob([0, 0, 10, 10], 20.0), Ob([20, 0, 30, 10], 30.0)]
    rows = np.zeros((3, 14))
    rows[0, 2:6], rows[0, 11] = [0, 0, 10, 9], 21.0  # IoU 0.9 with GT 0
    rows[1, 2:6], rows[1, 11] = [1, 0, 10, 10], 25.0  # GT 0 is taken
    rows[2, 2:6], rows[2, 11] = [40, 0, 50, 10], 9.0  # nothing
    assert two_stage_artifact.matched_depth_errors(rows, gts) == [1.0]
