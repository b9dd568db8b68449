"""The port's data-parallel entry points over two gloo processes on the CPU:
``entry.dryrun_multichip(2, device="cpu")``, ``train_dgde`` with ``--num_processes 2``
through its own rendezvous (``tools/multiprocess_smoke.run_cli``: 3
iterations, then the sharded ``--eval``), and ``train_gmw``'s data-parallel
ranks (``rank_worker``) against one process.

``train_dgde`` runs at the small configuration of tests/torch_port_common.py
on a 4 + 5 scene tree: every val id gets its txt file from one of the two
ranks, rank 0 alone writes ``result.json`` and ``model_final``, and both ranks
end with the same weights, bit for bit. ``train_gmw`` trains one epoch of 4
steps at batch 4 on the inputs of tests/test_torch_gmw_cli.py (12 keypoints,
the shipped width): the two ranks' global logs against one process, step 0
to 1e-4 relative and the epoch's means to 5e-4 (that file's STEP0_REL and
EPOCH_REL: the shipped-width GMW is ill-conditioned at random weights).
"""

import os

import numpy as np
import pytest

from dcd_tpu_torch.data.synthetic import write_kitti_tree
from dcd_tpu_torch.entry import dryrun_multichip
from dcd_tpu_torch.parallel import launch
from dcd_tpu_torch.tools import multiprocess_smoke, train_gmw
from test_torch_gmw_cli import EPOCH_REL, N_KPTS, STEP0_REL, TOPK, write_inputs
from torch_port_common import CHANNELS, HEAD_CHANNELS, HEIGHT, WIDTH
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
SOLVER:
  IMS_PER_BATCH: 2
"""
VAL_SEEDS = (4, 5, 6, 7, 8)  # an odd count: the shards differ in size


def test_dryrun_multichip_two_processes():
    out = dryrun_multichip(2, device="cpu")
    assert np.isfinite(out["dgde"]["ranks"][0]["logs"][0]["total_loss"])
    assert np.isfinite(out["gmw"]["ranks"][0]["logs"][0]["loss"])


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    work = tmp_path_factory.mktemp("parallel_cli")
    data_root = write_kitti_tree(str(work / "kitti"), train_seeds=range(4), val_seeds=VAL_SEEDS,
                                 num_objs=4, image_size=(120, 60))
    (work / "small.yaml").write_text(SMALL_YAML)
    out = multiprocess_smoke.run_cli(data_root, str(work / "small.yaml"), str(work / "logs"),
                                     device="cpu", use_tensorboard=False)
    return dict(out, work=work, data_root=data_root)


def test_train_dgde_over_two_processes_trains_and_evaluates_sharded(cli):
    assert all(cli["checks"].values()), cli["checks"]
    assert sorted(cli["images"]) == [2, 3]  # InferenceSampler's shards of 5
    assert "Car_3d_moderate_R40_0.70" in cli["ap"]
    assert cli["losses"][0] == cli["losses"][1] and all(np.isfinite(cli["losses"][0]))
    files = os.listdir(cli["work"] / "logs" / "inference" / "data")
    assert len(files) == len(VAL_SEEDS)


def test_train_gmw_ranks_train_as_one_process(tmp_path):
    data = write_inputs(tmp_path)
    flags = ["--device", "cpu", "--train_data", data["train"], "--val_data", "none.json",
             "--num_kpts", str(N_KPTS), "--topk", str(TOPK), "--batch_size", "4", "--epochs", "1",
             "--save_every", "1"]
    two = launch(train_gmw.rank_worker, 2,
                 (train_gmw.parse_args([*flags, "--log_dir", str(tmp_path / "two")]),))
    assert two[1] is None and two[0]["final"] is None
    one = train_gmw.run(train_gmw.parse_args([*flags, "--log_dir", str(tmp_path / "one")]))
    got, want = two[0]["epochs"][0]["steps"], one["epochs"][0]["steps"]
    assert len(got) == len(want) == 4
    for k in ("loss", "cls_loss", "reg_loss", "depth_MAE"):
        assert abs(got[0][k] - want[0][k]) <= STEP0_REL * abs(want[0][k]), k
        g, w = np.mean([s[k] for s in got]), np.mean([s[k] for s in want])
        assert abs(g - w) <= EPOCH_REL * abs(w), k
    assert sorted(os.listdir(tmp_path / "two" / "ckpt")) == sorted(
        os.listdir(tmp_path / "one" / "ckpt"))
