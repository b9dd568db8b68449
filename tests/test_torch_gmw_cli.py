"""The port's GMW command line on the CPU against the JAX package's.

``tools/train_gmw.py`` runs in-process (its ``main()`` with ``sys.argv`` set)
and ``python -m dcd_tpu_torch.tools.train_gmw`` in-process (``run`` on parsed
flags, ``--device cpu``) on the same inputs: gen_data JSONs written by the
port's writers from synthetic scenes (12 keypoints of each car, projected
with a little noise; 66 edges, ``--topk 66``) and a KITTI tree from
``write_kitti_tree`` for ``--kitti_path``. Batch 4, 2 epochs, validation and
a checkpoint every epoch. The GMW is the shipped width (128 features, depth
12; the command line has no flag for either).

Both start from the same weights: JAX's command line draws them with
``create_gmw_state(cfg, PRNGKey(seed), steps_per_epoch)``; the test makes the
same call, carries the parameters with ``from_jax_gmw_params`` into a port
checkpoint at epoch 0, and the port starts from it with ``--resume``. Limits,
each beside its measurement (fp32 on a CPU, one intra-op thread):

* the logs: step 0, from shared weights, <= 1e-4 relative
  (tests/test_torch_gmw.py's SHIPPED_LOSS_REL); each epoch's mean of every
  log, where each package follows its own updates, <= 5e-4 (its
  SHIPPED_LATE_LOSS_REL) - see STEP0_REL and EPOCH_REL;
* the refined locations of the final txt files: LOC_REL of the largest
  coordinate;
* the AP of both txt sets equal, the checkpoint names and the best epoch
  equal.

``--resume`` from ``checkpoint_epoch_1`` starts at epoch 2 with the LR the
straight run had there, and draws the batch order anew from ``--seed``, as
JAX's command line does.
"""

import copy
import json
import os
import shutil
import sys
from importlib import util as importlib_util

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from dcd_tpu.engine import gmw_train as jax_gmw_train
from dcd_tpu.evaluation import evaluate_from_files as jax_evaluate_from_files
from dcd_tpu_torch.data.gen_data import GenDataInferWriter, GenDataTrainWriter, normalize_kpts_2d
from dcd_tpu_torch.data.kitti_geometry import roty_matrix
from dcd_tpu_torch.data.synthetic import make_scene, write_kitti_tree
from dcd_tpu_torch.engine import gmw_train as port_gmw_train
from dcd_tpu_torch.tools import train_gmw
from dcd_tpu_torch.utils.checkpoint import Checkpointer
from dcd_tpu_torch.utils.weights import from_jax_gmw_params, load_state
from torch_port_common import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_KPTS, TOPK, BATCH, EPOCHS, SEED = 12, 66, 4, 2, 0
TRAIN_SEEDS, VAL_SEEDS, N_OBJS = (0, 1, 2, 3), (4, 5, 6, 7), 4
FLAGS = ["--num_kpts", str(N_KPTS), "--topk", str(TOPK), "--batch_size", str(BATCH),
         "--epochs", str(EPOCHS), "--val_every", "1", "--save_every", "1", "--seed", str(SEED)]
# the logs, port against JAX: step 0 from shared weights (measured 3.0e-6,
# depth_MAE) and each epoch's mean (measured 3.9e-6 and 1.5e-5, reg_loss).
# Single later steps are not held: the shipped-width GMW is ill-conditioned
# at random initialisation, and multiplying the port's own initial weights
# by (1 + 1e-7 randn) moves its step losses by up to 1.6e-3 and its epoch
# means by up to 1.3e-4 (two seeds); JAX's steps differ by up to 3.0e-4.
STEP0_REL, EPOCH_REL = 1e-4, 5e-4
# the refined locations of the final validation, of the largest coordinate
# (measured 2.1e-5), as chip_smoke.py holds predict on the card to the CPU
LOC_REL = 1e-4
INIT = "jax_init"


def _objects(seed, rng):
    """One scene's cars as GMW inputs: 12 CAD keypoints in the object frame,
    their projections normalised by the intrinsics (noise 1e-3), the yaw
    with noise 0.05 rad and the location scaled by 1 + 0.05 randn."""
    _, objs, calib = make_scene(seed=seed, num_objs=N_OBJS)
    out = []
    for o in objs:
        kp = o.extra_kpts_3D[:N_KPTS]
        cam = (roty_matrix(o.ry) @ kp.T).T + o.t - np.array([0.0, o.h / 2, 0.0])
        uv, _ = calib.project_rect_to_image(cam)
        k2 = normalize_kpts_2d(uv, calib.P) + rng.randn(N_KPTS, 2) * 1e-3
        out.append(dict(o=o, kpts_2d=k2, kpts_3d=kp, rot=o.ry + 0.05 * rng.randn(),
                        loc=o.t * (1.0 + 0.05 * rng.randn())))
    return out


def write_inputs(work):
    """gen_data_train.json (one batch per train scene), gen_data_infer.json
    (the val scenes' cars as detections) and the KITTI tree."""
    rng = np.random.RandomState(0)
    kitti = work / "kitti"
    write_kitti_tree(str(kitti), train_seeds=TRAIN_SEEDS, val_seeds=VAL_SEEDS, num_objs=N_OBJS)
    tw = GenDataTrainWriter()
    for seed in TRAIN_SEEDS:
        objs = _objects(seed, rng)
        tw.add_batch(np.stack([d["kpts_2d"] for d in objs]), np.stack([d["kpts_3d"] for d in objs]),
                     np.array([d["rot"] for d in objs]), np.stack([d["o"].t for d in objs]),
                     np.stack([d["loc"] for d in objs]), [f"{seed:06d}"] * len(objs))
    tw.dump(str(work / "train.json"))
    iw = GenDataInferWriter()
    for seed in VAL_SEEDS:
        objs = _objects(seed, rng)
        dets = np.array([[0, 0, *d["o"].box2d, d["o"].h, d["o"].w, d["o"].l, *d["loc"], d["rot"],
                          rng.uniform(0.5, 1.0)] for d in objs])
        iw.add_image(f"{seed:06d}", dets, np.ones(len(objs), bool),
                     np.stack([d["kpts_2d"] for d in objs]), np.stack([d["kpts_3d"] for d in objs]))
    iw.dump(str(work / "infer.json"))
    return dict(kitti=str(kitti), train=str(work / "train.json"), val=str(work / "infer.json"))


def _jax_cli():
    spec = importlib_util.spec_from_file_location("jax_train_gmw_cli",
                                                  os.path.join(REPO, "tools", "train_gmw.py"))
    module = importlib_util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _read_txts(d):
    return {f: [line.split() for line in open(os.path.join(d, f)).read().splitlines()]
            for f in sorted(os.listdir(d))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("gmw_cli")
    data = write_inputs(work)
    base = ["--train_data", data["train"], "--val_data", data["val"], "--kitti_path", data["kitti"],
            *FLAGS]

    # JAX: the command line, every step's logs recorded as it runs
    jax_steps = []
    make_step = jax_gmw_train.make_gmw_train_step

    def recording_step(cfg, model):
        inner = make_step(cfg, model)

        def step(state, batch, cls_w, reg_w):
            new, logs = inner(state, batch, cls_w, reg_w)
            jax.debug.callback(lambda l: jax_steps.append({k: float(v) for k, v in l.items()}), logs)
            return new, logs

        return step

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_gmw_train, "make_gmw_train_step", recording_step)
        mp.setattr(sys, "argv", ["train_gmw.py", *base, "--log_dir", str(work / "jax")])
        _jax_cli().main()

    # the port from JAX's initial weights, saved as a checkpoint at epoch 0
    cfg = train_gmw.make_config(train_gmw.parse_args(base))
    n_train = sum(len(b) for b in json.load(open(data["train"]))["img_idx"])
    jcfg = jax_gmw_train.GMWConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    _, jstate = jax_gmw_train.create_gmw_state(jcfg, jax.random.PRNGKey(SEED),
                                               steps_per_epoch=n_train // BATCH)
    model, state = port_gmw_train.create_gmw_state(cfg, device="cpu")
    load_state(model, from_jax_gmw_params(jstate.params))
    Checkpointer(str(work / "port" / "ckpt")).save_gmw(INIT, model, state, epoch=0)

    def port(log_dir, *flags):
        return train_gmw.run(train_gmw.parse_args(
            [*base, "--log_dir", str(work / log_dir), "--device", "cpu", *flags]))

    straight = port("port", "--resume")
    # --resume from the end of epoch 1
    shutil.copytree(work / "port" / "ckpt", work / "resumed" / "ckpt")
    (work / "resumed" / "ckpt" / "last_checkpoint").write_text("checkpoint_epoch_1.pt")
    resumed = port("resumed", "--resume")
    evaluated = port("evaluated", "--evaluate")
    return dict(work=work, data=data, jax_steps=jax_steps, straight=straight, resumed=resumed,
                evaluated=evaluated, n_train=n_train)


def test_the_port_trains_as_jax(runs):
    epochs = runs["straight"]["epochs"]
    steps = [s for e in epochs for s in e["steps"]]
    assert len(steps) == len(runs["jax_steps"]) == EPOCHS * (runs["n_train"] // BATCH)
    assert all(s["seconds"] > 0 for s in steps)
    for k, v in runs["jax_steps"][0].items():
        assert abs(steps[0][k] - v) <= STEP0_REL * abs(v), (k, steps[0][k], v)
    for e in epochs:
        n = len(e["steps"])
        want = runs["jax_steps"][(e["epoch"] - 1) * n:e["epoch"] * n]
        for k in want[0]:
            got_mean, want_mean = np.mean([s[k] for s in e["steps"]]), np.mean([s[k] for s in want])
            assert abs(got_mean - want_mean) <= EPOCH_REL * abs(want_mean), (e["epoch"], k)


def test_refined_txt_files_match_jax(runs):
    got = _read_txts(runs["straight"]["final"]["result_dir"])
    want = _read_txts(runs["work"] / "jax" / "kitti_results_for_eval")
    assert got.keys() == want.keys() == {f"{s:06d}.txt" for s in VAL_SEEDS}
    n = 0
    for f in want:
        assert len(got[f]) == len(want[f]) > 0
        for a, b in zip(got[f], want[f]):
            assert a[:3] == b[:3] and a[4:11] == b[4:11] and a[14:] == b[14:], f  # as the JSON
            loc_a, loc_b = np.array(a[11:14], float), np.array(b[11:14], float)
            np.testing.assert_allclose(loc_a, loc_b, rtol=0, atol=LOC_REL * np.abs(loc_b).max())
            n += 1
    assert n == len(runs["straight"]["final"]["depths"])


def test_checkpoint_names_best_epoch_and_ap_match_jax(runs):
    work = runs["work"]
    jax_names = sorted(p for p in os.listdir(work / "jax" / "ckpt") if p != "last_checkpoint")
    port_names = sorted(p[:-3] for p in os.listdir(work / "port" / "ckpt")
                        if p.endswith(".pt") and p != INIT + ".pt")
    assert port_names == jax_names == ["checkpoint_epoch_1", "checkpoint_epoch_2", "checkpoint_final",
                                       "model_best"]
    jax_best = int(ocp.StandardCheckpointer().restore(str(work / "jax" / "ckpt" / "model_best"))["step"])
    assert runs["straight"]["best_epoch"] == jax_best
    best = torch.load(work / "port" / "ckpt" / "model_best.pt", weights_only=True)
    assert best["epoch"] == jax_best and best["step"] == jax_best * runs["n_train"] // BATCH
    kitti = runs["data"]["kitti"]
    _, ret = jax_evaluate_from_files(os.path.join(kitti, "training", "label_2"),
                                     str(work / "jax" / "kitti_results_for_eval"),
                                     os.path.join(kitti, "training", "ImageSets", "val.txt"),
                                     current_class=0, metric="R40")
    assert {k: float(v) for k, v in ret.items()} == runs["straight"]["final"]["ap"]
    assert runs["straight"]["final"]["metric"] == float(ret[train_gmw.AP_KEY]) > 0


def test_resume_continues_at_the_saved_epoch_with_its_lr(runs):
    straight, resumed = runs["straight"], runs["resumed"]
    assert resumed["start_epoch"] == 1 and [e["epoch"] for e in resumed["epochs"]] == [2]
    assert resumed["epochs"][0]["lr"] == straight["epochs"][1]["lr"] < straight["epochs"][0]["lr"]
    assert resumed["state"].step == straight["state"].step == EPOCHS * runs["n_train"] // BATCH
    # the batch order is drawn anew from --seed: epoch 2 after a resume sees epoch 1's order
    np.testing.assert_array_equal(resumed["epochs"][0]["order"], straight["epochs"][0]["order"])
    final = torch.load(runs["work"] / "resumed" / "ckpt" / "checkpoint_final.pt", weights_only=True)
    assert final["epoch"] == EPOCHS and final["step"] == resumed["state"].step


def test_evaluate_without_training_writes_txts_and_tracks_the_metric(runs):
    ev = runs["evaluated"]
    assert ev["epochs"] == [] and ev["start_epoch"] == 0
    assert sorted(os.listdir(ev["final"]["result_dir"])) == [f"{s:06d}.txt" for s in VAL_SEEDS]
    assert not os.path.exists(runs["work"] / "evaluated" / "ckpt" / "checkpoint_final.pt")
    assert len(ev["final"]["depths"]) == len(runs["straight"]["final"]["depths"]) > 0
    assert ev["final"]["metric"] == ev["final"]["ap"][train_gmw.AP_KEY]


def test_depth_shift_metric_without_labels(runs, tmp_path):
    """Without --kitti_path the metric is the negative mean relative shift
    of the refined depths from the raw ones (JAX's :196-203)."""
    args = train_gmw.parse_args(["--val_data", runs["data"]["val"], "--log_dir", str(tmp_path),
                                 "--device", "cpu", *FLAGS])
    cfg = train_gmw.make_config(args)
    model = runs["straight"]["model"]
    out = train_gmw.run_validation(args, cfg, port_gmw_train.make_gmw_predict(cfg, model),
                                   train_gmw.setup_logger(train_gmw.LOGGER))
    raw = json.load(open(runs["data"]["val"]))
    raw_z = np.array([d["pred_location"][2] for img in raw for d in raw[img]])
    assert "ap" not in out
    np.testing.assert_allclose(out["metric"], -np.mean(np.abs(out["depths"] - raw_z) / raw_z),
                               rtol=1e-6)
    np.testing.assert_array_equal(out["depths"], runs["straight"]["final"]["depths"])


def test_gmw_checkpoint_round_trip(runs, tmp_path):
    """save_gmw / load_gmw: weights, AdamW state, update count and epoch come
    back, and the next step from the restored state is the saved state's
    bitwise."""
    cfg = train_gmw.make_config(train_gmw.parse_args(FLAGS))
    src_model, src_state = copy.deepcopy((runs["straight"]["model"], runs["straight"]["state"]))
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save_gmw("checkpoint_epoch_7", src_model, src_state, epoch=7)
    model, state = port_gmw_train.create_gmw_state(cfg, seed=5, steps_per_epoch=4, device="cpu")
    assert ckpt.load_gmw(model, state) == 7 and state.step == src_state.step
    assert Checkpointer(str(tmp_path / "empty")).load_gmw(model, state) is None
    rng = np.random.RandomState(1)
    batch = {"kpts_2d": (rng.randn(BATCH, N_KPTS, 2) * 0.1).astype(np.float32),
             "kpts_3d": rng.randn(BATCH, N_KPTS, 3).astype(np.float32),
             "pred_rot": rng.randn(BATCH).astype(np.float32),
             "gt_depth": rng.uniform(10, 30, BATCH).astype(np.float32)}
    a = port_gmw_train.make_gmw_train_step(cfg, src_model)(src_state, batch, 1.0, 0.1)
    b = port_gmw_train.make_gmw_train_step(cfg, model)(state, batch, 1.0, 0.1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(p, q) for p, q in zip(src_model.parameters(), model.parameters()))
