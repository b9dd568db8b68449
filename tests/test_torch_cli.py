"""The port's DGDE command line on the CPU, end to end, against the JAX package.

``python -m dcd_tpu_torch.tools.train_dgde`` is run in-process (``run`` on
parsed flags, ``--device cpu``, the working directory a temporary one) at the
small configuration of tests/torch_port_common.py, on a 4 + 4 scene tree from
the port's ``write_kitti_tree``: 1 training iteration, ``--resume`` to 2, and
2 straight in another output (the checkpoints must be bitwise equal); then
``--eval --resume`` and ``--generate_for_GMW --resume``. The eval rows must be
JAX's forward + ``postprocess`` + ``format_kitti_lines`` on the same weights
(the port's state dict through the reference importer) and images, and JAX's
``evaluate_from_files`` on the port's txt files must give the port's
``result.json``. Also: the checkpoint round trip, the reference DGDE and
ImageNet DLA-34 ``.pth`` loaders against JAX's importers, and inconsistent
multi-host flags refused before any rendezvous (``--finetune`` and ``--vis``:
tests/test_torch_finetune.py; several processes: tests/test_torch_parallel_cli.py).
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcd_tpu.engine.infer import format_kitti_lines as jax_format_kitti_lines
from dcd_tpu.engine.infer import postprocess as jax_postprocess
from dcd_tpu.evaluation import evaluate_from_files as jax_evaluate_from_files
from dcd_tpu.utils.checkpoint import import_torch_dgde, import_torch_dla34
from dcd_tpu_torch.data.gen_data import load_gen_data_infer, load_gen_data_train
from dcd_tpu_torch.data.kitti_dataset import KITTIDataset
from dcd_tpu_torch.data.synthetic import write_kitti_tree
from dcd_tpu_torch.engine.infer import build_detector
from dcd_tpu_torch.engine.train import build_trainer
from dcd_tpu_torch.tools import train_dgde
from dcd_tpu_torch.utils.checkpoint import Checkpointer, load_torch_dgde, load_torch_dla34
from dcd_tpu_torch.utils.weights import from_jax_variables, load_state
from dcd_tpu_torch.utils.writer import MetricWriter
from torch_port_common import CHANNELS, HEAD_CHANNELS, HEIGHT, WIDTH, numpy_variables, small_configs

# Threshold 0 and no uncertainty as confidence: every one of the 50 top-K rows
# is valid and compared. (With flax's initialisation the depth uncertainty
# after two iterations gives every row a confidence of 0, in both packages.)
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
TEST:
  DETECTIONS_THRESHOLD: 0.0
  UNCERTAINTY_AS_CONFIDENCE: false
"""
TRAIN_SEEDS, VAL_SEEDS = (0, 1, 2, 3), (4, 5, 6, 7)


def _state(path):
    return torch.load(path, map_location="cpu", weights_only=True)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file: the small model's many small ops
    gain nothing from more, and when other test processes keep the cores
    busy the pool's threads slow the CLI runs about tenfold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """Every run of the twin, in one working directory."""
    work = tmp_path_factory.mktemp("cli")
    data_root = write_kitti_tree(str(work / "kitti"), train_seeds=TRAIN_SEEDS,
                                 val_seeds=VAL_SEEDS, num_objs=4, image_size=(120, 60))
    (work / "small.yaml").write_text(SMALL_YAML)

    def run(output, *flags):
        return train_dgde.run(train_dgde.parse_args(
            ["--device", "cpu", "--config", str(work / "small.yaml"), "--data_root", data_root,
             "--output", str(work / output), *flags]))

    here = os.getcwd()
    with pytest.MonkeyPatch.context() as mp:
        # TensorBoard's import can pull in TensorFlow and take seconds; the
        # twin writes metrics.jsonl either way
        mp.setattr(train_dgde, "MetricWriter", functools.partial(MetricWriter, use_tensorboard=False))
        os.chdir(work)
        try:
            out = dict(
                first=run("logs", "--num_iters", "1"),
                resumed=run("logs", "--num_iters", "2", "--resume"),
                straight=run("straight", "--num_iters", "2"),
                eval=run("logs", "--eval", "--resume"),
                gen=run("logs", "--generate_for_GMW", "--resume"),
            )
        finally:
            os.chdir(here)
    return dict(out, work=work, data_root=data_root)


def test_cli_trains_logs_and_checkpoints(cli):
    assert [it["iteration"] for it in cli["first"]["iterations"]] == [0]
    assert [it["iteration"] for it in cli["resumed"]["iterations"]] == [1]
    for it in cli["first"]["iterations"] + cli["straight"]["iterations"]:
        assert all(np.isfinite(v) for v in it["logs"].values())
        assert it["time"] >= it["data"] >= 0
    logs = cli["work"] / "logs"
    assert (logs / "ckpt" / "last_checkpoint").read_text() == "model_final.pt"
    assert "iter 0/1" in (logs / "log.txt").read_text()
    rows = [json.loads(line) for line in (logs / "writer" / "metrics.jsonl").read_text().splitlines()]
    assert rows[0]["step"] == 0 and np.isfinite(rows[0]["train/total_loss"])


def test_cli_resume_is_bitwise_two_straight_iterations(cli):
    """1 iteration, ``--resume``, 1 more: the parameters, BN buffers, AdamW
    state and update count of 2 straight, bitwise."""
    a = _state(cli["work"] / "logs" / "ckpt" / "model_final.pt")
    b = _state(cli["work"] / "straight" / "ckpt" / "model_final.pt")
    assert a["step"] == b["step"] == 2
    assert a["model"].keys() == b["model"].keys()
    for k in b["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys() and len(sb) == len(list(cli["straight"]["trainer"].model.parameters()))
    for i in sb:
        for k in sb[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert cli["first"]["iterations"][0]["logs"] == cli["straight"]["iterations"][0]["logs"]
    assert cli["resumed"]["iterations"][0]["logs"] == cli["straight"]["iterations"][1]["logs"]


def test_checkpoint_round_trip_is_bitwise(cli, tmp_path):
    """model_final into a trainer from another seed, saved again: the same
    tensors and count; ``model_only`` keeps the trainer's optimizer."""
    tcfg = cli["straight"]["trainer"].cfg
    trainer = build_trainer(tcfg, device="cpu", seed=5)
    ckpt = Checkpointer(str(cli["work"] / "straight" / "ckpt"))
    assert ckpt.load(trainer) and trainer.optimizer.count == 2
    again = _state(Checkpointer(str(tmp_path)).save("model_checkpoint_1", trainer))
    want = _state(cli["work"] / "straight" / "ckpt" / "model_final.pt")
    assert again["step"] == want["step"]
    for k in want["model"]:
        assert torch.equal(again["model"][k], want["model"][k]), k
    for i, st in want["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(again["optimizer"]["state"][i][k], v), (i, k)
    fresh = build_trainer(tcfg, device="cpu", seed=5)
    assert ckpt.load(fresh, "model_final", model_only=True)
    assert fresh.optimizer.count == 0 and not fresh.optimizer.adamw.state
    for k, v in want["model"].items():
        assert torch.equal(fresh.model.state_dict()[k], v), k


def test_checkpointer_keeps_max_to_keep(cli, tmp_path):
    trainer = cli["straight"]["trainer"]
    ckpt = Checkpointer(str(tmp_path), max_to_keep=2)
    for n in (1, 2, 3, 10):
        ckpt.save(f"model_checkpoint_{n}", trainer)
    ckpt.save("model_final", trainer)
    assert sorted(os.listdir(tmp_path)) == ["last_checkpoint", "model_checkpoint_10.pt",
                                            "model_checkpoint_3.pt", "model_final.pt"]


def test_cli_eval_writes_a_txt_per_val_image_and_result_json(cli):
    ev = cli["eval"]
    assert ev["images"] == len(VAL_SEEDS) and ev["images_per_s"] > 0
    assert sorted(os.listdir(ev["out_dir"])) == [f"{s:06d}.txt" for s in VAL_SEEDS]
    with open(cli["work"] / "logs" / "inference" / "result.json") as f:
        assert json.load(f) == ev["ap"]
    assert "Car_3d_moderate_R40_0.70" in ev["ap"]


@pytest.fixture(scope="module")
def jax_rows(cli):
    """JAX's forward + postprocess at batch 1 on the port's trained weights
    and the port's val samples (one compiled function)."""
    jcfg, _ = small_configs()
    trainer = cli["eval"]["trainer"]
    tcfg = trainer.cfg
    jcfg = dataclasses.replace(jcfg, test=dataclasses.replace(
        jcfg.test, detections_threshold=0.0, uncertainty_as_confidence=False))
    jmodel, template = numpy_variables(jcfg)
    sd = {k: v.numpy() for k, v in trainer.model.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    params, stats = import_torch_dgde(sd, template, jcfg)

    def up_kernels(path, leaf):
        # the importer leaves the bilinear ``up_k`` kernels to the template
        names = [getattr(p, "key", str(p)) for p in path]
        if any(n.startswith("up_") for n in names):
            return np.transpose(sd[".".join(names[:-1]) + ".weight"], (2, 3, 1, 0))
        return leaf

    variables = {"params": jax.tree_util.tree_map_with_path(up_kernels, params),
                 "batch_stats": stats}

    @jax.jit
    def forward(v, images, ei, el, P, pad, size):
        preds = jmodel.apply(v, images, ei, el, train=False, lazy_topk=jcfg.test.lazy_reg_heads)
        return jax_postprocess(jcfg, preds, P, pad, size)

    ds = KITTIDataset(tcfg, cli["data_root"], is_train=False, augment=False)
    out = []
    for i in range(len(ds)):
        s = ds.get_sample(i)
        t = s.targets
        rows = forward(variables, jnp.asarray(s.image[None]), t["edge_indices"][None],
                       t["edge_len"][None], *(np.asarray(t[k][None], np.float32)
                                               for k in ("calib_P_full", "pad_size", "image_size")))
        out.append((s, jax.tree.map(np.asarray, rows)))
    return out


def test_cli_eval_rows_match_jax(cli, jax_rows):
    trainer = cli["eval"]["trainer"]
    n_lines = 0
    for s, want in jax_rows:
        got = train_dgde._infer_sample(trainer.cfg, trainer.model, s)
        np.testing.assert_allclose(got["dets"], want["dets"], rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(got["valid"], want["valid"])
        lines = open(os.path.join(cli["eval"]["out_dir"], f"{s.img_id}.txt")).read().splitlines()
        jlines = jax_format_kitti_lines(want["dets"][0], want["valid"][0])
        assert len(lines) == len(jlines) == int(want["valid"].sum()) > 0
        # 2 decimals: one ulp may flip a printed digit, so compare as numbers
        for a, b in zip(lines, jlines):
            a, b = a.split(), b.split()
            assert a[:3] == b[:3]
            np.testing.assert_allclose(np.array(a[3:], float), np.array(b[3:], float), atol=0.0101)
        n_lines += len(lines)
    assert n_lines > len(jax_rows)  # threshold 0: most of the 50 rows per image


def test_jax_evaluator_on_the_port_txt_gives_the_port_result(cli):
    root = cli["data_root"]
    _, ret = jax_evaluate_from_files(os.path.join(root, "label_2"), cli["eval"]["out_dir"],
                                     os.path.join(root, "ImageSets", "val.txt"),
                                     current_class=["Car"], metric="R40")
    assert {k: float(v) for k, v in ret.items()} == cli["eval"]["ap"]


def test_cli_generate_for_gmw_writes_both_jsons(cli):
    gen = cli["gen"]
    assert gen["train_json"] == str(cli["work"] / "gen_data" / "gen_data_train.json")
    trainer = gen["trainer"]
    ds = KITTIDataset(trainer.cfg, cli["data_root"], is_train=True, augment=False)
    n_obj = sum(int(ds.get_sample(i).targets["reg_mask"].sum()) for i in range(len(ds)))
    data = load_gen_data_train(gen["train_json"], trainer.cfg.model.head.num_kpts)
    assert len(data["kpts_2d"]) == n_obj > 0
    assert all(np.isfinite(v).all() for v in data.values())
    arrays, img_idx = load_gen_data_infer(gen["infer_json"], trainer.cfg.model.head.num_kpts)
    n_valid = sum(sum(1 for line in open(os.path.join(cli["eval"]["out_dir"], t)) if line.strip())
                  for t in os.listdir(cli["eval"]["out_dir"]))
    assert len(img_idx) == n_valid > 0  # the eval's rows: same weights, same threshold
    assert all(np.isfinite(v).all() for v in arrays.values())


@pytest.mark.parametrize("flags", [["--num_processes", "2"],
                                   ["--coordinator", "localhost:1234", "--num_processes", "2",
                                    "--process_id", "2"]])
def test_cli_rejects_inconsistent_multihost_flags(flags, monkeypatch):
    def no_rendezvous(*args, **kwargs):
        raise AssertionError("the flags were not checked before the rendezvous")

    monkeypatch.setattr(train_dgde, "initialize_distributed", no_rendezvous)
    with pytest.raises(ValueError, match="--coordinator|--process_id"):
        train_dgde.run(train_dgde.parse_args(["--device", "cpu", *flags]))


def test_cli_refuses_an_orbax_checkpoint_and_a_missing_card(cli, monkeypatch, tmp_path):
    (tmp_path / "ckpt" / "model_final").mkdir(parents=True)  # orbax writes a directory
    base = ["--config", str(cli["work"] / "small.yaml"), "--data_root", cli["data_root"],
            "--output", str(tmp_path)]
    with pytest.raises(NotImplementedError, match="orbax"):
        train_dgde.run(train_dgde.parse_args(["--device", "cpu", *base, "--ckpt", "model_final"]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_dgde.run(train_dgde.parse_args([*base, "--eval"]))


def test_reference_dgde_pth_loads_as_is(cli, tmp_path):
    """A reference DGDE checkpoint ({"model": ...}, a DataParallel prefix, BN
    counters) loads into the port unchanged, and the reference importer of
    the JAX package reads the same file into the same weights."""
    src = cli["eval"]["trainer"].model.state_dict()
    torch.save({"model": {"module." + k: v for k, v in src.items()}, "iteration": 2},
               tmp_path / "dgde.pth")
    model = build_detector(cli["eval"]["trainer"].cfg, device="cpu", seed=9)
    load_torch_dgde(model, str(tmp_path / "dgde.pth"))
    for k, v in src.items():
        assert torch.equal(model.state_dict()[k], v) or k.endswith("num_batches_tracked"), k


def test_dla34_pth_loader_matches_jax_importer(tmp_path):
    """An ImageNet DLA-34 .pth written here (trunk names of the reference
    ``dla34``, plus its classifier): the port's trunk loader gives the
    weights that JAX's ``import_torch_dla34`` gives, carried by
    ``from_jax_variables``; everything outside the trunk stays."""
    jcfg, tcfg = small_configs()
    _, variables = numpy_variables(jcfg, seed=3)
    model = build_detector(tcfg, device="cpu")
    load_state(model, from_jax_variables(variables, tcfg))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.RandomState(4)
    trunk = {k[len("backbone.base."):]: torch.from_numpy(rng.randn(*v.shape).astype(np.float32))
             for k, v in before.items()
             if k.startswith("backbone.base.") and not k.endswith("num_batches_tracked")}
    torch.save({**trunk, "fc.weight": torch.zeros(1000, CHANNELS[-1], 1, 1),
                "fc.bias": torch.zeros(1000)}, tmp_path / "dla34.pth")
    assert load_torch_dla34(model, str(tmp_path / "dla34.pth")) == len(trunk)
    params, stats = import_torch_dla34({k: v.numpy() for k, v in trunk.items()}, variables)
    want = from_jax_variables({"params": params, "batch_stats": stats}, tcfg)
    got = model.state_dict()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
        if not k.startswith("backbone.base."):
            assert torch.equal(got[k], before[k]), k
    # build_trainer loads it from cfg.model.pretrain_path
    cfg = dataclasses.replace(tcfg, model=dataclasses.replace(
        tcfg.model, pretrain=True, pretrain_path=str(tmp_path / "dla34.pth")))
    trainer = build_trainer(cfg, device="cpu")
    for k, v in trunk.items():
        assert torch.equal(trainer.model.state_dict()["backbone.base." + k], v), k
