"""``--finetune`` and ``--vis`` of the port's DGDE command line on the CPU.

``train_dgde.run`` at the small configuration of tests/torch_port_common.py
on a 4 + 4 scene tree: 1 iteration, then ``--finetune`` of its
``model_final`` for 2 iterations with the backbone frozen through a YAML: the
backbone's parameters bitwise those of the file, the heads' and the
backbone's BN statistics moved, the update count restarted, AdamW state for
the heads' parameters only, the frozen DCN blocks' gradients computed. Then
``--eval --resume --vis 2``: two panels, each the eval's rows and the ground
truth drawn as the JAX package draws them. (The optimizer with frozen names
and the clip against optax: tests/test_torch_train.py.)
"""

import functools
import os

import numpy as np
import pytest
import torch
from PIL import Image

from dcd_tpu.data.kitti_geometry import Calibration as JaxCalibration
from dcd_tpu.utils import visualize as jax_vis
from dcd_tpu_torch.data.kitti_dataset import KITTIDataset, _load_image
from dcd_tpu_torch.data.synthetic import write_kitti_tree
from dcd_tpu_torch.models.layers import DCN
from dcd_tpu_torch.tools import train_dgde
from dcd_tpu_torch.utils.writer import MetricWriter
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
TEST:
  DETECTIONS_THRESHOLD: 0.0
"""
FREEZE_YAML = SMALL_YAML.replace("MODEL:\n", "MODEL:\n  FREEZE_NAMES: [backbone]\n")
TRAIN_SEEDS, VAL_SEEDS, IMAGE_SIZE = (0, 1, 2, 3), (4, 5, 6, 7), (120, 60)
FINETUNE_ITERS, N_VIS = 2, 2


def _state(path):
    return torch.load(path, map_location="cpu", weights_only=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("finetune")
    data_root = write_kitti_tree(str(work / "kitti"), train_seeds=TRAIN_SEEDS, val_seeds=VAL_SEEDS,
                                 num_objs=4, image_size=IMAGE_SIZE)
    (work / "small.yaml").write_text(SMALL_YAML)
    (work / "freeze.yaml").write_text(FREEZE_YAML)

    def run(config, output, *flags):
        return train_dgde.run(train_dgde.parse_args(
            ["--device", "cpu", "--config", str(work / config), "--data_root", data_root,
             "--output", str(work / output), *flags]))

    with pytest.MonkeyPatch.context() as mp:
        # TensorBoard's import can pull in TensorFlow and take seconds
        mp.setattr(train_dgde, "MetricWriter", functools.partial(MetricWriter, use_tensorboard=False))
        first = run("small.yaml", "logs", "--num_iters", "1")
        source = str(work / "logs" / "ckpt" / "model_final.pt")
        finetuned = run("freeze.yaml", "ft", "--num_iters", str(FINETUNE_ITERS), "--finetune", source)
        vis = run("small.yaml", "logs", "--eval", "--resume", "--vis", str(N_VIS))
    return dict(work=work, data_root=data_root, first=first, finetuned=finetuned, vis=vis,
                source=source)


def test_finetune_freezes_the_backbone_and_restarts_the_count(runs):
    src = _state(runs["source"])
    out = _state(runs["work"] / "ft" / "ckpt" / "model_final.pt")
    assert src["step"] == 1 and out["step"] == FINETUNE_ITERS
    its = runs["finetuned"]["iterations"]
    assert [it["iteration"] for it in its] == list(range(FINETUNE_ITERS))
    model = runs["finetuned"]["trainer"].model
    params = dict(model.named_parameters())
    heads_moved, heads_idle, bn_moved = 0, 0, 0
    for k, v in out["model"].items():
        if k in params and k.startswith("backbone."):
            assert torch.equal(v, src["model"][k]), k
        elif k in params:
            if torch.equal(v, src["model"][k]):
                # a parameter without a gradient (no truncated object: the
                # truncation head) stays: decay alone moves it by ~1e-10
                assert not params[k].grad.any(), k
                heads_idle += 1
            else:
                heads_moved += 1
        elif k.startswith("backbone.") and k.endswith(("running_mean", "running_var")):
            bn_moved += not torch.equal(v, src["model"][k])
    n_heads = sum(1 for k in params if not k.startswith("backbone."))
    n_bn = sum(1 for k in out["model"] if k.startswith("backbone.") and k.endswith("running_mean"))
    # the heads learn; every backbone BN's statistics move in train mode
    assert heads_moved + heads_idle == n_heads and heads_moved > 0.8 * n_heads
    assert bn_moved == 2 * n_bn > 0
    assert len(out["optimizer"]["state"]) == n_heads
    # the frozen parameters still receive gradients, as in JAX, where the
    # optimizer zeroes their updates: the DCN backward runs in every block
    dcns = [m for m in model.backbone.modules() if isinstance(m, DCN)]
    assert len(dcns) == 16
    assert all(m.weight.grad.any() and m.conv_offset_mask.weight.grad.any() for m in dcns)


def test_vis_writes_the_panels_jax_draws(runs):
    vis = runs["vis"]["vis"]
    assert [os.path.basename(p) for p in vis] == [f"{s:06d}.png" for s in VAL_SEEDS[:N_VIS]]
    assert sorted(os.listdir(runs["work"] / "logs" / "vis")) == sorted(os.path.basename(p) for p in vis)
    trainer = runs["vis"]["trainer"]
    ds = KITTIDataset(trainer.cfg, runs["data_root"], is_train=False, augment=False)
    for i, path in enumerate(vis):
        s = ds.get_sample(i)
        rows = train_dgde._infer_sample(trainer.cfg, trainer.model, s)
        rgb = _load_image(os.path.join(ds.image_dir, f"{s.img_id}.png"))
        want = jax_vis.render_scene(rgb, rows["dets"][0], rows["valid"][0], JaxCalibration(s.calib.P),
                                    gt_rows=jax_vis.gt_rows_from_objects(ds._load_objects(s.img_id)))
        got = np.asarray(Image.open(path))
        # the frame and the bird's-eye panel scaled to the frame's height
        assert got.shape == (IMAGE_SIZE[1], IMAGE_SIZE[0] + IMAGE_SIZE[1], 3)
        np.testing.assert_array_equal(got, want)
