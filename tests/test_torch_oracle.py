"""The port's twins of three JAX tools against the tools themselves.

* ``dcd_tpu_torch/tools/oracle_inject.py``: the oracle's head outputs equal
  the JAX tool's bitwise (same targets, same noise draws, same scores), and
  the sweep through the port's ``postprocess`` and evaluator gives the JAX
  tool's table at 0 and 1 px on the same held-out scenes.
* ``dcd_tpu_torch/tools/convergence_run.py``: the first encoded batch of its
  pool equals the JAX tool's bitwise, and a two-step CPU run on a small
  configuration trains in bf16 and writes its JSONL and table.
* ``dcd_tpu_torch/tools/offset_stats.py``: ``report`` gives the JAX tool's
  rows on the same offsets, and ``collect_offsets`` records each DCN's
  offsets before the clip.
"""

import json
import os
from importlib import util as importlib_util

import numpy as np
import torch

from dcd_tpu.config import dgde_run_config as jax_dgde_run_config
from dcd_tpu.data import synthetic as jax_synthetic
from dcd_tpu.data.target_encoder import collate as jax_collate
from dcd_tpu.data.target_encoder import encode_targets as jax_encode_targets
from dcd_tpu_torch.config import dgde_run_config
from dcd_tpu_torch.data import synthetic
from dcd_tpu_torch.data.target_encoder import encode_targets
from dcd_tpu_torch.models.detector import KeypointDetector
from dcd_tpu_torch.models.layers import DCN
from dcd_tpu_torch.tools import convergence_run, offset_stats, oracle_inject
from torch_port_common import one_torch_thread, small_configs  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    spec = importlib_util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib_util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_oracle_predictions_are_jax_s():
    """The head outputs of one scene at 1 px of noise: bitwise the JAX
    tool's, from each package's own targets and the same draws."""
    jax_tool = _jax_tool("oracle_inject")
    jcfg, cfg = jax_dgde_run_config(), dgde_run_config()
    scene = dict(seed=10_000, num_objs=8)
    want, jn, js = jax_tool.build_oracle_predictions(
        jcfg, jax_encode_targets(*jax_synthetic.make_scene(**scene), jcfg), 1.0,
        np.random.RandomState(17))
    got, n, skipped = oracle_inject.build_oracle_predictions(
        cfg, encode_targets(*synthetic.make_scene(**scene), cfg), 1.0, np.random.RandomState(17))
    assert (n, skipped) == (jn, js) and n >= 6
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_oracle_sweep_matches_jax():
    """The sweep of two held-out scenes at 0 and 1 px: the port's rows equal
    the JAX tool's (AP to the last digit), AP at zero noise is the bbox
    ceiling in every column, and noise lowers 3D@0.7."""
    kw = dict(noise_levels=[0.0, 1.0], n_scenes=2)
    want = _jax_tool("oracle_inject").run_sweep(**kw)
    dets = []
    got = oracle_inject.run_sweep(**kw, device="cpu", detections=dets)
    assert got == want
    z = got[0]
    assert z["ap_bbox"] > 0 and all(z[k] == z["ap_bbox"] for k in z if k.startswith("ap_"))
    assert got[-1]["ap_3d_07"] < z["ap_3d_07"]
    # peaks of two objects on one heat-map pixel collide, as in JAX's tool
    assert len(dets) == 4 and 0 < sum(int(d[3].sum()) for d in dets[:2]) <= z["n_obj"]


def test_convergence_pool_is_jax_s():
    """The first batch of the pool, as the JAX tool encodes and collates it
    (make_scene(seed=s, num_objs=8), dgde_run_config), bitwise."""
    jcfg = jax_dgde_run_config()
    want = jax_collate([jax_encode_targets(*jax_synthetic.make_scene(seed=s, num_objs=8), jcfg,
                                           img_id=f"{s:06d}") for s in range(2)])
    got = convergence_run.make_batches(convergence_run.run_config(), 2, 2)[0]
    assert set(got) == {k for k, v in want.items() if not isinstance(v, list)}
    for k, v in got.items():
        assert v.dtype == want[k].dtype, k
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_convergence_run_two_steps_on_the_cpu(tmp_path):
    """Two bf16 steps of the small configuration with an evaluation at each
    end: finite losses, the JSONL rows of both steps and of both
    evaluations, the table, and the checkpoint."""
    _, small = small_configs()
    cfg = convergence_run.run_config(base=small)
    assert cfg.model.fp16 and not cfg.model.pretrain and cfg.solver.base_lr == 3e-4
    args = convergence_run.parse_args([
        "--steps", "2", "--batch", "2", "--pool", "2", "--log_every", "1", "--eval_every", "2",
        "--val_scenes", "1", "--depth_modes", "edges,soft", "--device", "cpu",
        "--save_ckpt", str(tmp_path / "ckpt"), "--out_md", str(tmp_path / "conv.md"),
        "--out_jsonl", str(tmp_path / "curve.jsonl")])
    out = convergence_run.run(args, cfg, image_size=(120, 60), depth_range=(6.0, 20.0))
    assert [r["step"] for r in out["hist"]] == [0, 1]
    assert all(np.isfinite(r["total_loss"]) for r in out["hist"])
    assert [r["step"] for r in out["ap"]] == [0, 2] and "ap_3d_mod_07_soft" in out["ap"][0]
    rows = [json.loads(line) for line in (tmp_path / "curve.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 1, 0, 2] and "total_loss" in rows[0]
    assert "ap/ap_bbox_mod" in rows[2]
    assert "| total_loss |" in (tmp_path / "conv.md").read_text()
    saved = torch.load(tmp_path / "ckpt" / "model_final.pt", weights_only=True)
    assert int(saved["step"]) == 2 and saved["model"].keys() == out["trainer"].model.state_dict().keys()


def test_offset_report_matches_jax():
    rng = np.random.RandomState(3)
    offsets = {f"m{i}": (rng.randn(2, 5, 7, 18) * s).astype(np.float32)
               for i, s in enumerate((0.5, 1.5, 3.0))}
    got = offset_stats.report(offsets)
    want = _jax_tool("offset_stats").report(offsets)
    assert got == want and got[2]["frac>|3|"] > 0


def test_collect_offsets_records_every_dcn_before_the_clip():
    """One entry per DCN of the small detector, (B, H, W, 18), equal to the
    first 18 channels of its offset conv's output (no clip), with the model
    back in train mode after."""
    _, cfg = small_configs()
    torch.manual_seed(0)
    model = KeypointDetector(cfg).train()
    dcns = {n: m for n, m in model.named_modules() if isinstance(m, DCN)}
    with torch.no_grad():
        for m in dcns.values():
            m.conv_offset_mask.bias.normal_(0, 4.0)  # beyond the radius
    raw = {}
    hooks = [m.conv_offset_mask.register_forward_hook(
        lambda _m, _i, o, n=n: raw.__setitem__(n, o[:, :18].permute(0, 2, 3, 1).numpy()))
        for n, m in dcns.items()]
    images = torch.randn(1, cfg.input.height_train, cfg.input.width_train, 3)
    got = offset_stats.collect_offsets(model, images, None, None)
    for h in hooks:
        h.remove()
    assert model.training and set(got) == set(dcns) == set(raw)
    for n, v in got.items():
        np.testing.assert_array_equal(v, raw[n])
    assert max(np.abs(v).max() for v in got.values()) > cfg.model.backbone.dcn_radius
