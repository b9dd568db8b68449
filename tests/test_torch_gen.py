"""The port's top-k, generate-for-GMW step and gen_data interchange against
the JAX package's, and the port's two stages end to end, fp32 on the CPU.

* top-k: ``topk_like_jax`` and its three sites (``select_topk`` twice and
  ``decode_pairs_kpts_depth(training=True)``) give ``jax.lax.top_k``'s
  indices where values tie: on the committed fixture's quantised
  keypoints and on a heat map with a plateau and fewer peaks than K;
* ``make_gen_step`` on the small DGDE configuration of
  ``torch_port_common`` and shared weights: all six fields <= 1e-4 of
  their scale;
* the writers' JSON text identical to JAX's, and the loaders' arrays equal,
  on the committed files and on an infer file with objects;
* the slice: gen step -> train JSON -> GMW train steps, and infer -> infer
  JSON -> GMW predict -> rescale, in both packages
  (tests/test_e2e_pipeline.py::test_full_pipeline runs it for JAX).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcd_tpu.data import gen_data as jax_gen_data
from dcd_tpu.data import synthetic
from dcd_tpu.data.target_encoder import collate, encode_targets
from dcd_tpu.engine import gmw_train as jax_gmw_train
from dcd_tpu.engine.gen import make_gen_step as jax_make_gen_step
from dcd_tpu.engine.infer import postprocess as jax_postprocess
from dcd_tpu.ops import codec as jax_codec
from dcd_tpu.ops import nms as jax_nms
from dcd_tpu_torch.data import gen_data as port_gen_data
from dcd_tpu_torch.engine import gmw_train as port_gmw_train
from dcd_tpu_torch.engine.gen import make_gen_step
from dcd_tpu_torch.engine.infer import infer
from dcd_tpu_torch.models.detector import KeypointDetector
from dcd_tpu_torch.models.layers import DCN
from dcd_tpu_torch.ops import codec as port_codec
from dcd_tpu_torch.ops.nms import select_topk, topk_like_jax
from dcd_tpu_torch.utils.weights import from_jax_gmw_params, from_jax_variables, load_state
from torch_port_common import calibrated_variables, one_torch_thread, small_configs  # noqa: F401

TRAIN_JSON = "gen_data/gen_data_train.json"
INFER_JSON = "gen_data/gen_data_infer.json"
REL = 1e-4
# The predicted location's depth is the mean of 1500 edge depths |dH|/|dy|,
# which small |dy| make ill-conditioned: the keypoints differ from JAX's by
# ~1e-5 of scale, and one object's location then by 5.1e-2 m (1.26e-3 of
# the largest coordinate), where multiplying JAX's keypoints by
# (1 + 1e-6 randn) moves it by 5.2e-2 m in the port's decode, which on
# JAX's own keypoints gives JAX's depths exactly.
PAIR_LOC_REL = 2e-3
# The slice's refined depths are as ill-conditioned: the GMW's top-64 edge
# set (and so a refined depth) can flip on a rounding-size change. Measured
# with tests/conditioning_probe.py on JAX's own chain (6 draws each): one
# against eight XLA threads moves no object by over 1e-4 of the scale
# (2.2e-4 m at most); every weight times (1 + 1e-7 randn) moves up to one
# object by up to 0.214 m, 5.2e-3 of the scale, the rest under 1e-4; the
# images times (1 + 1e-6 randn) move 3-10 objects by up to 0.648 m, 2.2e-2.
# The port on one intra-op thread parts from JAX by the same 0.214 m at one
# object. So every matched object but SLICE_FLIPS is held to 1e-4 of the
# scale, and those to SLICE_FLIP_REL, twice the weight perturbation's reach.
SLICE_FLIPS = 1
SLICE_FLIP_REL = 1e-2
B = 2


def _close(got, want, rel, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= rel * scale + 1e-12, f"{name}: max abs err {err} vs scale {scale}"


# ------------------------------------------------------------------ top-k


def test_topk_like_jax_breaks_ties_as_jax():
    x = np.array([1, 2, 2, 2, 0, 2, 3], np.float32)
    values, indices = topk_like_jax(torch.from_numpy(x), 3)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 3)
    assert indices.tolist() == np.asarray(ji).tolist() == [6, 1, 2]
    np.testing.assert_array_equal(values.numpy(), np.asarray(jv))
    rounded = np.round(np.random.RandomState(0).rand(4, 2628) * 50).astype(np.float32)
    got = topk_like_jax(torch.from_numpy(rounded), 1500)
    want = jax.lax.top_k(jnp.asarray(rounded), 1500)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    middle = topk_like_jax(torch.from_numpy(rounded.T.copy()), 7, dim=0)[1]
    np.testing.assert_array_equal(middle.numpy().T, np.asarray(jax.lax.top_k(jnp.asarray(rounded), 7)[1]))


def test_pair_depths_pick_jax_edges_where_dy_ties():
    """``decode_pairs_kpts_depth(training=True)`` on the first 8 objects of
    the committed train fixture, turned back into pixels with the KITTI
    intrinsics: each has pairs that tie at the 1500th largest |dy|."""
    data = port_gen_data.load_gen_data_train(TRAIN_JSON)
    P = synthetic.KITTI_P2.astype(np.float32)
    kn = data["kpts_2d"][:8]
    px = np.stack([kn[..., 0] * P[0, 0] + P[0, 2], kn[..., 1] * P[1, 1] + P[1, 2]], -1)
    args = (px.astype(np.float32), data["kpts_3d"][:8], data["pred_rot"][:8, 0],
            np.tile(P[None], (8, 1, 1)))
    got, _ = port_codec.decode_pairs_kpts_depth(*map(torch.from_numpy, args), training=True)
    want, _ = jax.jit(lambda *a: jax_codec.decode_pairs_kpts_depth(*a, training=True))(
        *map(jnp.asarray, args))
    _close(got.numpy(), want, 1e-6, "pair depths")
    dy = np.abs(px[:, :, None, 1] - px[:, None, :, 1])
    iu = np.triu_indices(px.shape[1], 1)
    kth = np.sort(dy[:, iu[0], iu[1]], axis=1)[:, -1500]
    assert all((dy[b][iu] == kth[b]).sum() > 1 for b in range(8))  # ties at the cut


def test_select_topk_on_a_plateau_matches_jax():
    """Two peaks on a 1e-4 floor (the clamp of ``sigmoid_hm``) and K = 10:
    rows 3-10 are filled from the plateau, in JAX's order."""
    hm = np.full((2, 12, 16, 3), 1e-4, np.float32)
    hm[0, 3, 4, 1], hm[0, 7, 9, 0] = 0.9, 0.6
    hm[1, 5, 5, 2] = 0.7
    hm[1, 0:2, 0:3, 0] = 0.0  # NMS zeros
    got = select_topk(torch.from_numpy(hm), K=10)
    want = jax.jit(lambda h: jax_nms.select_topk(h, K=10))(jnp.asarray(hm))
    for g, w, name in zip(got, want, ("scores", "index", "class", "y", "x")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


# ------------------------------------------------------- gen step, JSON


def _batch(cfg, seeds):
    samples = [encode_targets(*synthetic.make_scene(seed=s, num_objs=3, image_size=(120, 60),
                                                   depth_range=(6.0, 20.0)), cfg, img_id=f"{s:06d}")
               for s in seeds]
    return samples, collate(samples)


class _Forward:
    """A stand-in for the JAX model whose ``apply`` returns a forward
    already traced."""

    def __init__(self, preds):
        self.preds = preds

    def apply(self, *args, **kwargs):
        return self.preds


@pytest.fixture(scope="module")
def pair():
    """Both packages' gen steps on one batch from shared weights (BN
    statistics calibrated on the batch), and both packages' inference rows
    at detection threshold 0."""
    jcfg, tcfg = small_configs()
    samples, batch = _batch(jcfg, range(B))
    assert batch["reg_mask"].sum() >= 4
    ei, el = batch["edge_indices"], batch["edge_len"]
    jmodel, variables = calibrated_variables(jcfg, tcfg, batch["images"].astype(np.float32),
                                             ei, el, seed=4)
    def zero_threshold(cfg):
        return dataclasses.replace(cfg, test=dataclasses.replace(cfg.test, detections_threshold=0.0))

    jcfg0, tcfg0 = zero_threshold(jcfg), zero_threshold(tcfg)
    post = [batch[k] for k in ("calib_P_full", "pad_size", "image_size")]

    # one traced forward for both (tracing the model costs most of the
    # compile): the gen step's eval-mode forward, and the rows from its
    # dense map, which equal the lazy path's at the peaks
    @jax.jit
    def jax_side(v, b, *post):
        preds = jmodel.apply(v, b["images"], b["edge_indices"], b["edge_len"], train=False)
        gen = jax_make_gen_step(jcfg, _Forward(preds))(v["params"], v["batch_stats"], b)
        return gen, jax_postprocess(jcfg0, preds, *post)

    jout, jrows = jax_side(variables, {k: jnp.asarray(v) for k, v in batch.items()},
                           *map(jnp.asarray, post))
    jout = {k: np.asarray(v) for k, v in jout.items()}

    model = KeypointDetector(tcfg).eval()
    load_state(model, from_jax_variables(variables, tcfg))
    offsets = []
    hooks = [m.conv_offset_mask.register_forward_hook(lambda _m, _i, o: offsets.append(o[:, :18]))
             for m in model.modules() if isinstance(m, DCN)]
    tout = {k: v.numpy() for k, v in make_gen_step(tcfg, model)(batch).items()}
    for h in hooks:
        h.remove()

    trows = infer(model, torch.from_numpy(np.asarray(batch["images"])),
                  torch.from_numpy(ei).long(), torch.from_numpy(el).long(),
                  *(torch.from_numpy(np.asarray(p, np.float32)) for p in post), cfg=tcfg0)
    return dict(jcfg=jcfg, samples=samples, batch=batch, jout=jout, tout=tout, offsets=offsets,
                jrows={k: np.asarray(v) for k, v in jrows.items()},
                trows={k: v.numpy() for k, v in trows.items()})


def test_gen_step_matches_jax(pair):
    """Eval-mode forward, keypoints at the ground-truth centres, pair-depth
    locations and yaws: every field of every object slot. The offsets stay
    inside the clamp, where the port's clamped DCN and JAX's gather form
    are one function."""
    assert 0.1 < max(float(o.abs().max()) for o in pair["offsets"]) < 3
    jout, tout = pair["jout"], pair["tout"]
    assert set(tout) == set(jout) and int(tout["mask"].sum()) == int(pair["batch"]["reg_mask"].sum())
    for k in jout:
        assert tout[k].shape == jout[k].shape, k
        _close(tout[k], jout[k], PAIR_LOC_REL if k == "pred_location" else REL, k)


def _write_train(mod, out, samples, cfg, path):
    m = out["mask"].astype(bool)
    writer = mod.GenDataTrainWriter()
    objs = np.where(m.reshape(-1))[0]
    writer.add_batch(
        mod.normalize_batch_kpts(out["kpts_2d_img"][m], objs // cfg.datasets.max_objects,
                                 [s.calib.P for s in samples]),
        out["kpts_3d"][m], out["pred_rot"][m], out["gt_location"][m], out["pred_location"][m],
        [samples[k // cfg.datasets.max_objects].img_id for k in objs])
    writer.dump(str(path))


def _write_infer(mod, rows, samples, path):
    writer = mod.GenDataInferWriter()
    for b, s in enumerate(samples):
        writer.add_image(s.img_id, rows["dets"][b], rows["valid"][b],
                         mod.normalize_kpts_2d(rows["kpts_2d"][b], s.calib.P), rows["kpts_3d"][b])
    writer.dump(str(path))


def test_writers_write_jax_text(pair, tmp_path):
    """The same arrays through both packages' writers give the same bytes,
    and both normalisations (reference quirk and per sample) agree."""
    jcfg, samples, out, rows = pair["jcfg"], pair["samples"], pair["jout"], pair["jrows"]
    for name, mod in (("port", port_gen_data), ("jax", jax_gen_data)):
        _write_train(mod, out, samples, jcfg, tmp_path / f"{name}_train.json")
        _write_infer(mod, rows, samples, tmp_path / f"{name}_infer.json")
    for kind in ("train", "infer"):
        text = (tmp_path / f"port_{kind}.json").read_text()
        assert text == (tmp_path / f"jax_{kind}.json").read_text(), kind
    kp = out["kpts_2d_img"][:3]
    Ps = [s.calib.P * [[1.1], [0.9], [1.0]] for s in samples] + [samples[0].calib.P]
    for per_sample in (False, True):
        np.testing.assert_array_equal(
            port_gen_data.normalize_batch_kpts(kp, np.array([1, 0, 1]), Ps, per_sample),
            jax_gen_data.normalize_batch_kpts(kp, np.array([1, 0, 1]), Ps, per_sample))


def _same_arrays(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_loaders_match_jax(pair, tmp_path):
    """The committed train file, the committed infer file (8 images without
    a detection) and an infer file with objects."""
    _same_arrays(port_gen_data.load_gen_data_train(TRAIN_JSON),
                 jax_gen_data.load_gen_data_train(TRAIN_JSON))
    assert port_gen_data.load_gen_data_train(TRAIN_JSON)["kpts_2d"].shape == (32, 73, 2)
    path = tmp_path / "infer.json"
    _write_infer(jax_gen_data, pair["jrows"], pair["samples"], path)
    for p in (INFER_JSON, str(path)):
        got, got_idx = port_gen_data.load_gen_data_infer(p)
        want, want_idx = jax_gen_data.load_gen_data_infer(p)
        _same_arrays(got, want)
        assert got_idx == want_idx
    n_valid = int(pair["jrows"]["valid"].sum())
    assert n_valid > 10 and got["kpts_2d"].shape == (n_valid, 73, 2)
    assert port_gen_data.load_gen_data_infer(INFER_JSON)[0]["kpts_2d"].shape == (0,)


# ------------------------------------------------------------- the slice


def _matched(trows, jrows):
    """(image, port row, JAX row) of the rows both packages output, matched
    by 2D box centre: random weights leave some peaks' scores ~1e-9 apart,
    and their order in the top-K then follows the summation order."""
    out = []
    for b in range(trows["dets"].shape[0]):
        ct = trows["dets"][b][:, 2:6]
        for j, row in enumerate(jrows["dets"][b]):
            i = int(np.argmin(np.abs(ct - row[2:6]).sum(1)))
            if np.abs(ct[i] - row[2:6]).max() <= 1e-3:
                out.append((b, i, j))
    return out


def test_slice_end_to_end_matches_jax(pair, tmp_path):
    """Each package: its gen step's fields -> its train JSON -> its loader
    -> two GMW train steps from shared weights (GMWConfig with 16 features,
    depth 2, top-64, as test_full_pipeline) -> its inference rows -> its
    infer JSON -> its loader -> predict -> rescale_location. Losses <= 1e-4
    relative; refined depths and locations of the matched objects <= 1e-4 of
    scale, but for SLICE_FLIPS objects <= SLICE_FLIP_REL (see there)."""
    jcfg, samples = pair["jcfg"], pair["samples"]
    loaded = {}
    for name, mod, out, rows in (("port", port_gen_data, pair["tout"], pair["trows"]),
                                 ("jax", jax_gen_data, pair["jout"], pair["jrows"])):
        _write_train(mod, out, samples, jcfg, tmp_path / f"{name}_train.json")
        _write_infer(mod, rows, samples, tmp_path / f"{name}_infer.json")
        loaded[name] = (mod.load_gen_data_train(str(tmp_path / f"{name}_train.json")),
                        mod.load_gen_data_infer(str(tmp_path / f"{name}_infer.json")))
    for k in loaded["jax"][0]:
        _close(loaded["port"][0][k], loaded["jax"][0][k], REL, k)

    n_kpts = jcfg.model.head.num_kpts
    gcfg = dict(num_kpts=n_kpts, features=16, depth=2, topk=64)
    jm, jstate = jax_gmw_train.create_gmw_state(jax_gmw_train.GMWConfig(**gcfg), jax.random.PRNGKey(1))
    model, state = port_gmw_train.create_gmw_state(port_gmw_train.GMWConfig(**gcfg), device="cpu")
    load_state(model, from_jax_gmw_params(jstate.params))

    def gbatch(train):
        n = min(4, train["kpts_2d"].shape[0])
        return {"kpts_2d": train["kpts_2d"][:n], "kpts_3d": train["kpts_3d"][:n],
                "pred_rot": train["pred_rot"][:n, 0], "gt_depth": train["gt_location"][:n, 2]}

    jstep = jax.jit(jax_gmw_train.make_gmw_train_step(jax_gmw_train.GMWConfig(**gcfg), jm))
    pstep = port_gmw_train.make_gmw_train_step(port_gmw_train.GMWConfig(**gcfg), model)
    for _ in range(2):
        jb = {k: jnp.asarray(v) for k, v in gbatch(loaded["jax"][0]).items()}
        jstate, jlogs = jstep(jstate, jb, jnp.float32(1.0), jnp.float32(0.1))
        plogs = pstep(state, gbatch(loaded["port"][0]), 1.0, 0.1)
        for k in jlogs:
            assert np.isfinite(float(plogs[k]))
            _close(float(plogs[k]), float(jlogs[k]), REL, k)

    matched = _matched(pair["trows"], pair["jrows"])
    assert len(matched) >= 2 * 50 - 4
    refined = {}
    for name, predict, params, rows in (
            ("jax", jax.jit(jax_gmw_train.make_gmw_predict(jax_gmw_train.GMWConfig(**gcfg), jm)),
             jstate.params, pair["jrows"]),
            ("port", port_gmw_train.make_gmw_predict(port_gmw_train.GMWConfig(**gcfg), model), None,
             pair["trows"])):
        arrays, img_idx = loaded[name][1]
        b = {"kpts_2d": arrays["kpts_2d"], "kpts_3d": arrays["kpts_3d"],
             "pred_rot": arrays["pred_rot"][:, 0]}
        depth = np.asarray(predict(params, b) if params is not None else predict(b))
        locs = (jax_gmw_train if name == "jax" else port_gmw_train).rescale_location(
            arrays["pred_location"], depth, arrays["dim"])
        assert np.isfinite(depth).all() and np.isfinite(locs).all()
        # the files list each image's valid rows in order
        slots = [(b, k) for b in range(B) for k in np.nonzero(rows["valid"][b])[0]]
        assert len(slots) == len(img_idx) == len(depth)
        refined[name] = {slot: (d, loc) for slot, d, loc in zip(slots, depth, locs)}
    both = [(refined["port"][(b, i)], refined["jax"][(b, j)]) for b, i, j in matched
            if (b, i) in refined["port"] and (b, j) in refined["jax"]]
    assert len(both) >= len(refined["jax"]) - 4
    for i, what in enumerate(("refined depth", "refined location")):
        got = np.array([p[i] for p, _ in both], np.float64).reshape(len(both), -1)
        want = np.array([j[i] for _, j in both], np.float64).reshape(len(both), -1)
        scale = float(np.abs(want).max())
        err = np.abs(got - want).max(1)
        assert (err > REL * scale).sum() <= SLICE_FLIPS, (what, np.sort(err)[-3:], scale)
        assert err.max() <= SLICE_FLIP_REL * scale, (what, err.max(), scale)
    with open(tmp_path / "port_infer.json") as f:
        assert sorted(json.load(f)) == [s.img_id for s in samples]
