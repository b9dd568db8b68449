"""The deeper head (``head.deeper_head``: a conv + BN + act, DCN + BN + act
stem in front of the class and the regression branches) against the JAX
package's, on the small configuration cut to output stride 16 as
test_torch_train_bf16.py cuts it (2 DCN blocks in the decoder, 2 in the
stems): compiling JAX's gradient costs seconds per DCN block on a CPU.

* Shared weights: flax variables drawn with numpy, the BN running statistics
  calibrated on the test's images by the port and carried back to flax by
  name (``import_torch_dgde`` does not know the stems' names). The eval-mode
  heads must agree to 1e-4 of their largest magnitude, as
  test_torch_model.py holds the shipped head: the dense heads with the head
  as wide as the trunk's output (32) and twice as wide (64, as the shipped
  head is wider than its trunk: 256 and 64), the lazy top-K heads at 32
  alone (see ``_deeper``).
* One step, with the head twice as wide as the trunk: the port's
  ``compute_gradients`` against ``make_grad_fn`` on one synthetic
  microbatch, within test_torch_train.py's limits.
* ``init_weights`` draws the stems' conv and DCN kernels from flax's families.

The JAX stems' DCN is the module's default form (``auto``: the unbounded
gather on the CPU) and the decoder's the gather form; the port runs its
clamped plain form, so the test checks that no offset reaches the clamp.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcd_tpu.data import synthetic
from dcd_tpu.data.target_encoder import collate, encode_targets
from dcd_tpu.engine.train import make_grad_fn
from dcd_tpu.models.predictor import Predictor as JaxPredictor
from dcd_tpu_torch.engine.infer import build_detector
from dcd_tpu_torch.engine.train import build_trainer, compute_gradients
from dcd_tpu_torch.models.detector import KeypointDetector
from dcd_tpu_torch.models.layers import DCN
from dcd_tpu_torch.models.predictor import HEAD_DCN_RADIUS
from dcd_tpu_torch.utils.weights import calibrate_batch_norm, from_jax_variables, load_state
from test_torch_init import TRUNCATED_MAX, _kurtosis
from test_torch_train import _check_step
from torch_port_common import CHANNELS, numpy_variables, small_configs
from torch_port_common import one_torch_thread  # noqa: F401  (autouse)

REL = 1e-4
B = 2
DCN_BLOCKS = 2 + 2  # the decoder's at output stride 16 and the two stems'


# the trunk's output channels at stride 16, and the two head widths
TRUNK = CHANNELS[4]
WIDTHS = {"equal": TRUNK, "wide": 2 * TRUNK}


def _deeper(cfg, width):
    """Stride 16 leaves a 4 x 8 map: the lazy path takes the top 16 of its
    32 pixels. The JAX package's lazy path reads the stem's output with the
    trunk's channel count (``C`` of ``features``,
    ``dcd_tpu/models/predictor.py:92``, at :273) and fails to reshape it
    where the head is wider, as at the shipped widths (64 and 256); the port
    takes the stem's own. Its dense path and ``make_grad_fn`` take any
    width."""
    bb = dataclasses.replace(cfg.model.backbone, down_ratio=16)
    head = dataclasses.replace(cfg.model.head, deeper_head=True, num_channel=width)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, backbone=bb, head=head),
                               test=dataclasses.replace(cfg.test, detections_per_img=16))


def _configs(width=WIDTHS["wide"]):
    jcfg, tcfg = small_configs()
    return _deeper(jcfg, width), _deeper(tcfg, width)


def _close(got, want, name, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{name}: max abs err {err} vs scale {scale}"


def _carry_back_stats(batch_stats, sd, tcfg):
    """Flax ``batch_stats`` with every leaf replaced by the port's buffer of
    the same name: each leaf is tagged by its index and mapped through
    ``from_jax_variables``."""
    leaves, treedef = jax.tree_util.tree_flatten(batch_stats)
    tagged = jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(v), i, np.float32) for i, v in enumerate(leaves)])
    names = {int(v.flat[0]): k for k, v in
             from_jax_variables({"params": {}, "batch_stats": tagged}, tcfg).items()}
    assert len(names) == len(leaves)
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(sd[names[i]].numpy()) for i in range(len(leaves))])


def _offsets(model):
    """Forward hooks that collect each DCN's largest |offset|."""
    seen = []
    hooks = [m.conv_offset_mask.register_forward_hook(
        lambda _m, _i, o: seen.append(float(o[:, :18].detach().abs().max())))
        for m in model.modules() if isinstance(m, DCN)]
    return seen, hooks


def _shared(width, lazy):
    """JAX's numpy-drawn weights with BN statistics calibrated on two
    synthetic scenes, both packages' eval-mode heads on them (the dense
    heads, and with ``lazy`` the lazy top-K heads), and the encoded batch."""
    jcfg, tcfg = _configs(width)
    samples = [encode_targets(*synthetic.make_scene(seed=s, num_objs=3, image_size=(120, 60),
                                                   depth_range=(6.0, 20.0)), jcfg)
               for s in range(B)]
    batch = collate(samples)
    assert batch["reg_mask"].sum() >= 4
    jmodel, variables = numpy_variables(jcfg, seed=5)
    assert "cls_head_pre_dcn" in variables["params"]["heads"]
    model = KeypointDetector(tcfg).eval()
    load_state(model, from_jax_variables(variables, tcfg))
    args = (torch.from_numpy(batch["images"]), torch.from_numpy(batch["edge_indices"]).long(),
            torch.from_numpy(batch["edge_len"]).long())
    calibrate_batch_norm(model, *args)
    variables = {"params": variables["params"],
                 "batch_stats": _carry_back_stats(variables["batch_stats"], model.state_dict(),
                                                  tcfg)}
    out_j = jax.jit(lambda v, *a: (jmodel.apply(v, *a, train=False),
                                   jmodel.apply(v, *a, train=False, lazy_topk=True) if lazy
                                   else None))(
        variables, *(jnp.asarray(batch[k]) for k in ("images", "edge_indices", "edge_len")))
    offsets, hooks = _offsets(model)
    with torch.no_grad():
        out_t = model(*args), model(*args, lazy_topk=True) if lazy else None
    for h in hooks:
        h.remove()
    return dict(jcfg=jcfg, jmodel=jmodel, variables=variables, batch=batch,
                out_j=jax.tree.map(np.asarray, out_j), out_t=out_t, offsets=offsets)


@pytest.fixture(scope="module")
def equal():
    return _shared(WIDTHS["equal"], lazy=True)


@pytest.fixture(scope="module")
def wide():
    return _shared(WIDTHS["wide"], lazy=False)


def test_deeper_head_builds_the_stems(wide):
    _, tcfg = _configs()
    heads = build_detector(tcfg, "cpu").heads
    hc = tcfg.model.head.num_channel
    assert hc == 2 * TRUNK
    for stem in (heads.cls_head_pre, heads.reg_head_pre):
        assert isinstance(stem[3], DCN) and stem[3].radius == HEAD_DCN_RADIUS
        assert stem[0].in_channels == TRUNK and stem[0].out_channels == hc
        assert stem[3].weight.shape == (hc, hc, 3, 3)
    assert heads.class_head[0].in_channels == hc
    # the two stems' DCNs beside the decoder's in the one dense forward,
    # each below the clamp
    n = sum(isinstance(m, DCN) for m in heads.modules())
    assert n == 2 and len(wide["offsets"]) == DCN_BLOCKS
    assert max(wide["offsets"]) < HEAD_DCN_RADIUS


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_dense_heads_match_jax(width, request):
    shared = request.getfixturevalue(width)
    assert max(shared["offsets"]) < HEAD_DCN_RADIUS
    (dense_j, _), (dense_t, _) = shared["out_j"], shared["out_t"]
    _close(dense_t["cls"], dense_j["cls"], "cls")
    _close(dense_t["reg"], dense_j["reg"], "reg")


def test_lazy_heads_match_jax(equal):
    """The lazy path gathers the 3x3 neighbourhoods of the reg stem's
    output (head_conv channels) at the top-K peaks."""
    (_, lazy_j), (_, lazy_t) = equal["out_j"], equal["out_t"]
    np.testing.assert_array_equal(lazy_t["clses"].numpy(), lazy_j["clses"])
    np.testing.assert_array_equal(lazy_t["points_xy"].numpy(), lazy_j["points_xy"])
    for k in ("cls", "scores", "reg_pois"):
        _close(lazy_t[k], lazy_j[k], k)


def test_one_step_matches_make_grad_fn(wide):
    """With the head twice as wide as the trunk, as the shipped head is."""
    jcfg, tcfg = _configs()
    mb = {k: v[:1] for k, v in wide["batch"].items()}
    v = wide["variables"]
    (total, (stats, logs)), grads = jax.jit(make_grad_fn(jcfg, wide["jmodel"]))(
        v["params"], v["batch_stats"], mb)
    trainer = build_trainer(tcfg, device="cpu")
    load_state(trainer.model, from_jax_variables(v, tcfg))
    offsets, hooks = _offsets(trainer.model)
    got_logs = compute_gradients(trainer, mb)
    for h in hooks:
        h.remove()
    assert len(offsets) == DCN_BLOCKS and max(offsets) < HEAD_DCN_RADIUS, offsets
    got = {n: np.zeros(tuple(p.shape), np.float32) if p.grad is None else p.grad.numpy()
           for n, p in trainer.model.named_parameters()}
    assert any(n.startswith("heads.cls_head_pre.3.") for n in got)
    _check_step(trainer, {k: float(x) for k, x in got_logs.items()}, got,
                jax.tree.map(np.asarray, logs), float(total), jax.tree.map(np.asarray, grads),
                jax.tree.map(np.asarray, stats))


def test_init_draws_the_stems_as_flax_does():
    """The stems' conv kernels (truncated LeCun normal) and DCN kernels
    (uniform in +-1/sqrt(fan_in)) against flax's draws, pooled over both
    stems: the std of w * sqrt(fan_in) within 10 %, the truncation, and the
    uniform's kurtosis of 1.8. JAX's heads are drawn alone (``model.init``
    draws each module from its own path's key)."""
    jcfg, tcfg = _configs()
    heads = JaxPredictor(jcfg, name="heads")
    C = build_detector(tcfg, "cpu").backbone.out_channels
    Ho, Wo, L = jcfg.output_height, jcfg.output_width, jcfg.max_edge_length
    variables = jax.jit(lambda r: heads.init(
        r, jnp.zeros((1, Ho, Wo, C)), jnp.zeros((1, L, 2), jnp.int32), jnp.ones((1,), jnp.int32),
        train=False))(jax.random.PRNGKey(0))
    jax_sd = from_jax_variables({"params": {"heads": variables["params"]}}, tcfg)
    port_sd = {k: v.numpy() for k, v in build_detector(tcfg, "cpu", seed=0).state_dict().items()}

    def pooled(sd, child):
        return np.concatenate([np.asarray(sd[f"heads.{s}_head_pre.{child}.weight"], np.float64).ravel()
                               * np.sqrt(sd[f"heads.{s}_head_pre.{child}.weight"][0].size)
                               for s in ("cls", "reg")])

    for child in (0, 3):
        j, p = pooled(jax_sd, child), pooled(port_sd, child)
        assert p.size == j.size > 1000
        assert abs(p.std() / j.std() - 1.0) < 0.10, (child, p.std(), j.std())
        if child == 3:
            assert abs(_kurtosis(j) - 1.8) < 0.1 and abs(_kurtosis(p) - 1.8) < 0.1
        else:
            assert max(np.abs(j).max(), np.abs(p).max()) <= TRUNCATED_MAX * 1.01
    for s in ("cls", "reg"):
        assert not np.any(port_sd[f"heads.{s}_head_pre.3.conv_offset_mask.weight"])
        assert not np.any(port_sd[f"heads.{s}_head_pre.3.bias"])
        np.testing.assert_array_equal(port_sd[f"heads.{s}_head_pre.4.weight"], 1.0)
