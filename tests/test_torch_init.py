"""The port's seeded DGDE initialisation against the JAX package's
``model.init``: family by family, each parameter drawn from the distribution
flax gives it (``lecun_normal`` truncated at two standard deviations for
every ``nn.Conv``, ``variance_scaling(1/3, "fan_in", "uniform")`` for the DCN
kernels). The draws differ (``torch.Generator`` against JAX's PRNG), so the
test compares the pooled statistics of w * sqrt(fan_in)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dcd_tpu.models.detector import KeypointDetector as JaxDetector
from dcd_tpu_torch.engine.infer import build_detector
from dcd_tpu_torch.utils.weights import from_jax_variables
from torch_port_common import edge_inputs, small_configs, with_dcn
from torch_port_common import one_torch_thread  # noqa: F401  (autouse)

# flax's truncated normal keeps |w| <= 2 std of the untruncated normal, whose
# std is sqrt(1 / fan_in) / 0.8796
TRUNCATED_MAX = 2.0 / 0.87962566103423978
STD_TOL = 0.10


def _uncertainty_keys(cfg):
    head = cfg.model.head
    return {f"heads.reg_heads.{gi}.{ki}.weight"
            for gi, group in enumerate(head.regression_heads)
            for ki, key in enumerate(group) if "uncertainty" in key}


def _family(name, uncertainty):
    """The family of a port weight name, or None for what the test leaves
    out (BN, offset convs, the bilinear kernels, the uncertainty heads)."""
    if not name.endswith(".weight") or ".up_" in name or "conv_offset_mask" in name:
        return None
    if name in uncertainty:
        return None
    if name.startswith("backbone.base."):
        return "trunk"
    if name.startswith(("backbone.dla_up.", "backbone.ida_up.")) and name.endswith(".conv.weight"):
        return "dcn"
    if name.startswith("heads.trunc_"):
        return "edge_fusion"
    if name.startswith(("heads.class_head.0.", "heads.reg_features.")):
        return "head_3x3"
    if name.startswith(("heads.class_head.3.", "heads.reg_heads.")):
        return "head_1x1"
    return None


def _pooled(state, uncertainty):
    """family -> w * sqrt(fan_in) of every weight in it, flattened."""
    out = {}
    for name, w in state.items():
        w = np.asarray(w, np.float64)
        fam = _family(name, uncertainty) if w.ndim > 1 else None
        if fam is not None:
            out.setdefault(fam, []).append(w.ravel() * np.sqrt(w[0].size))
    return {k: np.concatenate(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def pooled():
    jcfg, tcfg = small_configs()
    jcfg = with_dcn(jcfg, "plain")  # the parameters do not depend on the DCN form
    model = JaxDetector(jcfg)
    ei, el = edge_inputs(jcfg, 1, np.random.RandomState(0))
    img = jnp.zeros((1, jcfg.input.height_train, jcfg.input.width_train, 3), jnp.float32)
    variables = jax.jit(lambda r: model.init(r, img, ei, el, train=False))(jax.random.PRNGKey(0))
    uncertainty = _uncertainty_keys(tcfg)
    port = {k: v.numpy() for k, v in build_detector(tcfg, "cpu", seed=0).state_dict().items()}
    return (_pooled(from_jax_variables(variables, tcfg), uncertainty),
            _pooled(port, uncertainty), port, uncertainty)


def _kurtosis(x):
    x = x - x.mean()
    return float((x ** 4).mean() / (x ** 2).mean() ** 2)


@pytest.mark.parametrize("family", ["trunk", "dcn", "head_3x3", "head_1x1", "edge_fusion"])
def test_port_init_draws_each_family_as_flax_does(pooled, family):
    jax_w, port_w, _, _ = pooled
    j, p = jax_w[family], port_w[family]
    assert j.size > 100 and p.size == j.size
    assert abs(p.std() / j.std() - 1.0) < STD_TOL, (family, p.std(), j.std())
    if family == "dcn":
        # uniform in +-1/sqrt(fan_in): kurtosis 1.8 (a normal's is 3)
        assert abs(_kurtosis(j) - 1.8) < 0.1 and abs(_kurtosis(p) - 1.8) < 0.1, (
            _kurtosis(j), _kurtosis(p))
        assert np.abs(p).max() <= 1.0 + 1e-6
    else:
        assert np.abs(j).max() <= TRUNCATED_MAX * 1.01
        assert np.abs(p).max() <= TRUNCATED_MAX * 1.01, (family, np.abs(p).max())


def test_port_init_keeps_biases_prior_and_uncertainty_heads(pooled):
    _, _, port, uncertainty = pooled
    _, tcfg = small_configs()
    prior = -np.log(1.0 / tcfg.model.head.init_p - 1.0)
    np.testing.assert_allclose(port["heads.class_head.3.bias"], prior, rtol=1e-6)
    for name, w in port.items():
        conv_bias = name.endswith(".bias") and port[name[:-4] + "weight"].ndim > 1
        if (conv_bias and name != "heads.class_head.3.bias") or "conv_offset_mask" in name:
            assert not np.any(w), name
    for name in uncertainty:
        w = port[name]
        fan_avg = (w.shape[0] + w.shape[1]) / 2
        assert np.abs(w).max() < 10 * np.sqrt(1e-4 / fan_avg), name
