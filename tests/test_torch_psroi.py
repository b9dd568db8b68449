"""The port's deformable PS-ROI pooling (``dcd_tpu_torch/ops/psroi.py``):
the four cases of tests/test_psroi.py, and the forward and the gradients
(features and offsets) against the JAX package's ``deform_psroi_pooling``
within 1e-5 of their scale (the gradients against JAX's in float64), with and without offsets, several groups and
parts, rois reaching past the map and a spatial scale below 1."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcd_tpu.ops.psroi import deform_psroi_pooling as jax_pool
from dcd_tpu_torch.ops.psroi import deform_psroi_pooling
from torch_port_common import one_torch_thread  # noqa: F401  (autouse)

REL = 1e-5


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def test_constant_feature_pools_to_constant():
    out_dim, group, P = 4, 2, 4
    x = torch.full((1, 16, 16, out_dim * group * group), 3.5)
    out = deform_psroi_pooling(x, _t([[0, 2, 2, 12, 12]]), None, 1.0, P, out_dim, group_size=group)
    assert out.shape == (1, P, P, out_dim)
    np.testing.assert_allclose(out.numpy(), 3.5, rtol=1e-5)


def test_position_sensitive_channels():
    out_dim, group, P = 2, 2, 4
    x = np.zeros((1, 16, 16, out_dim * group * group), np.float32)
    x[..., 0:out_dim] = 7.0  # group (0, 0)
    out = deform_psroi_pooling(_t(x), _t([[0, 0, 0, 15, 15]]), None, 1.0, P, out_dim,
                               group_size=group)[0].numpy()
    np.testing.assert_allclose(out[:2, :2], 7.0, rtol=1e-5)
    np.testing.assert_allclose(out[2:, 2:], 0.0, atol=1e-6)


def test_trans_shifts_sampling():
    ramp = np.tile(np.arange(20, dtype=np.float32)[None, :, None], (20, 1, 1))
    x, rois = _t(ramp[None]), _t([[0, 4, 4, 12, 12]])
    base = deform_psroi_pooling(x, rois, None, 1.0, 2, 1)
    shifted = deform_psroi_pooling(x, rois, torch.ones(1, 2, 2, 2), 1.0, 2, 1, trans_std=0.1)
    assert (shifted > base + 1e-3).all()


def test_gradients_flow():
    rng = np.random.RandomState(0)
    x = _t(rng.randn(1, 16, 16, 8)).requires_grad_()
    trans = _t(rng.randn(1, 4, 4, 2) * 0.1).requires_grad_()
    out = deform_psroi_pooling(x, _t([[0, 1, 1, 14, 14]]), trans, 1.0, 4, 2, 2, trans_std=0.1)
    (out ** 2).sum().backward()
    for g in (x.grad, trans.grad):
        assert torch.isfinite(g).all() and g.abs().max() > 0


CASES = {
    # (B, H, W, out_dim, group, P, part, samples, scale, trans_std, offsets)
    "no_trans": (2, 12, 18, 3, 2, 3, None, 2, 0.5, 0.0, False),
    "trans": (2, 12, 18, 3, 3, 3, None, 4, 0.5, 0.1, True),
    "parts": (1, 10, 10, 2, 2, 4, 2, 3, 1.0, 0.2, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_gradients_match_jax(case):
    B, H, W, out_dim, group, P, part, s, scale, tstd, offsets = CASES[case]
    rng = np.random.RandomState(len(case))
    C = out_dim * group * group
    N = 5
    x = rng.randn(B, H, W, C).astype(np.float32)
    xy = rng.uniform(-4, max(H, W) / scale + 4, (N, 4)).astype(np.float32)
    rois = np.concatenate([rng.randint(0, B, (N, 1)), np.minimum(xy[:, :2], xy[:, 2:]),
                           np.maximum(xy[:, :2], xy[:, 2:])], 1).astype(np.float32)
    pp = part or P
    trans = (rng.randn(N, pp, pp, 2) * 0.5).astype(np.float32) if offsets else None
    kw = dict(group_size=group, part_size=part, sample_per_part=s, trans_std=tstd)

    def jpool(x, t, r=jnp.asarray(rois)):
        return jax_pool(x, r, t, scale, P, out_dim, **kw)

    want = np.asarray(jax.jit(jpool)(jnp.asarray(x), None if trans is None else jnp.asarray(trans)))
    xt = _t(x).requires_grad_()
    tt = None if trans is None else _t(trans).requires_grad_()
    got = deform_psroi_pooling(xt, _t(rois), tt, scale, P, out_dim, **kw)
    assert got.shape == want.shape == (N, P, P, out_dim)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=REL * np.abs(want).max())
    (got ** 2).sum().backward()
    # JAX's gradients in float64 under jit: the exact function's to far
    # below the limit, whatever order XLA sums them in (its fp32 gradients
    # under jit sum the offsets' in another order than eagerly, which
    # moves one element by 1.1e-5 of scale)
    with jax.enable_x64():
        args = [jnp.asarray(x, jnp.float64)] + ([] if trans is None else
                                                [jnp.asarray(trans, jnp.float64)])
        grads = jax.jit(jax.grad(
            lambda *a: (jpool(a[0], a[1] if len(a) > 1 else None,
                              jnp.asarray(rois, jnp.float64)) ** 2).sum(),
            argnums=tuple(range(len(args)))))(*args)
        grads = [np.asarray(g) for g in grads]
    pairs = list(zip([xt.grad] + ([] if tt is None else [tt.grad]), grads))
    for g, w in pairs:
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=REL * np.abs(w).max())
