"""The port's plain deformable conv against the JAX package's forms.

The same numpy inputs go through ``dcd_tpu.ops.dcn.deform_conv2d_dense``,
the Pallas kernel in interpret mode, ``deform_conv2d`` and the port's
``deform_conv2d_clamped`` / ``deform_conv2d_gather``, fp32 on the CPU. The
tolerance is 1e-5 absolute on outputs of magnitude ~1-5: the forms sum the
same terms in another order. The CUDA kernel itself is checked against
``deform_conv2d_clamped`` on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dcd_tpu.ops import dcn_pallas
from dcd_tpu.ops.dcn import deform_conv2d, deform_conv2d_dense
from dcd_tpu_torch.ops import dcn_cuda
from dcd_tpu_torch.ops.dcn import deform_conv2d_clamped, deform_conv2d_gather

TOL = 1e-5


def _inputs(B, H, W, C, Cout, off_scale, seed=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, H, W, C).astype(np.float32)
    off = (rng.randn(B, H, W, 18) * off_scale).astype(np.float32)
    mask = (1.0 / (1.0 + np.exp(-rng.randn(B, H, W, 9)))).astype(np.float32)
    w = (rng.randn(3, 3, C, Cout) * 0.2).astype(np.float32)
    b = rng.randn(Cout).astype(np.float32)
    return x, off, mask, w, b


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# offsets of std 2 px: a share beyond +-R (the clamp) and, at the border,
# outside the image (the zero padding)
@pytest.mark.parametrize("C,Cout,R", [(8, 16, 2), (16, 8, 3)])
def test_clamped_matches_dense_and_pallas(C, Cout, R):
    args = _inputs(2, 8, 8, C, Cout, 2.0)
    off = args[1]
    assert (np.abs(off) > R).mean() > 0.05
    got = deform_conv2d_clamped(*_t(*args), radius=R).numpy()
    dense = np.asarray(jax.jit(lambda *a: deform_conv2d_dense(*a, radius=R))(*args))
    np.testing.assert_allclose(got, dense, rtol=0, atol=TOL)
    pallas = np.asarray(dcn_pallas.deform_conv2d_pallas(*map(jnp.asarray, args), R, 4))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=TOL)


def test_gather_matches_unbounded_jax():
    args = _inputs(2, 8, 8, 8, 16, 2.0, seed=5)
    got = deform_conv2d_gather(*_t(*args)).numpy()
    want = np.asarray(jax.jit(deform_conv2d)(*args))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # the clamp is active on these inputs, so the two forms differ
    assert np.abs(got - deform_conv2d_clamped(*_t(*args), radius=2).numpy()).max() > 1e-2


def test_clamped_equals_gather_within_radius():
    x, off, mask, w, b = _inputs(2, 8, 8, 8, 8, 0.8, seed=9)
    off = np.clip(off, -2.5, 2.5)
    a = deform_conv2d_clamped(*_t(x, off, mask, w, b), radius=3).numpy()
    g = deform_conv2d_gather(*_t(x, off, mask, w, b)).numpy()
    np.testing.assert_allclose(a, g, rtol=0, atol=TOL)


# the cases of tests/test_dcn.py's TestZeroOffset, on the port
@pytest.mark.parametrize("stride,padding,dilation", [(1, 1, 1), (2, 1, 1), (1, 2, 2)])
@pytest.mark.parametrize("form", ["clamped", "gather"])
def test_zero_offset_equals_conv(form, stride, padding, dilation):
    rng = np.random.RandomState(7)
    B, H, W, Cin, Cout = 2, 12, 16, 8, 16
    Ho = (H + 2 * padding - (2 * dilation + 1)) // stride + 1
    Wo = (W + 2 * padding - (2 * dilation + 1)) // stride + 1
    x = torch.from_numpy(rng.randn(B, H, W, Cin).astype(np.float32))
    w = torch.from_numpy((rng.randn(3, 3, Cin, Cout) * 0.1).astype(np.float32))
    offset = torch.zeros(B, Ho, Wo, 18)
    mask = torch.ones(B, Ho, Wo, 9)
    kw = dict(stride=stride, padding=padding, dilation=dilation)
    if form == "clamped":
        got = deform_conv2d_clamped(x, offset, mask, w, radius=3, **kw)
    else:
        got = deform_conv2d_gather(x, offset, mask, w, **kw)
    want = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), **kw).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-4)


def test_integer_shift_offset():
    """A constant integer offset samples a shifted image."""
    rng = np.random.RandomState(7)
    B, H, W, C = 1, 10, 10, 4
    x = torch.from_numpy(rng.randn(B, H, W, C).astype(np.float32))
    w = torch.zeros(3, 3, C, C)
    w[1, 1] = torch.eye(C)
    offset = torch.zeros(B, H, W, 18)
    offset[..., 2 * 4 + 1] = 1.0  # centre tap dx: one to the right
    mask = torch.ones(B, H, W, 9)
    got = deform_conv2d_clamped(x, offset, mask, w, radius=3).numpy()
    want = np.zeros_like(x.numpy())
    want[:, :, :-1] = x.numpy()[:, :, 1:]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_half_mask_scales_output():
    x, off, _, w, b = _inputs(1, 6, 6, 4, 8, 0.7, seed=2)
    full = deform_conv2d_clamped(*_t(x, off, np.ones((1, 6, 6, 9), np.float32), w), radius=3)
    half = deform_conv2d_clamped(*_t(x, off, np.full((1, 6, 6, 9), 0.5, np.float32), w), radius=3)
    np.testing.assert_allclose(half.numpy(), 0.5 * full.numpy(), rtol=1e-5, atol=1e-6)


def test_offsets_outside_image_sample_zero():
    """Every tap pushed 3 px past the border of a 2x2 image reads only
    padding: the output is the bias alone."""
    x, _, mask, w, b = _inputs(1, 2, 2, 4, 4, 0.0)
    off = np.full((1, 2, 2, 18), 3.0, np.float32)
    got = deform_conv2d_clamped(*_t(x, off, mask, w, b), radius=3).numpy()
    np.testing.assert_allclose(got, np.broadcast_to(b, got.shape), rtol=0, atol=1e-6)


def test_cuda_wrapper_takes_plain_version_on_cpu():
    args = _t(*_inputs(1, 6, 7, 8, 8, 1.5, seed=4))
    before = dict(dcn_cuda.deform_conv2d.launches_by_kernel)
    got = dcn_cuda.deform_conv2d(*args, radius=3)
    assert dcn_cuda.deform_conv2d.launches_by_kernel == before  # no kernel on the CPU
    np.testing.assert_array_equal(got.numpy(), deform_conv2d_clamped(*args, radius=3).numpy())


def test_bf16_inputs_accumulate_in_fp32():
    x, off, mask, w, b = _t(*_inputs(1, 6, 6, 16, 8, 1.5, seed=6))
    got = deform_conv2d_clamped(x.bfloat16(), off, mask.bfloat16(), w.bfloat16(), b.bfloat16())
    assert got.dtype == torch.bfloat16
    want = deform_conv2d_clamped(x.bfloat16().float(), off, mask.bfloat16().float(),
                                 w.bfloat16().float(), b.bfloat16().float())
    np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                               rtol=2e-2, atol=2e-2 * float(want.abs().max()))


def test_cuda_wrapper_checks_its_arguments():
    """What the wrapper hands the kernel is checked before any launch."""
    x, off, mask, w, b = _t(*_inputs(1, 4, 5, 8, 8, 1.0))
    dcn_cuda._check(x, off, mask, w, b)
    dcn_cuda._check(x, off, mask, w, None)
    bad = [
        (x.double(), off, mask, w, b),  # no kernel for float64
        (x, off.bfloat16(), mask, w, b),  # offsets stay fp32
        (x, off, mask[..., :8].contiguous(), w, b),  # 9 taps
        (x, off, mask, w[:, :, :4].contiguous(), b),  # Cin of x
        (x, off, mask.transpose(1, 2).contiguous().transpose(1, 2), w, b),  # contiguous
        (x, off, mask, w, b[:4]),  # Cout of w
    ]
    for args in bad:
        with pytest.raises((TypeError, ValueError)):
            dcn_cuda._check(*args)
    with pytest.raises(ValueError, match="no kernel"):
        dcn_cuda.deform_conv2d(*(t.to("meta") for t in (x, off, mask, w, b)))


def _nan_offset_inputs():
    """The 12x16 image, 8 -> 8 channels, with NaN in tap 0's dy at one
    interior pixel and in tap 4's dx at another."""
    x, off, mask, w, b = _inputs(1, 12, 16, 8, 8, 1.0, seed=13)
    off[0, 5, 7, 0] = np.nan
    off[0, 8, 3, 2 * 4 + 1] = np.nan
    return x, off, mask, w, b


def test_nan_offset_drops_the_tap():
    """A NaN offset drops its tap in the dense form and the Pallas kernel;
    the port's clamped form drops it too, and gives no NaN."""
    args = _nan_offset_inputs()
    got = deform_conv2d_clamped(*_t(*args), radius=3).numpy()
    assert np.isfinite(got).all()
    dense = np.asarray(jax.jit(lambda *a: deform_conv2d_dense(*a, radius=3))(*args))
    # every window position walked: the adaptive skip bounds each tile's
    # walk by its offsets' extremes, which a NaN makes NaN
    pallas = np.asarray(dcn_pallas.deform_conv2d_pallas(*map(jnp.asarray, args), 3, 4, False))
    np.testing.assert_allclose(got, dense, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=TOL)
    # the tap is gone, not sampled at the clamp's edge
    x, off, mask, w, b = args
    edge = off.copy()
    edge[0, 5, 7, 0] = -3.0
    at_edge = deform_conv2d_clamped(*_t(x, edge, mask, w, b), radius=3).numpy()
    assert np.abs(at_edge[0, 5, 7] - got[0, 5, 7]).max() > 1e-2


def test_nan_offset_gives_finite_gradients():
    """Autograd of the plain version (the oracle of the backward kernels)
    gives no NaN at a dropped tap: nothing flows to or from it."""
    from dcd_tpu_torch.ops.dcn import dcn_bwd_pom_plain, dcn_bwd_x_plain

    x, off, mask, w, _ = _t(*_nan_offset_inputs())
    g = torch.from_numpy(np.random.RandomState(1).randn(1, 12, 16, 8).astype(np.float32))
    go, gm, gw = dcn_bwd_pom_plain(x, off, mask, w, g, 3)
    gx = dcn_bwd_x_plain(x, off, mask, w, g, 3)
    for t in (go, gm, gw, gx):
        assert torch.isfinite(t).all()
    assert float(go[0, 5, 7, :2].abs().max()) == 0.0 and float(gm[0, 5, 7, 0]) == 0.0
    assert float(go[0, 8, 3, 8:10].abs().max()) == 0.0 and float(gm[0, 8, 3, 4]) == 0.0


@pytest.fixture(scope="module")
def dcn_modules():
    """A JAX ``DCN`` module's parameters drawn with numpy and carried into
    the port's ``DCN`` (kernel transposed, offset conv from flax's block
    layout to the interleaved one), and an input whose offsets move the
    samples but stay inside the clamp."""
    from dcd_tpu_torch.models.layers import DCN
    from dcd_tpu_torch.utils.weights import offset_conv_perm

    rng = np.random.RandomState(17)
    Cin, Cout = 8, 8
    params = {
        "conv_offset_mask": {"kernel": (rng.randn(3, 3, Cin, 27) * 0.07).astype(np.float32),
                             "bias": (rng.randn(27) * 0.4).astype(np.float32)},
        "kernel": (rng.randn(3, 3, Cin, Cout) * 0.2).astype(np.float32),
        "bias": rng.randn(Cout).astype(np.float32),
    }
    x = rng.randn(2, 9, 11, Cin).astype(np.float32)
    inv = np.argsort(offset_conv_perm(9))
    state = {
        "weight": np.transpose(params["kernel"], (3, 2, 0, 1)),
        "bias": params["bias"],
        "conv_offset_mask.weight": np.transpose(params["conv_offset_mask"]["kernel"], (3, 2, 0, 1))[inv],
        "conv_offset_mask.bias": params["conv_offset_mask"]["bias"][inv],
    }

    def port(impl):
        m = DCN(Cin, Cout, impl=impl, radius=3)
        m.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state.items()})
        with torch.no_grad():
            om = m.conv_offset_mask(torch.from_numpy(x).permute(0, 3, 1, 2))
            out = m(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return out.numpy(), float(om[:, :18].abs().max())

    return params, x, port


@pytest.mark.parametrize("impl", ["auto", "pallas", "dense", "gather", "plain"])
def test_dcn_impl_values_mean_what_they_mean_in_jax(dcn_modules, impl):
    """Each ``dcn_impl`` value computes in the port what it computes in the
    JAX package's DCN module, on the same weights and input. On these inputs
    no offset reaches the clamp, so the clamped and unbounded forms agree,
    and "plain" (an ordinary conv) differs from them."""
    from dcd_tpu.models.layers import DCN as JaxDCN

    params, x, port = dcn_modules
    got, biggest = port(impl)
    assert 0.3 < biggest < 3.0
    want = np.asarray(jax.jit(lambda p, a: JaxDCN(8, impl=impl, window_radius=3).apply(
        {"params": p}, a))(params, x))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    if impl == "plain":
        assert np.abs(got - port("dense")[0]).max() > 1e-2


def test_dcn_refuses_unknown_impl():
    from dcd_tpu_torch.models.layers import DCN

    with pytest.raises(ValueError, match="dcn_impl"):
        DCN(8, 8, impl="cuda")
