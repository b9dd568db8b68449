"""The port's deformable-conv backward against the JAX package's.

``DeformConv2dFunction`` on CPU tensors runs the plain versions of the CUDA
backward kernels (K2: grad offset, mask and weight; K3: grad x). Its
gradients must match ``jax.vjp`` of the JAX package's Pallas op (its custom
VJP through the two Pallas backward kernels, in interpret mode on the CPU)
and of the clamped dense form, to 1e-5 of each gradient's largest
magnitude: fp32 sums taken in another order. The cases are those of
``tests/test_dcn.py``'s backward test (plain, heavily clipped offsets, R=1)
and all-zero offsets, the integer positions of every DCN at the first
train step; the R=2 cases share one shape, so that JAX compiles each form
once, and the R=1 case goes to the Pallas op alone (the dense form's
compile at another shape costs some 15 s on a CPU).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcd_tpu.ops import dcn_pallas
from dcd_tpu.ops.dcn import deform_conv2d_dense
from dcd_tpu_torch.models.layers import DCN
from dcd_tpu_torch.ops import dcn_cuda
from dcd_tpu_torch.ops.dcn import dcn_bwd_pom_plain, dcn_bwd_x_plain
from dcd_tpu_torch.ops.dcn_cuda import DeformConv2dFunction

TOL = 1e-5
NAMES = ("x", "offset", "mask", "weight", "bias")


def _inputs(B, H, W, C, Cout, off_scale, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, H, W, C).astype(np.float32)
    off = (rng.randn(B, H, W, 18) * off_scale).astype(np.float32)
    mask = (1.0 / (1.0 + np.exp(-rng.randn(B, H, W, 9)))).astype(np.float32)
    w = (rng.randn(3, 3, C, Cout) * 0.1).astype(np.float32)
    b = rng.randn(Cout).astype(np.float32)
    g = np.random.RandomState(11).randn(B, H, W, Cout).astype(np.float32)
    return (x, off, mask, w, b), g


def _port_grads(args, g, R):
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out = DeformConv2dFunction.apply(*leaves, R)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


def _close(got, want, name):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape, name
    assert err <= TOL * scale, f"{name}: max abs err {err} vs scale {scale}"


@functools.partial(jax.jit, static_argnums=(6,))
def _pallas_vjp(x, off, mask, w, b, g, R):
    # jitted, so that the cases of one shape share one compile of the
    # interpret-mode kernels
    out, vjp = jax.vjp(lambda *a: dcn_pallas.deform_conv2d_pallas(*a, R, 4), x, off, mask, w, b)
    return out, vjp(g)


@pytest.mark.parametrize(
    "B,H,W,C,Cout,R,off_scale,oracles",
    [
        # one shape for the R=2 cases: JAX compiles each shape once
        (2, 8, 16, 8, 12, 2, 0.9, ("pallas", "dense")),  # plain
        (2, 8, 16, 8, 12, 2, 4.0, ("pallas", "dense")),  # heavily clipped offsets
        (2, 8, 16, 8, 12, 2, 0.0, ("pallas", "dense")),  # zero offsets: integer positions
        (1, 10, 12, 4, 8, 1, 0.6, ("pallas",)),  # R=1, H not a tile multiple
    ],
)
def test_function_grads_match_jax_vjps(B, H, W, C, Cout, R, off_scale, oracles):
    args, g = _inputs(B, H, W, C, Cout, off_scale)
    out, grads = _port_grads(args, g, R)
    jargs = [jnp.asarray(a) for a in args]
    for oracle in oracles:
        if oracle == "pallas":
            out_j, grads_j = _pallas_vjp(*jargs, jnp.asarray(g), R)
        else:
            out_j, vjp = jax.vjp(
                lambda *a: deform_conv2d_dense(*a, stride=1, padding=1, radius=R), *jargs)
            grads_j = vjp(jnp.asarray(g))
        _close(out, np.asarray(out_j), f"{oracle} out")
        for name, got, want in zip(NAMES, grads, grads_j):
            _close(got, np.asarray(want), f"{oracle} grad {name}")
    if off_scale == 0.0:
        # at integer positions the offset gradient is the forward difference,
        # not zero: the case a rounding kernel would get wrong
        assert np.abs(grads[1]).max() > 0.1


def test_clamped_offsets_get_no_offset_gradient():
    """Only grad_offset stops at the clamp: x and the mask still get theirs,
    taken at the clamped position."""
    args, g = _inputs(1, 8, 16, 8, 12, 4.0)
    _, grads = _port_grads(args, g, 2)
    off = args[1]
    assert (np.abs(off) > 2).mean() > 0.3
    assert np.all(grads[1][np.abs(off) > 2] == 0.0)
    # (inside the clamp an offset whose corners all fall outside the image
    # has none either)
    assert np.count_nonzero(grads[1][np.abs(off) < 2]) > 0.5 * (np.abs(off) < 2).sum()
    assert np.count_nonzero(grads[2]) > 0.5 * grads[2].size
    assert np.count_nonzero(grads[0]) > 0.5 * grads[0].size


def test_cpu_wrappers_are_the_plain_versions():
    args, g = _inputs(1, 6, 7, 4, 8, 1.3)
    x, off, mask, w, _ = map(torch.from_numpy, args)
    gt = torch.from_numpy(g)
    before = (dcn_cuda.dcn_bwd_pom.launches, dcn_cuda.dcn_bwd_x.launches)
    go, gm, gw, u = dcn_cuda.dcn_bwd_pom(x, off, mask, w, gt, 3)
    gx = dcn_cuda.dcn_bwd_x(x, off, mask, w, gt, 3)
    assert u is None
    for got, want in zip((go, gm, gw), dcn_bwd_pom_plain(x, off, mask, w, gt, 3)):
        assert torch.equal(got, want)
    assert torch.equal(gx, dcn_bwd_x_plain(x, off, mask, w, gt, 3))
    assert (dcn_cuda.dcn_bwd_pom.launches, dcn_cuda.dcn_bwd_x.launches) == before


def _bad_args(case):
    args, g = _inputs(1, 5, 6, 4, 8, 1.0)
    x, off, mask, w, _ = [torch.from_numpy(a) for a in args]
    g = torch.from_numpy(g)
    if case == "bf16 x":
        return (x.bfloat16(), off, mask, w, g), TypeError
    if case == "fp64 g":
        return (x, off, mask, w, g.double()), TypeError
    if case == "offset shape":
        return (x, off[..., :9].contiguous(), mask, w, g), ValueError
    if case == "weight Cin":
        return (x, off, mask, w[:, :, :3].contiguous(), g), ValueError
    if case == "g Cout":
        return (x, off, mask, w, g[..., :4].contiguous()), ValueError
    if case == "strided mask":
        wide = torch.zeros(1, 5, 6, 18)
        wide[..., ::2] = mask
        return (x, off, wide[..., ::2], w, g), ValueError
    raise AssertionError(case)


@pytest.mark.parametrize("wrapper", ["dcn_bwd_pom", "dcn_bwd_x"])
@pytest.mark.parametrize("case", ["bf16 x", "fp64 g", "offset shape", "weight Cin", "g Cout",
                                  "strided mask"])
def test_backward_wrappers_check_their_arguments(wrapper, case):
    args, err = _bad_args(case)
    with pytest.raises(err):
        getattr(dcn_cuda, wrapper)(*args, 3)


def test_dcn_module_function_path_matches_plain_autograd():
    """The DCN module through the Function (``impl="auto"``, CPU tensors)
    and through plain autograd of the clamped form (``impl="dense"``) give
    the same gradients to every parameter and to the input."""
    torch.manual_seed(0)
    mods = {impl: DCN(6, 5, impl=impl, radius=3) for impl in ("auto", "dense")}
    mods["dense"].load_state_dict(mods["auto"].state_dict())
    with torch.no_grad():
        for m in mods.values():  # non-zero offsets and masks
            torch.manual_seed(1)
            m.conv_offset_mask.weight.normal_(0, 0.3)
            m.conv_offset_mask.bias.normal_(0, 0.5)
    x0 = torch.randn(2, 6, 7, 9)
    grads = {}
    for impl, m in mods.items():
        x = x0.clone().requires_grad_()
        (m(x) ** 2).sum().backward()
        grads[impl] = [x.grad] + [p.grad for p in m.parameters()]
    for a, b in zip(grads["auto"], grads["dense"]):
        assert float((a - b).abs().max()) <= TOL * float(b.abs().max())
