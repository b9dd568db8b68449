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

The factorization tests hold the CUDA kernels' order of work, written here
in plain torch, to the same JAX VJPs on the R=2 inputs (one JAX result per
case, shared with the test above): grad_x as sum_k W_k G_k with G_k the
transposed gather of mask * g (K3), grad_mask and grad_offset from the tap
products U_k = g W_k^T formed chunk by chunk over Cin (K2's bwd_pom_kernel),
and grad_weight as (mask s_k)^T g summed over pixel ranges in order (K2's
bwd_weight_kernel). The NaN case goes to the dense form alone: the JAX
package's Pallas backward kernels do not drop a NaN tap (their gradients
there differ from the dense form's at the scale of the gradients).
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
from torch_port_common import one_torch_thread  # noqa: F401  (autouse)

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


def _case_inputs(B, H, W, C, Cout, off_scale, nan=False):
    args, g = _inputs(B, H, W, C, Cout, off_scale)
    if nan:  # NaN in tap 0's dy at one interior pixel and in tap 4's dx at another
        args[1][0, 3, 5, 0] = np.nan
        args[1][1, 6, 9, 9] = np.nan
    return args, g


@functools.lru_cache(maxsize=None)
def _jax_grads(B, H, W, C, Cout, R, off_scale, oracle, nan=False):
    """(out, grads of x, offset, mask, weight, bias) of the JAX oracle at
    cotangent g, as numpy; computed once per case."""
    args, g = _case_inputs(B, H, W, C, Cout, off_scale, nan)
    jargs = [jnp.asarray(a) for a in args]
    if oracle == "pallas":
        out, grads = _pallas_vjp(*jargs, jnp.asarray(g), R)
    else:
        out, vjp = jax.vjp(lambda *a: deform_conv2d_dense(*a, stride=1, padding=1, radius=R), *jargs)
        grads = vjp(jnp.asarray(g))
    return np.asarray(out), [np.asarray(t) for t in grads]


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
    for oracle in oracles:
        out_j, grads_j = _jax_grads(B, H, W, C, Cout, R, off_scale, oracle, False)
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
    pom = dcn_cuda.dcn_bwd_pom(x, off, mask, w, gt, 3)
    gx = dcn_cuda.dcn_bwd_x(x, off, mask, w, gt, 3)
    assert len(pom) == 3  # no tap products: the kernels keep U out of device memory
    for got, want in zip(pom, dcn_bwd_pom_plain(x, off, mask, w, gt, 3)):
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


@pytest.mark.parametrize("case", ["offset off 8 bytes", "radius -1", "K3 radius 5", "K2 radius 5"])
def test_backward_kernel_checks(case):
    """What only the kernels need, checked before a launch: offsets on an
    8-byte boundary (K3 reads them in pairs) and a radius of 0 to
    ``BWD_X_MAX_RADIUS`` for K3, any radius >= 0 for K2 (no halo). The
    check reads nothing but pointers and shapes, so CPU tensors stand in."""
    args, g = _inputs(1, 5, 6, 8, 8, 1.0)
    x, off, _, w, _ = [torch.from_numpy(a).clone() for a in args]  # torch's aligned storage
    g = torch.from_numpy(g).clone()
    r, top, err = {"offset off 8 bytes": (3, None, ValueError), "radius -1": (-1, None, ValueError),
                   "K3 radius 5": (5, dcn_cuda.BWD_X_MAX_RADIUS, ValueError),
                   "K2 radius 5": (5, None, None)}[case]
    if case == "offset off 8 bytes":
        off = torch.zeros(off.numel() + 1)[1:].view(off.shape)
        assert off.is_contiguous() and off.data_ptr() % 8 == 4
    if err is None:
        dcn_cuda._check_bwd_kernel(x, off, w, g, r, top)
        dcn_cuda._check_bwd_kernel(x, off, w, g, dcn_cuda.BWD_X_MAX_RADIUS,
                                   dcn_cuda.BWD_X_MAX_RADIUS)
    else:
        with pytest.raises(err):
            dcn_cuda._check_bwd_kernel(x, off, w, g, r, top)


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


# ---------------------------------------------------------------------------
# The kernels' factorizations in plain torch, against JAX's VJPs

# the R=2 inputs of test_function_grads_match_jax_vjps, and one with NaN offsets
FACTOR_SHAPE = (2, 8, 16, 8, 12)
FACTOR_R = 2
FACTOR_CASES = {
    "plain": (0.9, False, ("pallas", "dense")),
    "clipped": (4.0, False, ("pallas", "dense")),
    "integer": (0.0, False, ("pallas", "dense")),
    "nan": (0.9, True, ("dense",)),
}


def _sampling(x, off, mask, R):
    """Per pixel and tap, as the kernels compute them: the four corners
    (flat pixel index, inside the image) with their bilinear weights in the
    order (y0, x0), (y0, x0+1), (y0+1, x0), (y0+1, x0+1); the fractions; and
    whether the clip passes each offset's gradient. A NaN tap has every
    corner outside."""
    B, H, W, _ = x.shape
    o = off.reshape(B, H, W, 9, 2)
    drop = torch.isnan(o).any(-1)
    o = torch.where(drop[..., None], torch.zeros_like(o), o)
    inside = (o.abs() <= R) & ~drop[..., None]
    o = o.clamp(-R, R)
    whole = torch.floor(o)
    ly, lx = (o - whole).unbind(-1)
    k = torch.arange(9)
    y0 = torch.arange(H).view(1, H, 1, 1) + k // 3 - 1 + whole[..., 0].long()
    x0 = torch.arange(W).view(1, 1, W, 1) + k % 3 - 1 + whole[..., 1].long()
    img = (torch.arange(B) * H * W).view(B, 1, 1, 1)
    corners = []
    for cy, cx, wgt in ((0, 0, (1 - ly) * (1 - lx)), (0, 1, (1 - ly) * lx),
                        (1, 0, ly * (1 - lx)), (1, 1, ly * lx)):
        yc, xc = y0 + cy, x0 + cx
        ok = (yc >= 0) & (yc < H) & (xc >= 0) & (xc < W) & ~drop
        idx = img + yc.clamp(0, H - 1) * W + xc.clamp(0, W - 1)
        corners.append((idx.reshape(-1, 9), ok.reshape(-1, 9), wgt.reshape(-1, 9)))
    return corners, ly.reshape(-1, 9), lx.reshape(-1, 9), inside.reshape(-1, 9, 2)


def _factor_case(name):
    off_scale, nan, oracles = FACTOR_CASES[name]
    args, g = _case_inputs(*FACTOR_SHAPE, off_scale, nan)
    x, off, mask, w, _ = map(torch.from_numpy, args)
    return (x, off, mask, w, torch.from_numpy(g)), [
        (oracle, _jax_grads(*FACTOR_SHAPE, FACTOR_R, off_scale, oracle, nan)[1]) for oracle in oracles]


def _grad_x_transposed_gather(x, off, mask, w, g, R):
    """K3's order: G_k(q) = sum_p coef_k(p -> q) mask_k(p) g(p), then
    grad_x = sum_k G_k W_k^T."""
    B, H, W, Cin = x.shape
    P, Cout = B * H * W, w.shape[3]
    corners, *_ = _sampling(x, off, mask, R)
    gf, m, wk = g.reshape(P, Cout), mask.reshape(P, 9), w.reshape(9, Cin, Cout)
    gx = torch.zeros(P, Cin)
    for k in range(9):
        G = torch.zeros(P, Cout)
        for idx, ok, wgt in corners:
            coef = torch.where(ok[:, k], wgt[:, k] * m[:, k], torch.zeros(P))
            G.index_add_(0, idx[:, k], coef[:, None] * gf)
        gx += G @ wk[k].T
    return gx.reshape(B, H, W, Cin)


def _samples(x, corners, ly, lx, k, c0, c1):
    """s, ds/dy and ds/dx of tap k for channels [c0, c1) of every pixel."""
    xf = x.reshape(-1, x.shape[3])[:, c0:c1]
    v00, v01, v10, v11 = [xf[idx[:, k]] * ok[:, k, None] for idx, ok, _ in corners]
    fy, fx = ly[:, k, None], lx[:, k, None]
    top = (1 - fx) * v00 + fx * v01
    bot = (1 - fx) * v10 + fx * v11
    return (1 - fy) * top + fy * bot, bot - top, (1 - fy) * (v01 - v00) + fy * (v11 - v10)


def _grad_pom_chunked(x, off, mask, w, g, R, chunk=3):
    """K2's bwd_pom_kernel order: for each chunk of input channels, that
    chunk of U_k = g W_k^T, and the three dot products of U_k with s,
    ds/dy and ds/dx added over the chunks."""
    B, H, W, Cin = x.shape
    P, Cout = B * H * W, w.shape[3]
    corners, ly, lx, inside = _sampling(x, off, mask, R)
    gf, m, wk = g.reshape(P, Cout), mask.reshape(P, 9), w.reshape(9, Cin, Cout)
    gm, go = torch.zeros(P, 9), torch.zeros(P, 9, 2)
    for k in range(9):
        ss, sy, sx = torch.zeros(P), torch.zeros(P), torch.zeros(P)
        for c0 in range(0, Cin, chunk):
            c1 = min(Cin, c0 + chunk)
            u = gf @ wk[k, c0:c1].T
            s, dsy, dsx = _samples(x, corners, ly, lx, k, c0, c1)
            ss, sy, sx = ss + (u * s).sum(1), sy + (u * dsy).sum(1), sx + (u * dsx).sum(1)
        gm[:, k] = ss
        go[:, k] = torch.where(inside[:, k], m[:, k, None] * torch.stack([sy, sx], 1), torch.zeros(P, 2))
    return go.reshape(B, H, W, 18), gm.reshape(B, H, W, 9)


def _grad_weight_ranges(x, off, mask, w, g, R, pixels=37):
    """K2's bwd_weight_kernel order: grad_weight_k = sum over pixel ranges,
    in range order, of (mask s_k)^T g."""
    B, H, W, Cin = x.shape
    P, Cout = B * H * W, w.shape[3]
    corners, ly, lx, _ = _sampling(x, off, mask, R)
    gf, m = g.reshape(P, Cout), mask.reshape(P, 9)
    gw = torch.zeros(9, Cin, Cout)
    for k in range(9):
        ms = m[:, k, None] * _samples(x, corners, ly, lx, k, 0, Cin)[0]
        for p0 in range(0, P, pixels):
            gw[k] += ms[p0:p0 + pixels].T @ gf[p0:p0 + pixels]
    return gw.reshape(3, 3, Cin, Cout)


@pytest.mark.parametrize("case", list(FACTOR_CASES))
def test_grad_x_as_transposed_gather_matches_jax(case):
    args, oracles = _factor_case(case)
    got = _grad_x_transposed_gather(*args, FACTOR_R).numpy()
    for oracle, grads in oracles:
        _close(got, grads[0], f"{oracle} grad x")


@pytest.mark.parametrize("case", list(FACTOR_CASES))
def test_grad_offset_and_mask_from_chunked_tap_products_match_jax(case):
    args, oracles = _factor_case(case)
    go, gm = (t.numpy() for t in _grad_pom_chunked(*args, FACTOR_R))
    for oracle, grads in oracles:
        _close(go, grads[1], f"{oracle} grad offset")
        _close(gm, grads[2], f"{oracle} grad mask")
    off = args[1].numpy()
    if case == "clipped":  # the clip stops grad_offset and only it
        assert (np.abs(off) > FACTOR_R).mean() > 0.3 and np.all(go[np.abs(off) > FACTOR_R] == 0.0)
    if case == "integer":  # the forward difference at integer positions, not zero
        assert np.abs(go).max() > 0.1
    if case == "nan":  # a dropped tap gets nothing
        assert go[0, 3, 5, 0:2].tolist() == [0.0, 0.0] and gm[0, 3, 5, 0] == 0.0
        assert go[1, 6, 9, 8:10].tolist() == [0.0, 0.0] and gm[1, 6, 9, 4] == 0.0


@pytest.mark.parametrize("case", list(FACTOR_CASES))
def test_grad_weight_from_pixel_ranges_matches_jax(case):
    args, oracles = _factor_case(case)
    got = _grad_weight_ranges(*args, FACTOR_R).numpy()
    for oracle, grads in oracles:
        _close(got, grads[3], f"{oracle} grad weight")


def test_factor_inputs_reach_outside_the_image():
    """The factorization cases sample corners outside the image (which read
    zero and receive nothing) at every offset scale."""
    for case in FACTOR_CASES:
        (x, off, mask, *_), _ = _factor_case(case)
        corners, *_ = _sampling(x, off, mask, FACTOR_R)
        assert sum(int((~ok).sum()) for _, ok, _ in corners) > 0, case
