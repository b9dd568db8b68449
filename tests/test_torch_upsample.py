"""The decoder's upsampling with its skip add (``ops/upsample_cuda.py``) on
the CPU: the plain version, the polyphase taps the CUDA kernel
(``csrc/upsample.cu``) computes, the autograd Function, the wrapper's
checks, and the module's parameters.

The kernel itself runs only on the card; ``chip_smoke.py`` (phase
``upsample``) compares it there with :func:`upsample_add_plain`. Here the
taps are written out as the kernel indexes them, in numpy, and held to the
JAX package's ``BilinearUp`` on the same inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from dcd_tpu.models.layers import BilinearUp
from dcd_tpu_torch.models.dla import IDAUp
from dcd_tpu_torch.models.layers import ConvTranspose2d, bilinear_up
from dcd_tpu_torch.ops import dcn_cuda, upsample_cuda
from dcd_tpu_torch.utils import cuda_build
from dcd_tpu_torch.ops.upsample_cuda import UpsampleAddFunction, upsample_add, upsample_add_plain
from portbench.reference.dla import IDAUp as ReferenceIDAUp
from torch_port_common import one_torch_thread  # noqa: F401  (autouse)


def _inputs(f, C=8, B=2, H=3, W=5, seed=0, dtype=torch.float32):
    """x and skip channels-last (as the detector hands them over), random
    per-channel weights (C, 1, 2f, 2f) fp32."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(B, H, W, C).astype(np.float32)).to(dtype).permute(0, 3, 1, 2)
    skip = torch.from_numpy(rng.randn(B, f * H, f * W, C).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.randn(C, 1, 2 * f, 2 * f).astype(np.float32))
    return x, w, skip.permute(0, 3, 1, 2)


def _taps(a, f):
    """(kernel index, input shift) of output phase a, as the kernel's
    second_tap computes them."""
    k0 = a + f // 2
    return [(k0, 0), (k0 + f, -1) if k0 < f else (k0 - f, 1)]


def polyphase(x, w, f):
    """The kernel's sum, per output pixel (f i + a, f j + b): x (B, H, W, C),
    w (C, 1, 2f, 2f); zeros outside the map; fp32."""
    B, H, W, C = x.shape
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    out = np.zeros((B, f * H, f * W, C), np.float32)
    for a in range(f):
        for b in range(f):
            acc = np.zeros((B, H, W, C), np.float32)
            for kh, di in _taps(a, f):
                for kw, dj in _taps(b, f):
                    acc += w[:, 0, kh, kw] * xp[:, 1 + di:1 + di + H, 1 + dj:1 + dj + W]
            out[:, a::f, b::f] = acc
    return out


@pytest.mark.parametrize("f", [2, 4])
def test_plain_path_is_the_transposed_conv_and_the_add(f):
    x, w, skip = _inputs(f)
    ref = nn.ConvTranspose2d(8, 8, 2 * f, stride=f, padding=f // 2, groups=8, bias=False)
    up = ConvTranspose2d(8, f)
    with torch.no_grad():
        ref.weight.copy_(w)
        up.weight.copy_(w)
        want = ref(x) + skip
        got = up(x, skip)
    assert got.shape == (2, 8, 3 * f, 5 * f)
    assert torch.equal(got, want)
    before = dict(upsample_add.launches_by_kernel)
    assert torch.equal(upsample_add(x, w, skip, f), want)
    assert upsample_add.launches_by_kernel == before  # no kernel on the CPU


@pytest.mark.parametrize("f", [2, 4])
def test_polyphase_taps_match_jax_bilinear_up(f):
    x, w, skip = _inputs(f, H=4, W=6, seed=f)
    x_nhwc = x.permute(0, 2, 3, 1).numpy()
    m = BilinearUp(f)
    jax_w = jnp.asarray(np.transpose(w.numpy(), (2, 3, 1, 0)))  # (2f, 2f, 1, C)
    want = np.asarray(m.apply({"params": {"kernel": jax_w}}, jnp.asarray(x_nhwc)))
    got = polyphase(x_nhwc, w.numpy(), f)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    plain = upsample_add_plain(x, w, skip, f) - skip
    np.testing.assert_allclose(plain.permute(0, 2, 3, 1).numpy(), got, rtol=0, atol=1e-5)


@pytest.mark.parametrize("f", [2, 4])
def test_function_grads_match_autograd_of_the_plain_version(f):
    x, w, skip = (t.double().contiguous().requires_grad_() for t in _inputs(f, C=2, B=1, H=2, W=3))
    assert torch.autograd.gradcheck(lambda a, b, c: UpsampleAddFunction.apply(a, b, c, f),
                                    (x, w, skip))
    for dtype in (torch.float32, torch.bfloat16):
        x, w, skip = (t.detach().requires_grad_() for t in _inputs(f, dtype=dtype))
        g = torch.randn(2, 8, 3 * f, 5 * f, generator=torch.Generator().manual_seed(1)).to(dtype)
        out = UpsampleAddFunction.apply(x, w, skip, f)
        got = torch.autograd.grad(out, (x, w, skip), g)
        want = torch.autograd.grad(upsample_add_plain(x, w, skip, f), (x, w, skip), g)
        assert out.dtype == dtype and [t.dtype for t in got] == [dtype, torch.float32, dtype]
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def _bad_cases():
    x, w, skip = _inputs(2)
    nchw = x.contiguous()
    assert not nchw.is_contiguous(memory_format=torch.channels_last)
    x12, w12, skip12 = _inputs(2, C=12)
    return {
        "x_not_channels_last": ((nchw, w, skip, 2), ValueError, "channels-last"),
        "skip_not_channels_last": ((x, w, skip.contiguous(), 2), ValueError, "channels-last"),
        "channels_not_multiple_of_8": ((x12, w12, skip12, 2), ValueError, "multiple of 8"),
        "float64": ((x.double(), w, skip.double(), 2), TypeError, "float32 or bfloat16"),
        "float16": ((x.half(), w, skip.half(), 2), TypeError, "float32 or bfloat16"),
        "factor_3": ((x, w, skip, 3), ValueError, "factor"),
        "skip_other_type": ((x, w, skip.bfloat16(), 2), ValueError, "skip must be"),
        "skip_other_shape": ((x, w, skip[:, :, :-1], 2), ValueError, "skip must be"),
        "skip_other_device": ((x, w, skip.to("meta"), 2), ValueError, "skip must be on"),
        "weight_other_shape": ((x, w[:, :, :3], skip, 2), ValueError, "weight must be"),
    }


@pytest.mark.parametrize("case", sorted(_bad_cases()))
def test_kernel_checks_refuse_what_it_does_not_take(case):
    args, err, match = _bad_cases()[case]
    x, w, skip = _inputs(2)
    upsample_cuda._check(x, w, skip, 2)
    upsample_cuda._check(x.bfloat16(), w, skip.bfloat16(), 2)
    with pytest.raises(err, match=match):
        upsample_cuda._check(*args)


def test_no_kernel_for_another_device():
    x, w, skip = (t.to("meta") for t in _inputs(2))
    with pytest.raises(ValueError, match="no kernel"):
        upsample_add(x, w, skip, 2)


def test_launch_counter_resets_with_the_dcn_counters():
    """Each wrapper's ``launches_by_kernel`` reads the library's counts of its
    own entry points, and one reset zeroes them all."""
    counts = cuda_build._launches
    counts.update({"upsample_add_bf16": 3, "dcn_fwd_f32": 2})
    assert upsample_add.launches_by_kernel == {"upsample_add_f32": 0, "upsample_add_bf16": 3}
    assert dict(dcn_cuda.deform_conv2d.launches_by_kernel) == {"dcn_fwd_f32": 2, "dcn_fwd_bf16": 0}
    dcn_cuda.reset_launch_counts()
    assert upsample_add.launches_by_kernel == {"upsample_add_f32": 0, "upsample_add_bf16": 0}
    assert not any(dcn_cuda.deform_conv2d.launches_by_kernel.values())


def test_ida_up_parameters_are_the_reference_ones():
    """The upsampling keeps the reference's ``up_k.weight`` (C, 1, 2f, 2f):
    a reference state dict loads strictly, and the IDAUp computes what the
    reference's transposed conv and add compute."""
    torch.manual_seed(0)
    ref = ReferenceIDAUp(8, [8, 16, 16], [1, 2, 4], 3).eval()
    port = IDAUp(8, [8, 16, 16], [1, 2, 4], "auto", 3).eval()
    want = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == want
    assert want["up_1.weight"] == (8, 1, 4, 4) and want["up_2.weight"] == (8, 1, 8, 8)
    with torch.no_grad():
        for name, p in ref.named_parameters():
            if name.startswith("up_"):
                p.add_(0.1 * torch.randn_like(p))
    port.load_state_dict(ref.state_dict(), strict=True)
    assert isinstance(port.up_2, ConvTranspose2d) and port.up_2.stride == (4, 4)
    layers = [torch.randn(1, c, 16 >> i, 32 >> i).contiguous(memory_format=torch.channels_last)
              for i, c in enumerate([8, 16, 16])]
    with torch.no_grad():
        got = port(layers, 0, 3)[-1]
        want_out = ref(layers, 0, 3)[-1]
    torch.testing.assert_close(got, want_out, rtol=1e-5, atol=1e-5)
    assert torch.equal(bilinear_up(8, 4).weight, torch.from_numpy(
        np.outer(*[np.array([0.125, 0.375, 0.625, 0.875, 0.875, 0.625, 0.375, 0.125])] * 2)
    ).float().expand(8, 1, 8, 8))
