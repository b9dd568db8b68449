"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing one line with its own seconds:

1. device: a CUDA card is required; prints ``nvidia-smi``'s name and power
   limit.
2. build: the one ``nvcc`` call that builds ``dcd_tpu_torch/csrc/*.cu``;
   prints ``-Xptxas -v``'s registers and spills.
3. kernel: the deformable-conv kernel against its plain PyTorch version at
   the seven DCN shapes of a 384x1280 forward at the main path's batch, in
   fp32 (max abs err <= 1e-4 of the output's largest magnitude, TF32 off)
   and bf16 (<= 2e-2), timed with CUDA events around 5 back-to-back calls
   (median of 10 turns of plain, kernel, kernel, plain after a warm-up).
4. main path: ``build_detector(dgde_run_config())`` with seeded random
   weights, trained-checkpoint offset statistics and BN statistics
   calibrated on the batch; ``infer`` on 2 images of 384x1280 with the
   boundary ring of a 1242x375 KITTI frame. The rows must be finite and
   (2, 50, 14), and the kernel's launch counter must read 16 for the one
   forward. The same forward with the plain DCN must give the same heatmap
   and peaks (<= 1e-4 of the largest magnitude). Then the forward is timed
   (median of 5) and profiled once: device time by kernel kind and the
   device's busy share.

5. backward kernels: K2 (``dcn_bwd_pom``: grad offset, mask and weight)
   and K3 (``dcn_bwd_x``: grad x) against their plain versions (autograd of
   the clamped form) at the same seven shapes, fp32 with TF32 off, offsets
   of std 1.5 px (some beyond the clamp): max abs err <= 1e-4 of each
   output's largest magnitude (fp32 sums reassociated over up to 9 * Cout
   terms, and over all B*H*W pixels for grad_weight). Each kernel runs
   twice and the two results must be bitwise equal. Timed as phase 3 times
   the forward (K3 with its own tap products, as it runs alone).
6. train path: ``build_trainer(dgde_run_config(), device="cuda")`` at full
   width and depth, 384x1280, on 2 port-encoded synthetic KITTI scenes of
   1242x375 with 6 cars each (``ims_per_batch`` cut from 8 to 2). Step 0
   (every offset exactly 0, the offset convs start at zero) is taken once
   with the kernels and once with the plain DCN from one deep copy: every
   loss term must agree to 1e-4 relative and every gradient to 1e-3 of its
   tensor's largest magnitude, with the exceptions ``step_parity`` states
   (and 1e-2 for the gradients of the check after 3 steps, whose reason
   LATE_STEP_GRAD_TOL gives).
   Then 3 steps: finite losses, 16 launches of each kernel per step, a
   finite gradient for every parameter and a non-zero one for every DCN
   weight and offset conv; the parity check again after them, at non-zero
   offsets; the step time (median of 5) and one profiled step.

It prints the kernels' JSON line, the card's name and power limit, and as
the last line ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero before that. A ``[details]`` line before them holds every
number the run took, as JSON; ``build/chip_smoke_details.json`` holds the
same with every profiled kernel by name.
"""

import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from dcd_tpu_torch.config import dgde_run_config
from dcd_tpu_torch.data.edges import KITTI_IMAGE_SIZE, KITTI_P2, padded_edge_indices
from dcd_tpu_torch.data.synthetic import make_scene
from dcd_tpu_torch.data.target_encoder import collate, encode_targets
from dcd_tpu_torch.engine.infer import build_detector, format_kitti_lines, infer
from dcd_tpu_torch.engine.train import build_trainer, compute_gradients, train_step
from dcd_tpu_torch.models.layers import DCN
from dcd_tpu_torch.ops import dcn_cuda
from dcd_tpu_torch.ops.dcn import dcn_bwd_pom_plain, dcn_bwd_x_plain, deform_conv2d_clamped
from dcd_tpu_torch.utils import cuda_build
from dcd_tpu_torch.utils.weights import calibrate_batch_norm, realistic_offsets

BATCH = 2
RADIUS = 3
DETAILS_FILE = Path(__file__).resolve().parent / "build" / "chip_smoke_details.json"
# (Cin, Cout, H, W, DCN blocks) of one 384x1280 forward of dgde_run_config
DCN_SHAPES = [
    (512, 256, 12, 40, 1),
    (256, 256, 24, 80, 1),
    (256, 128, 24, 80, 2),
    (256, 64, 24, 80, 1),
    (128, 128, 48, 160, 2),
    (128, 64, 48, 160, 4),
    (64, 64, 96, 320, 5),
]
FP32_TOL, BF16_TOL, PATH_TOL = 1e-4, 2e-2, 1e-4
BWD_TOL = 1e-4
TRAIN_STEPS = 3
# kernel-vs-plain train step: loss terms relative, gradients of each
# tensor's largest magnitude; the pair-depth terms and the heads feeding the
# pair solve are ill-conditioned and switched (see step_parity). At step 0
# every run starts from the same state (measured 2.55e-4 of scale in two
# runs). After 3 steps the state differs from run to run, since cuDNN's
# backward and the scatters of the gathers' backward add in no fixed order,
# and the same comparison read 4.1e-4 in one run and 2.4e-3 in another: a
# rounding-size change moves this step's gradients by that much (on the
# CPU, a 1e-7 perturbation of the weights moves them by up to 3.2e-4 of
# scale, tests/test_torch_train.py). The later state gets 1e-2.
STEP_LOSS_TOL, STEP_GRAD_TOL, LATE_STEP_GRAD_TOL = 1e-4, 1e-3, 1e-2
PAIR_LOSS_TOL, PAIR_HEADS_FRO_TOL = 5e-3, 5e-2
PAIR_TERMS = ("pairs_kpts_depth_loss", "extra_all_MAE", "edges_MAE", "corner_loss")
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# device kernels by kind, first match wins (cuDNN names its BN and layout
# kernels too, so those come before the convolutions)
KERNEL_KINDS = [
    ("dcn_fwd", ("dcn_fwd_kernel",)),
    ("dcn_bwd_pom", ("tap_products_kernel", "bwd_pom_kernel", "bwd_weight_kernel",
                     "bwd_weight_reduce_kernel")),
    ("dcn_bwd_x", ("bwd_x_kernel",)),
    # BN's kernels, and the Welford reductions of its running statistics
    ("batch_norm", ("bn_fw", "bn_bw", "batch_norm", "batchnorm", "welford")),
    ("optimizer", ("multi_tensor_apply", "adam")),
    ("layout", ("nhwctonchw", "nchwtonhwc")),
    ("convolution", ("conv", "xmma", "gemm", "dgrad", "wgrad", "cutlass")),
    ("copy", ("memcpy", "memset")),
]


def say(phase, seconds, text):
    print(f"[{phase}] {seconds:.2f} s  {text}", flush=True)


def dcn_inputs(cin, cout, h, w, gen):
    """Seeded inputs on the card; offsets of std 1.5 px, so that some exceed
    +-R (the clamp) and some point outside the image (the zero padding)."""
    def randn(*shape):
        return torch.randn(shape, generator=gen)

    x = randn(BATCH, h, w, cin)
    off = randn(BATCH, h, w, 18) * 1.5
    mask = torch.sigmoid(randn(BATCH, h, w, 9))
    weight = randn(3, 3, cin, cout) / (9 * cin) ** 0.5
    bias = randn(cout) * 0.1
    return [t.cuda().contiguous() for t in (x, off, mask, weight, bias)]


def cuda_ms(fn, reps=5):
    """Device ms of one call: ``reps`` calls queued back to back between two
    CUDA events, so that the host's cost of a launch overlaps the device's
    work instead of landing between the events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(cin, cout, h, w):
    """Least time for the function at this shape in fp32: each input read
    once and the output written once over HBM, or its operations (the
    contraction plus 4 FMAs per sampled channel) at the fp32 peak."""
    p = BATCH * h * w
    nbytes = 4 * (p * (cin + 18 + 9 + cout) + 9 * cin * cout + cout)
    flops = 2 * p * 9 * cin * (cout + 4)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def phase_kernel():
    gen = torch.Generator().manual_seed(0)
    rows = []
    for cin, cout, h, w, count in DCN_SHAPES:
        t0 = time.perf_counter()
        x, off, mask, weight, bias = dcn_inputs(cin, cout, h, w, gen)
        got = dcn_cuda.deform_conv2d(x, off, mask, weight, bias, RADIUS)
        want = deform_conv2d_clamped(x, off, mask, weight, bias, RADIUS)
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        if not err <= FP32_TOL * scale:
            raise AssertionError(f"fp32 {cin}->{cout}@{h}x{w}: max abs err {err} > {FP32_TOL} x {scale}")
        xb, mb, wb, bb = (t.bfloat16() for t in (x, mask, weight, bias))
        got_b = dcn_cuda.deform_conv2d(xb, off, mb, wb, bb, RADIUS).float()
        want_b = deform_conv2d_clamped(xb, off, mb, wb, bb, RADIUS).float()
        torch.cuda.synchronize()
        scale_b = float(want_b.abs().max())
        err_b = float((got_b - want_b).abs().max())
        if not err_b <= BF16_TOL * scale_b:
            raise AssertionError(f"bf16 {cin}->{cout}@{h}x{w}: max abs err {err_b} > {BF16_TOL} x {scale_b}")

        def kernel():
            dcn_cuda.deform_conv2d(x, off, mask, weight, bias, RADIUS)

        def plain():
            deform_conv2d_clamped(x, off, mask, weight, bias, RADIUS)

        kernel(), plain()
        t_k, t_p = [], []
        for _ in range(10):
            t_p.append(cuda_ms(plain))
            t_k.append(cuda_ms(kernel))
            t_k.append(cuda_ms(kernel))
            t_p.append(cuda_ms(plain))
        b_ms, b_by = bound_ms(cin, cout, h, w)
        row = dict(cin=cin, cout=cout, h=h, w=w, batch=BATCH, count=count,
                   fp32_max_abs_err=err, fp32_scale=scale, bf16_max_abs_err=err_b,
                   bf16_scale=scale_b, ms=statistics.median(t_k),
                   plain_ms=statistics.median(t_p), bound_ms=b_ms, bound_by=b_by)
        rows.append(row)
        say("kernel", time.perf_counter() - t0,
            f"{cin}->{cout} @ {BATCH}x{h}x{w} x{count}: fp32 err {err:.3g} (max {scale:.3g}), "
            f"bf16 err {err_b:.3g} (max {scale_b:.3g}); kernel {row['ms']:.4f} ms, "
            f"plain {row['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return rows


def device_breakdown(fn):
    """Device time by kernel kind over one call of ``fn`` (torch.profiler),
    the top kernels, and the device's busy share of the call's wall time
    (the profiler's own cost inflates the wall time a little)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_kind, by_name = {}, {}
    for e in prof.events():
        # a record_function span (the optimizer's step) is mirrored on the
        # device as an annotation over the kernels it launched: not a kernel
        if e.device_type != torch.autograd.DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        ms = e.time_range.elapsed_us() / 1e3
        low = e.name.lower()
        kind = next((k for k, marks in KERNEL_KINDS if any(m in low for m in marks)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + ms
    device_ms = sum(by_kind.values())
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1])
    return dict(wall_ms=wall_ms, device_ms=device_ms, busy_share=device_ms / wall_ms,
                by_kind=by_kind, top=kernels[:8], kernels=kernels)


def set_dcn_impl(model, impl):
    for m in model.modules():
        if isinstance(m, DCN):
            m.impl = impl


def phase_main_path():
    t0 = time.perf_counter()
    cfg = dgde_run_config()
    H, W = cfg.input.height_train, cfg.input.width_train
    gen = torch.Generator().manual_seed(0)
    model = build_detector(cfg, device="cuda", seed=0)
    realistic_offsets(model, gen)
    images = torch.randn((BATCH, H, W, 3), generator=gen).cuda()
    img_w, img_h = KITTI_IMAGE_SIZE
    pad = np.array([(W - img_w) // 2, (H - img_h) // 2])
    ring, n = padded_edge_indices(KITTI_IMAGE_SIZE, pad, cfg.max_edge_length)
    edge_idx = torch.from_numpy(np.tile(ring[None], (BATCH, 1, 1))).cuda()
    edge_len = torch.full((BATCH,), n, dtype=torch.long).cuda()
    calib = torch.tensor(np.tile(KITTI_P2[None], (BATCH, 1, 1)), dtype=torch.float32)
    pad_t = torch.tensor(np.tile(pad[None], (BATCH, 1)), dtype=torch.float32)
    size_t = torch.tensor([[img_w, img_h]] * BATCH, dtype=torch.float32)
    calibrate_batch_norm(model, images, edge_idx, edge_len)
    torch.cuda.synchronize()
    say("main path", time.perf_counter() - t0,
        f"detector built on {torch.cuda.get_device_name(0)}, ring of {n} pixels")

    t0 = time.perf_counter()
    dcn_cuda.deform_conv2d.launches = 0
    out = infer(model, images, edge_idx, edge_len, calib, pad_t, size_t)
    torch.cuda.synchronize()
    launches = dcn_cuda.deform_conv2d.launches
    dets = out["dets"]
    if tuple(dets.shape) != (BATCH, 50, 14) or not bool(torch.isfinite(dets).all()):
        raise AssertionError(f"rows {tuple(dets.shape)}, finite={bool(torch.isfinite(dets).all())}")
    if launches != 16:
        raise AssertionError(f"the DCN kernel launched {launches} times in one forward, not 16")
    lines = format_kitti_lines(dets[0].cpu(), out["valid"][0].cpu(), cfg.datasets.detect_classes)
    say("main path", time.perf_counter() - t0,
        f"rows {tuple(dets.shape)} finite, {launches} kernel launches, "
        f"{int(out['valid'].sum())} valid rows, {len(lines)} KITTI lines in image 0")

    t0 = time.perf_counter()
    args = (images, edge_idx, edge_len)
    with torch.no_grad():
        k = model(*args, lazy_topk=True)
        set_dcn_impl(model, "plain")
        p = model(*args, lazy_topk=True)
        set_dcn_impl(model, "cuda")
    torch.cuda.synchronize()
    errs = {}
    for key in ("cls", "scores"):
        errs[key] = float((k[key] - p[key]).abs().max()) / float(p[key].abs().max())
    same_peaks = bool(torch.equal(k["points_xy"], p["points_xy"]))
    if same_peaks:
        errs["reg_pois"] = float((k["reg_pois"] - p["reg_pois"]).abs().max()) / float(p["reg_pois"].abs().max())
    if not same_peaks or max(errs.values()) > PATH_TOL:
        raise AssertionError(f"kernel vs plain forward: same peaks {same_peaks}, rel errs {errs}")
    say("main path", time.perf_counter() - t0,
        f"kernel vs plain forward: same 50 peaks, rel err {errs} (tol {PATH_TOL})")

    t0 = time.perf_counter()
    times = []
    for _ in range(6):
        t1 = time.perf_counter()
        infer(model, images, edge_idx, edge_len, calib, pad_t, size_t)["dets"].cpu()
        times.append(time.perf_counter() - t1)
    fwd_s = statistics.median(times[1:])
    say("main path", time.perf_counter() - t0,
        f"forward + postprocess at batch {BATCH}: median {fwd_s * 1e3:.2f} ms, "
        f"{BATCH / fwd_s:.2f} images/s")

    t0 = time.perf_counter()
    prof = device_breakdown(lambda: infer(model, images, edge_idx, edge_len, calib, pad_t, size_t))
    kinds = ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(prof["by_kind"].items()))
    say("main path", time.perf_counter() - t0,
        f"profiled forward: wall {prof['wall_ms']:.2f} ms, device {prof['device_ms']:.2f} ms "
        f"(busy {100 * prof['busy_share']:.1f}%): {kinds}")
    return dict(launches=launches, forward_ms=fwd_s * 1e3, images_per_s=BATCH / fwd_s,
                forward_ms_all=[t * 1e3 for t in times],
                kernel_vs_plain_rel_err=errs, valid_rows=int(out["valid"].sum()), profile=prof)


def bwd_bound_ms(cin, cout, h, w):
    """Least times of the two backward functions at this shape in fp32, as
    (K2 ms, K2 bound, K3 ms, K3 bound). Bytes: each input read once, each
    output written once. Operations, counted from dcn_bwd.cu: the tap
    products U = W g (2 * 9 * Cin * Cout per pixel, in both functions, since
    each runs alone here), grad_weight's contraction (the same again, K2),
    21 per pixel, tap and input channel for the samples, their offset
    derivatives and the three products with U (K2's bwd_pom_kernel), 8 for
    grad_weight's samples (K2), and 8 for K3's four corner FMAs."""
    p = BATCH * h * w
    contraction = 2 * p * 9 * cin * cout
    k2_bytes = 4 * (p * (cin + 18 + 9 + cout) + 9 * cin * cout + p * (18 + 9) + 9 * cin * cout)
    k2_ops = 2 * contraction + (21 + 8) * p * 9 * cin
    k3_bytes = 4 * (p * (18 + 9 + cout) + 9 * cin * cout + p * cin)
    k3_ops = contraction + 8 * p * 9 * cin
    out = []
    for nbytes, ops in ((k2_bytes, k2_ops), (k3_bytes, k3_ops)):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
        out += [1e3 * max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"]
    return out


def _rel_err(got, want):
    """max |got - want| and the largest |want|."""
    return float((got - want).abs().max()), float(want.abs().max())


def phase_backward():
    gen = torch.Generator().manual_seed(1)
    rows = []
    for cin, cout, h, w, count in DCN_SHAPES:
        t0 = time.perf_counter()
        x, off, mask, weight, _ = dcn_inputs(cin, cout, h, w, gen)
        g = torch.randn((BATCH, h, w, cout), generator=gen).cuda()
        go, gm, gw, u = dcn_cuda.dcn_bwd_pom(x, off, mask, weight, g, RADIUS)
        gx = dcn_cuda.dcn_bwd_x(x, off, mask, weight, g, RADIUS)
        again = dcn_cuda.dcn_bwd_pom(x, off, mask, weight, g, RADIUS)
        gx_again = dcn_cuda.dcn_bwd_x(x, off, mask, weight, g, RADIUS)
        gx_shared = dcn_cuda.dcn_bwd_x(x, off, mask, weight, g, RADIUS, u)
        want = dict(zip(("grad_offset", "grad_mask", "grad_weight"),
                        dcn_bwd_pom_plain(x, off, mask, weight, g, RADIUS)))
        want["grad_x"] = dcn_bwd_x_plain(x, off, mask, weight, g, RADIUS)
        torch.cuda.synchronize()
        got = dict(grad_offset=go, grad_mask=gm, grad_weight=gw, grad_x=gx)
        errs = {}
        for name, t in got.items():
            err, scale = _rel_err(t, want[name])
            errs[name] = dict(max_abs_err=err, scale=scale)
            if not err <= BWD_TOL * scale:
                raise AssertionError(f"{name} {cin}->{cout}@{h}x{w}: max abs err {err} > "
                                     f"{BWD_TOL} x {scale}")
        for a, b, name in ((go, again[0], "grad_offset"), (gm, again[1], "grad_mask"),
                           (gw, again[2], "grad_weight"), (u, again[3], "tap products"),
                           (gx, gx_again, "grad_x"), (gx, gx_shared, "grad_x from K2's U")):
            if not (a is b is None or torch.equal(a, b)):  # U is None on the CPU only
                raise AssertionError(f"{name} {cin}->{cout}@{h}x{w}: two runs differ")

        def k2():
            dcn_cuda.dcn_bwd_pom(x, off, mask, weight, g, RADIUS)

        def k3():
            dcn_cuda.dcn_bwd_x(x, off, mask, weight, g, RADIUS)

        def p2():
            dcn_bwd_pom_plain(x, off, mask, weight, g, RADIUS)

        def p3():
            dcn_bwd_x_plain(x, off, mask, weight, g, RADIUS)

        k2(), k3(), p2(), p3()
        times = {"k2": [], "k3": [], "p2": [], "p3": []}
        for _ in range(3):
            for name, fn in (("p2", p2), ("k2", k2), ("k2", k2), ("p2", p2),
                             ("p3", p3), ("k3", k3), ("k3", k3), ("p3", p3)):
                times[name].append(cuda_ms(fn))
        b2, by2, b3, by3 = bwd_bound_ms(cin, cout, h, w)
        row = dict(cin=cin, cout=cout, h=h, w=w, batch=BATCH, count=count, errors=errs,
                   pom_ms=statistics.median(times["k2"]), pom_plain_ms=statistics.median(times["p2"]),
                   pom_bound_ms=b2, pom_bound_by=by2,
                   x_ms=statistics.median(times["k3"]), x_plain_ms=statistics.median(times["p3"]),
                   x_bound_ms=b3, x_bound_by=by3)
        rows.append(row)
        rel = ", ".join(f"{k} {v['max_abs_err']:.3g} (max {v['scale']:.3g})" for k, v in errs.items())
        say("backward", time.perf_counter() - t0,
            f"{cin}->{cout} @ {BATCH}x{h}x{w} x{count}: {rel}; bitwise repeatable; "
            f"K2 {row['pom_ms']:.4f} ms (plain {row['pom_plain_ms']:.4f}, bound {b2:.4f} {by2}), "
            f"K3 {row['x_ms']:.4f} ms (plain {row['x_plain_ms']:.4f}, bound {b3:.4f} {by3})")
    return rows


def train_batch(cfg):
    """2 synthetic KITTI scenes of 1242x375 with 6 cars each, encoded by the
    port's target encoder and collated."""
    samples = [encode_targets(*make_scene(seed=s, num_objs=6), cfg, img_id=f"{s:06d}")
               for s in range(BATCH)]
    return collate(samples)


def _pair_heads(cfg):
    groups = [gi for gi, g in enumerate(cfg.model.head.regression_heads)
              if "extra_kpts_2d" in g or "extra_kpts_3d" in g]
    return tuple(f"heads.{kind}.{gi}." for gi in groups for kind in ("reg_features", "reg_heads"))


def step_parity(trainer, batch, grad_tol):
    """Forward, loss and backward of one step from one deep copy of the
    trainer, with the kernels and with the plain DCN. Loss terms must agree
    to STEP_LOSS_TOL relative and gradients to ``grad_tol`` of each
    tensor's largest magnitude, except where the function itself is
    ill-conditioned (tests/test_torch_train.py measures it on the CPU): the
    terms built on the edge-pair depths (PAIR_LOSS_TOL), the heads that feed
    the pair solve, whose gradient has switches (top-k of pairs, the depth
    clamp) that rounding can flip (relative Frobenius norm,
    PAIR_HEADS_FRO_TOL), and the biases that a train-mode BN removes, whose
    exact gradient is 0 (held to their layer's weight-gradient scale).
    Returns the largest errors of each kind, the largest offset the DCNs
    emitted and the share of offsets beyond the clamp."""
    out, offsets = {}, []
    for impl in ("cuda", "plain"):
        t = copy.deepcopy(trainer)
        set_dcn_impl(t.model, impl)
        hooks = [m.conv_offset_mask.register_forward_hook(
            lambda _m, _i, o: offsets.append(o[:, :18].detach().abs().flatten()))
            for m in t.model.modules() if isinstance(m, DCN) and impl == "cuda"]
        logs = compute_gradients(t, batch)
        for h in hooks:
            h.remove()
        grads = {n: p.grad for n, p in t.model.named_parameters() if p.grad is not None}
        out[impl] = ({k: float(v) for k, v in logs.items()}, grads)
        del t
    (lk, gk), (lp, gp) = out["cuda"], out["plain"]
    offsets = torch.cat(offsets)
    worst = dict(loss=0.0, pair_loss=0.0, grad=0.0, pair_heads_fro=0.0, bn_bias=0.0,
                 max_offset=float(offsets.max()), clamped_share=float((offsets > RADIUS).float().mean()))
    for k, v in lp.items():
        rel = abs(lk[k] - v) / max(abs(v), 1e-30)
        key, tol = ("pair_loss", PAIR_LOSS_TOL) if k in PAIR_TERMS else ("loss", STEP_LOSS_TOL)
        worst[key] = max(worst[key], rel)
        if not rel <= tol and abs(lk[k] - v) > 1e-7:
            raise AssertionError(f"step parity: {k} kernel {lk[k]} vs plain {v}")
    if set(gk) != set(gp):
        raise AssertionError("step parity: the two steps reached different parameters")
    pair = _pair_heads(trainer.cfg)
    for n, want in gp.items():
        got = gk[n]
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"step parity: non-finite gradient of {n}")
        diff = float((got - want).abs().max())
        base = n[: -len("bias")]
        if n.endswith(".bias") and (base + "conv_offset_mask.weight" in gp or
                                    (n.startswith("heads.trunc_") and n.endswith("_conv.0.bias"))):
            rel = diff / max(float(want.abs().max()), float(gp[base + "weight"].abs().max()), 1e-30)
            key, ok = "bn_bias", rel <= grad_tol
        elif n.startswith(pair):
            rel = float((got - want).norm() / want.norm().clamp_min(1e-30))
            key, ok = "pair_heads_fro", rel <= PAIR_HEADS_FRO_TOL
        else:
            rel = diff / max(float(want.abs().max()), 1e-30)
            key, ok = "grad", rel <= grad_tol
        worst[key] = max(worst[key], rel)
        if not ok:
            raise AssertionError(f"step parity: gradient of {n}: {key} error {rel}")
    return worst


def check_gradients(model, step):
    """Every parameter has a finite gradient (the optimizer gives an unused
    one zeros, as optax does), and every DCN weight and offset conv a
    non-zero one: the backward kernels reached them."""
    bad = [n for n, p in model.named_parameters()
           if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    if bad:
        raise AssertionError(f"step {step}: parameters without a finite gradient: {bad[:5]}")
    dead = [f"{name}.{leaf}" for name, m in model.named_modules() if isinstance(m, DCN)
            for leaf, p in (("weight", m.weight), ("conv_offset_mask.weight", m.conv_offset_mask.weight))
            if float(p.grad.abs().max()) == 0.0]
    if dead:
        raise AssertionError(f"step {step}: DCN parameters with an all-zero gradient: {dead[:5]}")


def phase_train():
    t0 = time.perf_counter()
    cfg = dgde_run_config()
    trainer = build_trainer(cfg, device="cuda", seed=0)
    batch = train_batch(cfg)
    torch.cuda.synchronize()
    n_obj = int(batch["reg_mask"].sum())
    say("train", time.perf_counter() - t0,
        f"trainer built, batch of {BATCH} scenes encoded ({n_obj} objects), "
        f"{cfg.input.height_train}x{cfg.input.width_train}")

    t0 = time.perf_counter()
    offsets_at_zero = all(not bool(m.conv_offset_mask.weight.any() or m.conv_offset_mask.bias.any())
                          for m in trainer.model.modules() if isinstance(m, DCN))
    if not offsets_at_zero:
        raise AssertionError("the offset convs do not start at zero")
    parity0 = step_parity(trainer, batch, STEP_GRAD_TOL)
    say("train", time.perf_counter() - t0, f"step 0 (all offsets 0) kernel vs plain: {parity0}")

    t0 = time.perf_counter()
    dcn_cuda.reset_launch_counts()
    steps = []
    for i in range(TRAIN_STEPS):
        before = [f.launches for f in (dcn_cuda.deform_conv2d, dcn_cuda.dcn_bwd_pom, dcn_cuda.dcn_bwd_x)]
        logs = train_step(trainer, batch)
        torch.cuda.synchronize()
        after = [f.launches for f in (dcn_cuda.deform_conv2d, dcn_cuda.dcn_bwd_pom, dcn_cuda.dcn_bwd_x)]
        per_step = [a - b for a, b in zip(after, before)]
        logs = {k: float(v) for k, v in logs.items()}
        bad = [k for k, v in logs.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"step {i}: non-finite {bad}")
        if per_step != [16, 16, 16]:
            raise AssertionError(f"step {i}: launches dcn_fwd/dcn_bwd_pom/dcn_bwd_x {per_step}, "
                                 "not 16 each")
        check_gradients(trainer.model, i)
        steps.append(dict(logs=logs, launches=per_step))
    launches = dict(zip(("dcn_fwd", "dcn_bwd_pom", "dcn_bwd_x"), after))
    say("train", time.perf_counter() - t0,
        f"{TRAIN_STEPS} steps, launches per step {steps[-1]['launches']} (dcn_fwd, dcn_bwd_pom, "
        f"dcn_bwd_x); total_loss " + ", ".join(f"{s['logs']['total_loss']:.4f}" for s in steps)
        + "; grad_norm " + ", ".join(f"{s['logs']['grad_norm']:.4g}" for s in steps))

    t0 = time.perf_counter()
    parity = step_parity(trainer, batch, LATE_STEP_GRAD_TOL)
    say("train", time.perf_counter() - t0, f"after {TRAIN_STEPS} steps kernel vs plain: {parity}")

    t0 = time.perf_counter()
    times = []
    for _ in range(5):
        t1 = time.perf_counter()
        train_step(trainer, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    step_s = statistics.median(times)
    prof = device_breakdown(lambda: train_step(trainer, batch))
    kinds = ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(prof["by_kind"].items()))
    say("train", time.perf_counter() - t0,
        f"train step at batch {BATCH}: median {step_s * 1e3:.2f} ms ({BATCH / step_s:.2f} images/s); "
        f"profiled step: wall {prof['wall_ms']:.2f} ms, device {prof['device_ms']:.2f} ms "
        f"(busy {100 * prof['busy_share']:.1f}%): {kinds}")
    return dict(launches=launches, steps=steps, parity_step0=parity0, parity=parity,
                step_ms=step_s * 1e3, step_ms_all=[t * 1e3 for t in times],
                images_per_s=BATCH / step_s, objects=n_obj, profile=prof)


def main():
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    say("device", time.perf_counter() - t0,
        f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")

    built = cuda_build.build()
    cuda_build.library()
    ptxas = [ln.strip() for ln in built["log"].splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    say("build", built["seconds"], f"{built['command']}\n  " + "\n  ".join(ptxas))

    shapes = phase_kernel()
    main_path = phase_main_path()
    backward = phase_backward()
    train = phase_train()

    def total(key):
        return sum(r[key] * r["count"] for r in shapes)

    kernels = [{
        "name": "dcn_fwd",
        "route": "cuda",
        "source": "dcd_tpu_torch/csrc/dcn_fwd.cu",
        "replaces": "dcd_tpu/ops/dcn_pallas.py:370",
        "launches": main_path["launches"],
        "max_abs_err": max(r["fp32_max_abs_err"] for r in shapes),
        "ms": total("ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": max(("bytes", "operations"),
                        key=lambda b: sum(r["bound_ms"] * r["count"] for r in shapes
                                          if r["bound_by"] == b)),
        "library_ms": None,
    }]
    for name, key, replaces in (("dcn_bwd_pom", "pom", "dcd_tpu/ops/dcn_pallas.py:859"),
                                ("dcn_bwd_x", "x", "dcd_tpu/ops/dcn_pallas.py:1246")):
        grads = ("grad_offset", "grad_mask", "grad_weight") if key == "pom" else ("grad_x",)
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "dcd_tpu_torch/csrc/dcn_bwd.cu",
            "replaces": replaces,
            "launches": train["launches"][name],
            "max_abs_err": max(r["errors"][gname]["max_abs_err"] for r in backward for gname in grads),
            "ms": sum(r[f"{key}_ms"] * r["count"] for r in backward),
            "plain_ms": sum(r[f"{key}_plain_ms"] * r["count"] for r in backward),
            "bound_ms": sum(r[f"{key}_bound_ms"] * r["count"] for r in backward),
            "bound_by": max(("bytes", "operations"),
                            key=lambda b: sum(r[f"{key}_bound_ms"] * r["count"] for r in backward
                                              if r[f"{key}_bound_by"] == b)),
            "library_ms": None,
        })
    say("done", time.perf_counter() - t0, "all phases passed")
    details = {"card": smi, "build_seconds": built["seconds"], "shapes": shapes,
               "main_path": main_path, "backward": backward, "train": train}
    # every profiled kernel by name goes to a file; the line keeps the top ones
    DETAILS_FILE.parent.mkdir(parents=True, exist_ok=True)
    DETAILS_FILE.write_text(json.dumps(details, indent=1))
    for phase in (main_path, train):
        phase["profile"].pop("kernels")
    print("[details] " + json.dumps(details))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
