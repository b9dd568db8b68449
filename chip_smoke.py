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

It prints the kernels' JSON line, the card's name and power limit, and as
the last line ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero before that. A ``[details]`` line before them holds every
number the run took, as JSON.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from dcd_tpu_torch.config import dgde_run_config
from dcd_tpu_torch.data.edges import KITTI_IMAGE_SIZE, KITTI_P2, padded_edge_indices
from dcd_tpu_torch.engine.infer import build_detector, format_kitti_lines, infer
from dcd_tpu_torch.models.layers import DCN
from dcd_tpu_torch.ops import dcn_cuda
from dcd_tpu_torch.ops.dcn import deform_conv2d_clamped
from dcd_tpu_torch.utils import cuda_build
from dcd_tpu_torch.utils.weights import calibrate_batch_norm, realistic_offsets

BATCH = 2
RADIUS = 3
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
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# device kernels by kind, first match wins (cuDNN names its BN and layout
# kernels too, so those come before the convolutions)
KERNEL_KINDS = [
    ("dcn_fwd", ("dcn_fwd_kernel",)),
    ("batch_norm", ("bn_fw",)),
    ("layout", ("nhwctonchw", "nchwtonhwc")),
    ("convolution", ("conv", "xmma", "gemm", "dgrad", "cutlass")),
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
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        low = e.name.lower()
        kind = next((k for k, marks in KERNEL_KINDS if any(m in low for m in marks)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + ms
    device_ms = sum(by_kind.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(wall_ms=wall_ms, device_ms=device_ms, busy_share=device_ms / wall_ms,
                by_kind=by_kind, top=top)


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
    say("done", time.perf_counter() - t0, "all phases passed")
    print("[details] " + json.dumps({"card": smi, "build_seconds": built["seconds"],
                                     "shapes": shapes, "main_path": main_path}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
