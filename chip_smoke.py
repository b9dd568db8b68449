"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing one line with its own seconds:

1. device: a CUDA card is required; prints ``nvidia-smi``'s name and power
   limit.
2. build: one ``nvcc`` per ``dcd_tpu_torch/csrc/*.cu``, started together,
   and a link; prints ``-Xptxas -v``'s registers and spills, and the
   tensor-core instructions (HMMA/HGMMA) in the SASS of each instantiation
   of the forward kernel and of each backward kernel (``cuobjdump``): every
   bf16 forward and every backward kernel must have them.
3. kernel: the forward kernel K1 at the seven DCN shapes of a 384x1280
   forward. At the main path's batch of 2, against its plain PyTorch
   version in fp32 (max abs err <= 1e-4 of the output's largest magnitude,
   TF32 off) and bf16 (<= 2e-2), twice (bitwise equal), and with NaN
   offsets (the tap is dropped); timed with CUDA events around 5
   back-to-back calls through the Python wrapper, whose host time they
   include (median over 10 turns of plain, kernel, kernel, C entry, plain
   after a warm-up; "C entry" is the kernel's C entry point called on
   arguments checked once, without the wrapper's Python), and beside it, as
   a yardstick only, a bf16 ``torch.matmul`` of pre-gathered (P, 9 Cin)
   columns by (9 Cin, Cout): the contraction alone in cuBLAS, not the same
   function.
   At batch 64 (the bench protocol's), checked on images 0-1 against the
   plain version (at 64 it needs ~18 GB per bilinear corner) and timed
   through the wrapper.
4. main path: ``build_detector(dgde_run_config())`` with seeded random
   weights, trained-checkpoint offset statistics and BN statistics
   calibrated on the batch; ``infer`` on 2 images of 384x1280 with the
   boundary ring of a 1242x375 KITTI frame. The rows must be finite and
   (2, 50, 14), and ``dcn_fwd_f32`` must launch 16 times in the forward.
   The same forward with the plain DCN (``dcn_impl="dense"``) must give the
   same heatmap and peaks (<= 1e-4 of the largest magnitude). Then the
   forward is timed (median of 5) and profiled once: device time by kernel
   kind and the device's busy share.
5. main path in bf16: the same detector with ``cfg.model.fp16`` on the same
   weights. ``dcn_fwd_bf16`` must launch 16 times and the rows be fp32 and
   finite. bf16 against fp32: every trunk block, projection and DCN block
   fed the same input, and the heads fed the same features, within 2e-2
   (per head at the peaks both chose, at least MIN_MATCHED of them, and the
   rows matched by centre); the whole forward's difference is printed but
   not held to a limit (the random network amplifies rounding some
   hundredfold; see PERF.md). The kernel against the plain clamped form:
   each DCN on the same input and the whole forward within 2e-2. The
   top-K of a batch-64 heat map timed as ``select_topk`` computes it
   (stable sorts, ties broken as JAX breaks them) and by ``torch.topk``.
   Then forward + postprocess timed and profiled at batch 2 and at batch 64.
6. backward kernels: K2 (``dcn_bwd_pom``: grad offset, mask and weight)
   and K3 (``dcn_bwd_x``: grad x) against their plain versions (autograd of
   the clamped form) at the same seven shapes, at batch 2 and at the run
   config's ``ims_per_batch`` of 8, fp32 with TF32 off, offsets of std 1.5
   px (some beyond the clamp) and again with NaN offsets: max abs err <=
   1e-4 of each output's largest magnitude (fp32 sums reassociated over up
   to 9 * Cout terms, and over all B*H*W pixels for grad_weight; the
   products in 3xTF32). Each kernel runs twice and the two results must be
   bitwise equal, and grad_x through ``DeformConv2dFunction``'s backward
   must equal ``dcn_bwd_x`` alone bitwise. Timed through the wrappers (5
   back-to-back calls per pair of CUDA events, turns of plain, kernel,
   kernel, plain) beside two bounds (``bwd_bound_ms``) and, as a yardstick
   only, the contractions alone in cuBLAS. The same on bf16 x, mask, weight
   and cotangent (offsets fp32), as bf16 training gives them
   (``dcn_bwd_pom_bf16``, ``dcn_bwd_x_bf16``): gradients in their inputs'
   types against the plain versions (grad_offset <= 1e-4, the bf16 ones <=
   BWD_BF16_TOL of scale), with NaN offsets too; the kernels' fp32 outputs
   before the cast against the fp32 kernels on the widened values (<=
   BF16_VS_FP32_TOL); bitwise repeatable; timed beside the bf16 bound and
   the plain versions. K3 at radius 5, 7 and 9, fp32 and bf16, against its
   plain version, and radius 10 refused for its shared memory.
7. train path: ``build_trainer(dgde_run_config(), device="cuda")`` at full
   width and depth, 384x1280, on 2 port-encoded synthetic KITTI scenes of
   1242x375 with 6 cars each (``ims_per_batch`` cut from 8 to 2). Step 0
   (every offset exactly 0, the offset convs start at zero) is taken once
   with the kernels and once with the plain DCN from one deep copy: every
   loss term must agree to 1e-4 relative and every gradient to 1e-2 of its
   tensor's largest magnitude, with the exceptions ``step_parity`` states;
   the same with every BN in its linear range (``linear_range_bn``), where
   the gradients must agree to 1e-3 (STEP_GRAD_TOL states why). Then 3
   steps: finite losses, 16 launches of each kernel per step, a finite
   gradient for every parameter and a non-zero one for every DCN
   weight and offset conv; a second trainer from the same seed must reach
   bitwise equal losses and parameters in 3 steps; the parity check again,
   at non-zero offsets, gradients to 1e-3; the step time (median of 5) without and with the
   deterministic mode (``Trainer.deterministic``), and one profiled step.
7b. train_bf16: ``build_trainer`` with ``cfg.model.fp16`` at full width,
   batch 2: the step's losses and gradients (all, and by part of the
   network) against the fp32 step's from the same seeded weights with every
   BN moved into its linear range (``linear_range_bn``; BF16_VS_FP32_*);
   one step: 16 launches each of
   ``dcn_fwd_bf16``, ``dcn_bwd_pom_bf16`` and ``dcn_bwd_x_bf16`` and none of
   the fp32 entry points, finite losses and gradients; a second trainer from
   the same seed bitwise equal; ``cfg.model.remat`` bitwise the same step,
   with 32 forward launches and every ``num_batches_tracked`` at 1; after
   the step, kernels against the plain DCN (BF16_STEP_*); the step time
   (median of 5) with and without the deterministic mode, one profiled step.
7c. oracle: ``tools/oracle_inject.py``'s sweep at 0 and 1 px on
   ORACLE_SCENES held-out scenes with ``postprocess`` on the card and on the
   CPU: equal AP rows and valid rows, the rows within ORACLE_TOL.
8. gen: ``make_gen_step`` on the main path's detector and 2 encoded scenes
   of phase 7's kind: 16 ``dcn_fwd_f32`` launches, six finite fields, the
   kernel against the plain DCN (keypoints and yaw <= 1e-4 of scale, the
   location <= GEN_LOC_TOL); the fields through ``normalize_batch_kpts``,
   ``GenDataTrainWriter`` and ``load_gen_data_train`` come back equal; the
   infer-side pass (``infer`` at detection threshold 0, the seeded weights
   scoring below the shipped one) through ``GenDataInferWriter`` and
   ``load_gen_data_infer`` gives the next phase its objects; times at batch
   2 and 8 (median of 5), one profile at 8.
9. gmw: ``GMWConfig()`` (73 keypoints, 128 features, depth 12, batch 8,
   top-1500) on the committed ``gen_data/gen_data_train.json``: 3 train
   steps with epoch 1's loss weights (finite losses, finite gradients,
   non-zero in each tower, Sinkhorn iterations printed), a second state
   from the same seed bitwise equal, one step at batch 2 on the card
   against the same on this machine's CPU (P and losses <= 1e-4, gradients
   <= GMW_GRAD_FRO in relative Frobenius norm), a NaN step whose parameters
   must be AdamW's on zero
   gradients, the step time (median of 5) and one profiled step split by
   the port's profiler spans (towers, cost matrix, scaling loop, Schur
   product, Cholesky, rest); then ``make_gmw_predict`` at batch 8 and
   ``rescale_location`` on phase 8's objects, finite, timed.
10. cli: the command line, ``dcd_tpu_torch.tools.train_dgde``, in-process on
   a KITTI tree that ``write_kitti_tree`` writes under build/ (8 train and 16
   val scenes of 6 cars at 1242x375). K1 fp32 at batch 1 (the eval's launch
   shape) against its plain version at the 7 shapes, timed. 4 training
   iterations at full width, ``--batch_size 2``: 16 launches each of
   ``dcn_fwd_f32``, ``dcn_bwd_pom`` and ``dcn_bwd_x`` per iteration, finite
   losses, data and step time per iteration; 2 iterations, ``model_final``,
   ``--resume``, 2 more: losses, parameters, BN buffers, AdamW state and step
   bitwise those of the 4 straight. ``--eval --resume --vis 2``: a txt per
   val id, ``result.json``, 16 launches per image and the warm-up, images/s
   with the warm-up and the panels excluded, two panels of the frame and
   its bird's-eye view; images 0-1 at batch 1 with the kernel against the plain
   DCN (same peaks, heads and rows at threshold 0 within PATH_TOL of scale).
   The AP's host seconds with the native matcher and the Python loop, whose
   results must be equal, on the eval's txt files and on the val labels fed
   back as detections (score 1, locations moved by up to 1 mm), which must give
   AP 100 everywhere. ``--generate_for_GMW --resume``: both JSONs read back by
   the port's loaders with the train split's objects and the eval's rows.
   ``--finetune`` of that ``model_final`` for 2 iterations with the backbone
   frozen through a YAML under build/: 16 launches of each kernel per
   iteration, the frozen parameters bitwise the file's, every live one with a
   gradient and every backbone BN statistic moved, the update count
   restarted. Training in bf16 through a YAML (``FP16: true``) for 2
   iterations: 16 launches per iteration of each bf16 entry point, none of
   fp32, finite losses. ``python -m dcd_tpu_torch.tools.demo --synthetic 3`` on
   the phase's checkpoint directory: 16 ``dcn_fwd_f32`` launches, both PNGs.
   ``--generate_for_GMW`` once more, for phase 11, with the detection
   threshold at 0, no depth confidence and 4 rows per image through a YAML
   (the seeded weights score under the shipped 0.2).
11. gmw_cli: stage 2's command line, ``dcd_tpu_torch.tools.train_gmw``,
   in-process on phase 10's JSONs at ``GMWConfig()``'s scale (73
   keypoints, 2628 edges, batch 8) with ``--kitti_path`` on phase 10's
   tree: 2 epochs, validation and checkpoints every epoch (``model_best``,
   ``checkpoint_epoch_N``, ``checkpoint_final``); the same run again,
   losses and checkpoints bitwise equal; ``--evaluate --resume`` on the
   card inside ``utils/profiling.py``'s ``trace_session`` and
   ``StepTimer``, and on the host's CPU from the same checkpoint: the
   refined locations within 1e-4 of scale. Step, epoch and predict times,
   and the AP.

12. dist: data parallelism over processes on the one card. (a) The DGDE
   train step at full width in fp32 in two processes joined over gloo
   (``parallel.launch``), each at batch 1 on its half of phase 7's two
   scenes, against one process at batch 2 on both: loss terms, gradients,
   BN running statistics and the parameters after the AdamW update within
   ``parallel.workers.dgde_step_agreement``'s limits (tests/test_torch_train.py's);
   16 launches each of ``dcn_fwd_f32``, ``dcn_bwd_pom_f32`` and
   ``dcn_bwd_x_f32`` per rank and none of the bf16 entry points; the
   step's gradients computed twice on the same weights, bitwise equal;
   both ranks' weights bitwise equal; one step of rank 0 under the host's
   profiler (its time, and the collectives' share). (b) ``train_dgde
   --num_processes 2 --dist_backend gloo`` on phase 10's tree (``tools/multiprocess_smoke.run_cli``): 3 iterations,
   then the sharded ``--eval --resume``: a txt per val id, ``result.json``
   from rank 0 alone, one ``model_final``, both ranks' weights bitwise
   equal. (c) The GMW step at ``GMWConfig()`` batch 8 on the committed
   train file, two ranks against one process: losses within
   DIST_GMW_LOSS_TOL, gradients within GMW_GRAD_FRO, ranks bitwise equal.
   (d) This process as one rank over NCCL (a communicator made on the
   card) takes one DDP step at batch 1; a second rank claiming the card is
   refused before NCCL starts, naming the card. (a), (c) and (b) run in one
   launch of the two ranks, which leave their gloo group before (b)'s own
   rendezvous. The ranks are forked from multiprocessing's fork server,
   started with the script, which imports the script's modules and
   ``torch._dynamo`` while the earlier phases run.

It prints the kernels' JSON line, the card's name and power limit, and as
the last line ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero before that. A ``[details]`` line before them holds every
number the run took, as JSON; ``build/chip_smoke_details.json`` holds the
same with every profiled kernel by name.
"""


import concurrent.futures
import copy
import dataclasses
import datetime
import json
import multiprocessing
import multiprocessing.forkserver
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# the train steps' deterministic mode refuses cuBLAS unless this names a
# fixed workspace, and PyTorch reads it at the process's first cuBLAS call,
# so it is set before any use of the card (as build_trainer documents). On
# sm_90 it names PyTorch's default workspace, so the inference phases run
# with the cuBLAS they would have without it.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np
import torch

from dcd_tpu_torch.config import dgde_run_config
from dcd_tpu_torch.data.edges import KITTI_IMAGE_SIZE, KITTI_P2, padded_edge_indices
from dcd_tpu_torch.data.gen_data import (GenDataInferWriter, GenDataTrainWriter, load_gen_data_infer,
                                         load_gen_data_train, normalize_batch_kpts, normalize_kpts_2d)
from dcd_tpu_torch.data.kitti_dataset import KITTIDataset
from dcd_tpu_torch.data.synthetic import make_scene, write_kitti_tree
from dcd_tpu_torch.data.target_encoder import collate, encode_targets
from dcd_tpu_torch.engine.gen import make_gen_step
from dcd_tpu_torch.engine.gmw_train import (GMWConfig, create_gmw_state, loss_weights_for_epoch,
                                            make_gmw_predict, make_gmw_train_step, rescale_location)
from dcd_tpu_torch.engine.infer import build_detector, format_kitti_lines, infer, postprocess
from dcd_tpu_torch.engine.train import build_trainer, compute_gradients, train_step
from dcd_tpu_torch.evaluation import native
from dcd_tpu_torch.evaluation.kitti_eval import (evaluate_from_files, get_label_anno,
                                                 get_official_eval_result)
from dcd_tpu_torch.models.layers import DCN
from dcd_tpu_torch.models.predictor import Converter_key2channel
from dcd_tpu_torch.ops import dcn_cuda
from dcd_tpu_torch.ops.dcn_cuda import DeformConv2dFunction
from dcd_tpu_torch.ops.dcn import dcn_bwd_pom_plain, dcn_bwd_x_plain, deform_conv2d_clamped
from dcd_tpu_torch.ops.nms import nms_hm, select_topk
from dcd_tpu_torch.tools import demo, oracle_inject, train_dgde, train_gmw
from dcd_tpu_torch.utils import cuda_build
from dcd_tpu_torch.utils.profiling import TRACE_FILE, StepTimer, trace_session
from dcd_tpu_torch.utils.weights import calibrate_batch_norm, realistic_offsets

BATCH = 2
BIG_BATCH = 64  # the bench protocol's batch (bench.py)
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
# bf16 against fp32 heads on the same features, and the bf16 kernel against
# the plain form over the whole forward: the share of the 50 peaks (and of
# the valid rows) that both must choose; a peak whose score is within bf16's
# rounding of its neighbour's may give way to another (measured: 95 % and
# 96 % on the H100)
MIN_MATCHED = 0.9
BWD_TOL = 1e-4
# bf16 inputs to K2 and K3: the kernels and the plain versions both compute
# in fp32 and round each bf16 gradient once, so they part by at most one
# bf16 rounding (2^-8 of a value) on either side; before that rounding, the
# bf16 kernels and the fp32 kernels on the widened values sum the same fp32
# numbers in the same order
BWD_BF16_TOL, BF16_VS_FP32_TOL = 8e-3, 1e-5
TRAIN_STEPS = 3
# kernel-vs-plain train step: loss terms relative, gradients of each
# tensor's largest magnitude; the pair-depth terms and the heads feeding the
# pair solve are ill-conditioned and switched (see step_parity). The step is
# deterministic (build_trainer's switches), so each check sees the same
# state in every run. Measured on the H100 at flax's initialisation: 3.43e-3
# at step 0 (the class head's 3x3 conv; 2.8e-4 at the He initialisation
# before it), 2.07e-4 after 3 steps (3.9e-4 at He). At step 0, at the seeded
# weights, train-mode BN grows the kernels' rounding differences layer by
# layer (as in phase 7b); the same step-0 check with every BN in its linear
# range (linear_range_bn) measures the kernels without that growth and is
# held to STEP_GRAD_TOL, as is the check after 3 steps. STEP0_GRAD_TOL, for
# the seeded weights' step 0 alone, is three times its reading.
STEP_LOSS_TOL, STEP_GRAD_TOL, STEP0_GRAD_TOL = 1e-4, 1e-3, 1e-2
PAIR_LOSS_TOL, PAIR_HEADS_FRO_TOL = 5e-3, 5e-2
PAIR_TERMS = ("pairs_kpts_depth_loss", "extra_all_MAE", "edges_MAE", "corner_loss")
# gen step, kernel against plain, of each field's scale: keypoints and yaw
# as the issue's 1e-4; the location 1e-5, twenty times the H100's reading
# (5.0e-7; the keypoints 2.9e-7 (2D) and 2.0e-6 (3D), the yaw 4.0e-6)
GEN_TOL, GEN_LOC_TOL = 1e-4, 1e-5
# bf16 train step (phase 7b): against the fp32 step from the same seeded
# weights, and kernels against the plain DCN after one step (the RMS of the
# loss terms' relative differences; the gradients as one vector, relative
# Frobenius norm, also for each part of the network). Train-mode BN at the
# seeded weights grows a flipped bf16 rounding through the network until
# the bf16 step's gradients are unrelated to the fp32 step's (0.627 on the
# H100, 1.02 on the CPU's small model), so the comparison with the fp32
# step is made with every BN's gain cut to LINEAR_BN_GAIN and its shift at
# LINEAR_BN_SHIFT (linear_range_bn), where the CPU's small model reads
# 0.035 (tests/test_torch_train_bf16.py). The H100 reads loss RMS 1.72e-3,
# gradients 0.0988 as one vector and by part 0.293 (trunk), 0.326
# (dla_up), 0.307 (ida_up), 0.0559 (heads). Limits: three times the
# readings for the losses and the whole vector; each part under 0.9, under
# 1 so that a part whose gradients were all zero fails. Kernels against
# plain 1.03e-3 and 0.0894 (the plain DCN's bf16 autograd rounds the
# samples' gradient to bf16, the kernels keep it fp32)
LINEAR_BN_GAIN, LINEAR_BN_SHIFT = 0.2, 1.0
BF16_VS_FP32_LOSS_RMS, BF16_VS_FP32_GRAD_FRO, BF16_VS_FP32_PART_FRO = 5e-3, 0.3, 0.9
BF16_STEP_LOSS_RMS, BF16_STEP_GRAD_FRO = 3e-3, 0.27
# oracle rows, card against CPU, of each column's largest magnitude
ORACLE_TOL = 1e-4
GMW_TRAIN_JSON = Path(__file__).resolve().parent / "gen_data" / "gen_data_train.json"
GMW_STEPS = 3
# GMW card against CPU: P and the losses of one step relative, the step's
# gradients as one vector by relative Frobenius norm
# (tests/test_torch_gmw.py::SHIPPED_GRAD_FRO and its measurement)
GMW_TOL, GMW_GRAD_FRO = 1e-4, 5e-2
# the GMW step over 2 ranks against one process: the losses (batch means,
# averaged over the ranks) to the GMW's 1e-5; the gradients as the card
# against the CPU, GMW_GRAD_FRO (the shipped GMW is ill-conditioned, and
# cuBLAS may take other algorithms at batch 4 than at 8)
DIST_GMW_LOSS_TOL = 1e-5
# the port's profiler spans of a GMW step (models/gmw.py, ops/sinkhorn.py)
GMW_SPANS = ("gmw.towers", "gmw.cost_matrix", "sinkhorn.scaling", "sinkhorn.vjp",
             "sinkhorn.schur_product", "sinkhorn.cholesky")
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 FLOP/s outside the
# tensor cores, dense bf16 FLOP/s on them
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
# fp32 products on the tensor cores as 3xTF32: three passes at the dense
# TF32 rate (494.7 TFLOP/s)
TF32X3_FLOP_PER_S = 494.7e12 / 3
# device kernels by kind, first match wins (cuDNN names its BN and layout
# kernels too, so those come before the convolutions)
KERNEL_KINDS = [
    ("dcn_fwd", ("dcn_fwd_kernel",)),
    ("dcn_bwd_pom", ("bwd_pom_kernel", "bwd_weight_kernel", "bwd_weight_reduce_kernel")),
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


def dcn_inputs(cin, cout, h, w, gen, batch=BATCH):
    """Seeded inputs on the card; offsets of std 1.5 px, so that some exceed
    +-R (the clamp) and some point outside the image (the zero padding)."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    x = randn(batch, h, w, cin)
    off = randn(batch, h, w, 18) * 1.5
    mask = torch.sigmoid(randn(batch, h, w, 9))
    weight = randn(3, 3, cin, cout) / (9 * cin) ** 0.5
    bias = randn(cout) * 0.1
    return [t.contiguous() for t in (x, off, mask, weight, bias)]


def with_nan_offsets(off):
    """A copy of the offsets with NaN in tap 0's dy at one pixel and in tap
    4's dx at another of image 0 (the kernels drop such a tap)."""
    off = off.clone()
    h, w = off.shape[1], off.shape[2]
    off[0, h // 2, w // 3, 0] = float("nan")
    off[0, h // 3, w // 2, 9] = float("nan")
    return off


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


def roofline_ms(nbytes, contraction, sampling, contraction_flop_per_s):
    """(ms, what bounds it): the larger of the bytes over HBM and the
    operations, the contraction at ``contraction_flop_per_s`` plus the
    sampling at the fp32 rate outside the tensor cores."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = contraction / contraction_flop_per_s + sampling / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def bound_ms(cin, cout, h, w, batch=BATCH, dtype=torch.float32):
    """Least time for K1 at this shape: each input read once and the output
    written once over HBM (offsets fp32, the rest in ``dtype``), or its
    operations: the contraction (2 * 9 * Cin * Cout per pixel) and 4 FMAs
    per sampled channel. bf16: all on the tensor cores. fp32: the kernel
    runs the contraction on the tensor cores as 3xTF32, so the bound takes
    it at a third of the TF32 rate and the sampling at the fp32 rate; the
    all-fp32-FMA bound (``bound_ms_fp32_fma``, the one stated before the
    kernel used the tensor cores) counts the contraction at 67 TFLOP/s,
    which a tensor-core kernel can beat."""
    p = batch * h * w
    size = torch.finfo(dtype).bits // 8
    nbytes = 4 * p * 18 + size * (p * (cin + 9 + cout) + 9 * cin * cout + cout)
    contraction, sampling = 2 * p * 9 * cin * cout, 8 * p * 9 * cin
    if dtype == torch.float32:
        return roofline_ms(nbytes, contraction, sampling, TF32X3_FLOP_PER_S)
    return roofline_ms(nbytes, contraction + sampling, 0, BF16_FLOP_PER_S)


def bound_ms_fp32_fma(cin, cout, h, w, batch=BATCH):
    """K1's fp32 bound with every operation at 67 TFLOP/s (fp32 FMAs)."""
    p = batch * h * w
    nbytes = 4 * (p * (18 + cin + 9 + cout) + 9 * cin * cout + cout)
    return roofline_ms(nbytes, 2 * p * 9 * cin * (cout + 4), 0, FP32_FLOP_PER_S)


def c_entry_call(x, off, mask, weight, bias):
    """A call that launches the forward kernel through its C entry point on
    arguments checked once and an output allocated once, for a time without
    the wrapper's Python (which, at batch 2, takes as long as the kernel).
    It does not count as a launch."""
    dcn_cuda._check(x, off, mask, weight, bias)
    B, H, W, Cin = x.shape
    Cout = weight.shape[3]
    out = torch.empty((B, H, W, Cout), dtype=x.dtype, device=x.device)
    fn = getattr(cuda_build.library(), dcn_cuda._KERNELS[x.dtype])
    args = (x.data_ptr(), off.data_ptr(), mask.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            out.data_ptr(), B, H, W, Cin, Cout, RADIUS, torch.cuda.current_stream().cuda_stream)

    def call():
        rc = fn(*args)
        if rc:
            raise RuntimeError(f"forward kernel launch failed with CUDA error {rc}")
    return call


def timed_turns(fns, turns):
    """Median device ms of each named function over ``turns`` turns of the
    ``(name, function)`` pairs in the order given (e.g. plain, kernel,
    kernel, plain; a name may come twice), after one warm-up call of each."""
    for _, fn in fns:
        fn()
    times = {name: [] for name, _ in fns}
    for _ in range(turns):
        for name, fn in fns:
            times[name].append(cuda_ms(fn))
    return {name: statistics.median(t) for name, t in times.items()}


def fwd_launches():
    """Launches of the forward kernel, in both precisions."""
    return sum(dcn_cuda.deform_conv2d.launches_by_kernel.values())


def bwd_launches():
    """Launches of K2 and of K3, each in both precisions."""
    return (sum(dcn_cuda.dcn_bwd_pom.launches_by_kernel.values()),
            sum(dcn_cuda.dcn_bwd_x.launches_by_kernel.values()))


def launches_by_entry_point():
    """Launches of every C entry point of the three DCN kernels."""
    return {**dcn_cuda.deform_conv2d.launches_by_kernel, **dcn_cuda.dcn_bwd_pom.launches_by_kernel,
            **dcn_cuda.dcn_bwd_x.launches_by_kernel}


def check_kernel(got, want, tol, what):
    """max |got - want| <= tol * max |want|, both finite; returns (err, scale)."""
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    if not (bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all())):
        raise AssertionError(f"{what}: non-finite values")
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    if not err <= tol * scale:
        raise AssertionError(f"{what}: max abs err {err} > {tol} x {scale}")
    return err, scale


def phase_kernel():
    """K1 at the 7 shapes: fp32 and bf16 against the plain version, bitwise
    repeatable, a NaN-offset case; times at batch 2 (beside the plain
    version) and at batch 64 (checked on images 0-1), and the yardstick of
    the contraction alone in cuBLAS."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    lib = cuda_build.library()
    rows = []
    for cin, cout, h, w, count in DCN_SHAPES:
        t0 = time.perf_counter()
        row = dict(cin=cin, cout=cout, h=h, w=w, batch=BATCH, count=count)
        x, off, mask, weight, bias = dcn_inputs(cin, cout, h, w, gen)
        args = {torch.float32: (x, off, mask, weight, bias),
                torch.bfloat16: (x.bfloat16(), off, mask.bfloat16(), weight.bfloat16(),
                                 bias.bfloat16())}
        for dt, tol, tag in ((torch.float32, FP32_TOL, "fp32"), (torch.bfloat16, BF16_TOL, "bf16")):
            a = args[dt]
            got = dcn_cuda.deform_conv2d(*a, RADIUS)
            again = dcn_cuda.deform_conv2d(*a, RADIUS)
            err, scale = check_kernel(got, deform_conv2d_clamped(*a, RADIUS), tol,
                                      f"{tag} {cin}->{cout}@{h}x{w}")
            if not torch.equal(got, again):
                raise AssertionError(f"{tag} {cin}->{cout}@{h}x{w}: two runs differ")
            nan_args = (a[0], with_nan_offsets(off), *a[2:])
            nan_err, _ = check_kernel(dcn_cuda.deform_conv2d(*nan_args, RADIUS),
                                      deform_conv2d_clamped(*nan_args, RADIUS), tol,
                                      f"{tag} NaN offsets {cin}->{cout}@{h}x{w}")
            row.update({f"{tag}_max_abs_err": err, f"{tag}_scale": scale,
                        f"{tag}_nan_max_abs_err": nan_err})
            plain = lambda: deform_conv2d_clamped(*a, RADIUS)
            kernel = lambda: dcn_cuda.deform_conv2d(*a, RADIUS)
            times = timed_turns([("plain", plain), ("kernel", kernel), ("kernel", kernel),
                                 ("c_entry", c_entry_call(*a)), ("plain", plain)], 10)
            b_ms, b_by = bound_ms(cin, cout, h, w, BATCH, dt)
            if dt == torch.float32:
                row["fp32_bound_fma_ms"] = bound_ms_fp32_fma(cin, cout, h, w, BATCH)[0]
            row.update({f"{tag}_ms": times["kernel"], f"{tag}_c_entry_ms": times["c_entry"],
                        f"{tag}_plain_ms": times["plain"],
                        f"{tag}_bound_ms": b_ms, f"{tag}_bound_by": b_by})
        row["tile"] = [lib.dcn_fwd_tile_m(BATCH, h, w, cout), lib.dcn_fwd_tile_n(BATCH, h, w, cout)]
        cols = torch.randn((BATCH * h * w, 9 * cin), generator=gen, device="cuda").bfloat16()
        wmat = args[torch.bfloat16][3].reshape(9 * cin, cout)
        row["bf16_contraction_cublas_ms"] = timed_turns([("mm", lambda: torch.matmul(cols, wmat))], 5)["mm"]
        del x, off, mask, weight, bias, args, cols

        # the bench protocol's batch: times, and images 0-1 against the plain
        # version (at 64 the plain version needs ~18 GB per bilinear corner)
        big = dcn_inputs(cin, cout, h, w, gen, BIG_BATCH)
        for dt, tol, tag in ((torch.float32, FP32_TOL, "fp32"), (torch.bfloat16, BF16_TOL, "bf16")):
            a = [t.to(dt) if i != 1 else t for i, t in enumerate(big)]
            got = dcn_cuda.deform_conv2d(*a, RADIUS)
            two = [t[:2] for t in a[:3]] + a[3:]  # x, offsets and mask of images 0-1
            err, _ = check_kernel(got[:2], deform_conv2d_clamped(*two, RADIUS), tol,
                                  f"{tag} batch {BIG_BATCH} {cin}->{cout}@{h}x{w}")
            del got
            times = timed_turns([("kernel", lambda: dcn_cuda.deform_conv2d(*a, RADIUS))], 3)
            b_ms, b_by = bound_ms(cin, cout, h, w, BIG_BATCH, dt)
            row.update({f"b64_{tag}_ms": times["kernel"], f"b64_{tag}_max_abs_err": err,
                        f"b64_{tag}_bound_ms": b_ms, f"b64_{tag}_bound_by": b_by})
            del a
        row["b64_tile"] = [lib.dcn_fwd_tile_m(BIG_BATCH, h, w, cout),
                           lib.dcn_fwd_tile_n(BIG_BATCH, h, w, cout)]
        cols = torch.empty((BIG_BATCH * h * w, 9 * cin), device="cuda", dtype=torch.bfloat16).normal_(
            generator=gen)
        wmat = big[3].bfloat16().reshape(9 * cin, cout)
        row["b64_bf16_contraction_cublas_ms"] = timed_turns([("mm", lambda: torch.matmul(cols, wmat))],
                                                            3)["mm"]
        del big, cols
        rows.append(row)
        say("kernel", time.perf_counter() - t0,
            f"{cin}->{cout} @ {h}x{w} x{count}, tile {row['tile']}: "
            f"fp32 err {row['fp32_max_abs_err']:.3g} (max {row['fp32_scale']:.3g}), "
            f"bf16 err {row['bf16_max_abs_err']:.3g} (max {row['bf16_scale']:.3g}), NaN offsets "
            f"{row['fp32_nan_max_abs_err']:.3g}/{row['bf16_nan_max_abs_err']:.3g}; bitwise repeatable; "
            f"batch {BATCH}: fp32 {row['fp32_ms']:.4f} ms (C entry {row['fp32_c_entry_ms']:.4f}, plain "
            f"{row['fp32_plain_ms']:.4f}, bound {row['fp32_bound_ms']:.4f}), bf16 {row['bf16_ms']:.4f} ms "
            f"(C entry {row['bf16_c_entry_ms']:.4f}, plain {row['bf16_plain_ms']:.4f}, "
            f"bound {row['bf16_bound_ms']:.4f} {row['bf16_bound_by']}, contraction only, cuBLAS "
            f"{row['bf16_contraction_cublas_ms']:.4f}); batch {BIG_BATCH}: fp32 {row['b64_fp32_ms']:.4f} "
            f"ms (bound {row['b64_fp32_bound_ms']:.4f}), bf16 {row['b64_bf16_ms']:.4f} ms (bound "
            f"{row['b64_bf16_bound_ms']:.4f} {row['b64_bf16_bound_by']}, contraction only, cuBLAS "
            f"{row['b64_bf16_contraction_cublas_ms']:.4f})")
    return rows


def median_ms(fn, n=5):
    """Median host ms of ``n`` calls of ``fn``, each ending in a
    synchronisation, after one warm-up call; and all of them."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t1))
    return statistics.median(times), times


def profile_call(fn):
    """The torch.profiler events of one call of ``fn`` and the call's wall
    ms (the profiler's own cost inflates the wall time a little)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    return prof.events(), wall_ms


def device_breakdown(fn):
    """Device time by kernel kind over one call of ``fn``, the top kernels,
    and the device's busy share of the call's wall time."""
    events, wall_ms = profile_call(fn)
    by_kind, by_name = {}, {}
    for e in events:
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
    dcn_cuda.reset_launch_counts()
    out = infer(model, images, edge_idx, edge_len, calib, pad_t, size_t)
    torch.cuda.synchronize()
    launches = dcn_cuda.deform_conv2d.launches_by_kernel["dcn_fwd_f32"]
    dets = out["dets"]
    if tuple(dets.shape) != (BATCH, 50, 14) or not bool(torch.isfinite(dets).all()):
        raise AssertionError(f"rows {tuple(dets.shape)}, finite={bool(torch.isfinite(dets).all())}")
    if launches != 16 or fwd_launches() != 16:
        raise AssertionError(f"the DCN kernels launched {dcn_cuda.deform_conv2d.launches_by_kernel} "
                             "in one fp32 forward, not dcn_fwd_f32 16 times")
    lines = format_kitti_lines(dets[0].cpu(), out["valid"][0].cpu(), cfg.datasets.detect_classes)
    say("main path", time.perf_counter() - t0,
        f"rows {tuple(dets.shape)} finite, {launches} kernel launches, "
        f"{int(out['valid'].sum())} valid rows, {len(lines)} KITTI lines in image 0")

    t0 = time.perf_counter()
    args = (images, edge_idx, edge_len)
    with torch.no_grad():
        k = model(*args, lazy_topk=True)
        set_dcn_impl(model, "dense")
        p = model(*args, lazy_topk=True)
        set_dcn_impl(model, "auto")
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
    fwd_ms, fwd_all = median_ms(lambda: infer(model, images, edge_idx, edge_len, calib, pad_t, size_t))
    say("main path", time.perf_counter() - t0,
        f"forward + postprocess at batch {BATCH}: median {fwd_ms:.2f} ms, "
        f"{BATCH * 1e3 / fwd_ms:.2f} images/s")

    t0 = time.perf_counter()
    prof = device_breakdown(lambda: infer(model, images, edge_idx, edge_len, calib, pad_t, size_t))
    kinds = ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(prof["by_kind"].items()))
    say("main path", time.perf_counter() - t0,
        f"profiled forward: wall {prof['wall_ms']:.2f} ms, device {prof['device_ms']:.2f} ms "
        f"(busy {100 * prof['busy_share']:.1f}%): {kinds}")
    ctx = dict(cfg=cfg, model=model, gen=gen, inputs=(images, edge_idx, edge_len),
               post=(calib, pad_t, size_t))
    return dict(launches=launches, forward_ms=fwd_ms, images_per_s=BATCH * 1e3 / fwd_ms,
                forward_ms_all=fwd_all,
                kernel_vs_plain_rel_err=errs, valid_rows=int(out["valid"].sum()), profile=prof), ctx


def matched_rows(got, want):
    """(image, got index, want index) of the peaks both chose, matched by
    point: near-equal scores may order differently in the top-K."""
    pg, pw = got["points_xy"].cpu().numpy(), want["points_xy"].cpu().numpy()
    out = []
    for b in range(pg.shape[0]):
        where = {tuple(p): i for i, p in enumerate(pg[b])}
        out += [(b, where[tuple(p)], j) for j, p in enumerate(pw[b]) if tuple(p) in where]
    return [np.array(x, dtype=np.int64) for x in zip(*out)] if out else [np.zeros(0, np.int64)] * 3


def heads_errors(cfg, got, want):
    """Per head, max abs err at the matched peaks over the head's largest
    magnitude there; the heatmap's max abs err; the matched share."""
    head = cfg.model.head
    k2c = Converter_key2channel(head.regression_heads, head.regression_channels)
    b, ig, iw = matched_rows(got, want)
    errs = {"cls": float((got["cls"] - want["cls"]).abs().max()),
            "matched_peaks": len(b) / want["points_xy"].shape[0] / want["points_xy"].shape[1]}
    for key, _ in head.reg_channels_flat:
        if not len(b):
            errs[key] = float("inf")
            continue
        sl = k2c(key)
        g, w = got["reg_pois"][b, ig, sl], want["reg_pois"][b, iw, sl]
        errs[key] = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
    return errs


def rows_matched(got, want, tol):
    """Share of ``want``'s valid rows that have a row in ``got`` with the
    nearest 2D box centre and depth whose every column is within ``tol`` of
    that column's largest magnitude."""
    dg, dw = got["dets"].cpu().numpy(), want["dets"].cpu().numpy()
    vw = want["valid"].cpu().numpy()
    scale = np.abs(dw).max(axis=(0, 1))
    hit = total = 0
    for b in range(dw.shape[0]):
        centre = lambda d: np.stack([d[:, 2] + d[:, 4], d[:, 3] + d[:, 5], d[:, 11]], 1)
        cg, cw = centre(dg[b]), centre(dw[b])
        for i in np.nonzero(vw[b])[0]:
            j = int(np.argmin(np.abs(cg - cw[i]).sum(1)))
            total += 1
            hit += bool(np.all(np.abs(dg[b, j] - dw[b, i]) <= tol * scale + 1e-6))
    return hit / max(total, 1), total


def phase_main_path_bf16(ctx):
    """The main path in bf16 (cfg.model.fp16, as bench.py runs it) on the fp32
    phase's weights: 16 dcn_fwd_bf16 launches; bf16 against fp32 block by
    block and head by head; the kernel against the plain version; times at
    batch 2 and 64."""
    t0 = time.perf_counter()
    cfg, m32 = ctx["cfg"], ctx["model"]
    cfg16 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, fp16=True))
    m16 = build_detector(cfg16, device="cuda", seed=0)
    m16.load_state_dict(m32.state_dict())
    images, edge_idx, edge_len = ctx["inputs"]
    calib, pad_t, size_t = ctx["post"]
    dcn_cuda.reset_launch_counts()
    out = infer(m16, images, edge_idx, edge_len, calib, pad_t, size_t)
    torch.cuda.synchronize()
    launches = dict(dcn_cuda.deform_conv2d.launches_by_kernel)
    if launches != {"dcn_fwd_f32": 0, "dcn_fwd_bf16": 16}:
        raise AssertionError(f"the bf16 forward launched {launches}, not dcn_fwd_bf16 16 times")
    dets = out["dets"]
    if tuple(dets.shape) != (BATCH, 50, 14) or dets.dtype != torch.float32 or \
            not bool(torch.isfinite(dets).all()):
        raise AssertionError(f"bf16 rows {tuple(dets.shape)} {dets.dtype}, "
                             f"finite={bool(torch.isfinite(dets).all())}")
    say("main path bf16", time.perf_counter() - t0,
        f"rows {tuple(dets.shape)} fp32 finite, launches {launches}")

    # bf16 against fp32, each block fed the same input: the random network
    # amplifies rounding by ~100x from input to heads (measured below), so
    # the whole forward is compared too but not held to the limit
    t0 = time.perf_counter()
    kinds = ("BasicBlock", "Root", "DeformConv")
    names = {"backbone.base.base_layer", "backbone.base.level0", "backbone.base.level1"}
    names |= {n for n, m in m16.named_modules() if type(m).__name__ in kinds or n.endswith(".project")}
    seen = {}
    hooks = [m.register_forward_hook(lambda _m, i, o, n=n: seen.__setitem__(n, (i, o)))
             for n, m in m16.named_modules() if n in names]
    with torch.no_grad():
        feats = m16.backbone(images.to(torch.bfloat16).permute(0, 3, 1, 2))
    for h in hooks:
        h.remove()
    twins, mods = dict(m32.named_modules()), dict(m16.named_modules())
    blocks, dcn_local = {}, {}
    with torch.no_grad():
        for n, (inp, o) in seen.items():
            want = twins[n](*(t.float() for t in inp))
            blocks[n] = float((o.float() - want).abs().max()) / float(want.abs().max())
            if type(mods[n]).__name__ == "DeformConv":  # its DCN: the kernel against the plain form
                dcn = mods[n].conv
                got = dcn(inp[0]).float()
                dcn.impl = "dense"
                want = dcn(inp[0]).float()
                dcn.impl = "auto"
                dcn_local[n] = float((got - want).abs().max()) / float(want.abs().max())
    del seen
    worst_block = max(blocks, key=blocks.get)
    if blocks[worst_block] > BF16_TOL:
        raise AssertionError(f"bf16 vs fp32 block {worst_block}: rel err {blocks[worst_block]}")
    args = (edge_idx, edge_len)
    with torch.no_grad():
        h16 = m16.heads(feats, *args, lazy_topk=True)
        h32 = m32.heads(feats.float(), *args, lazy_topk=True)
    heads = heads_errors(cfg, h16, h32)
    rows = rows_matched(postprocess(cfg, h16, calib.cuda(), pad_t.cuda(), size_t.cuda()),
                        postprocess(cfg, h32, calib.cuda(), pad_t.cuda(), size_t.cuda()), BF16_TOL)
    bad = {k: v for k, v in heads.items() if k != "matched_peaks" and v > BF16_TOL}
    if bad or heads["matched_peaks"] < MIN_MATCHED or rows[0] < MIN_MATCHED:
        raise AssertionError(f"bf16 vs fp32 heads on the same features: {heads}, rows matched {rows}")
    with torch.no_grad():
        whole16 = m16(images, *args, lazy_topk=True)
        whole32 = m32(images, *args, lazy_topk=True)
    whole = heads_errors(cfg, whole16, whole32)
    say("main path bf16", time.perf_counter() - t0,
        f"bf16 vs fp32, same input per block: worst {worst_block} {blocks[worst_block]:.3g} "
        f"({len(blocks)} blocks); heads on the same features: {heads}, rows matched {rows} "
        f"(tol {BF16_TOL}); whole forward (not held to it): {whole}")

    # the kernel against the plain clamped form in bf16: each DCN on the
    # same input (both round the samples once to bf16; they differ in the
    # order of the fp32 sums, so an output may round to the next bf16
    # value), then the whole forward, where such flips are amplified and a
    # few near-tied peaks may trade places
    t0 = time.perf_counter()
    worst_dcn = max(dcn_local, key=dcn_local.get)
    if len(dcn_local) != 16 or dcn_local[worst_dcn] > BF16_TOL:
        raise AssertionError(f"bf16 kernel vs plain, DCN by DCN: {dcn_local}")
    with torch.no_grad():
        k = m16(images, *args, lazy_topk=True)
        set_dcn_impl(m16, "dense")
        p = m16(images, *args, lazy_topk=True)
        set_dcn_impl(m16, "auto")
    kvp = heads_errors(cfg, k, p)
    bad = {key: v for key, v in kvp.items() if key != "matched_peaks" and v > BF16_TOL}
    if kvp["matched_peaks"] < MIN_MATCHED or bad:
        raise AssertionError(f"bf16 kernel vs plain forward: {kvp}")
    say("main path bf16", time.perf_counter() - t0,
        f"bf16 kernel vs plain: DCN by DCN on the same input, worst {worst_dcn} "
        f"{dcn_local[worst_dcn]:.3g}; whole forward {kvp} (tol {BF16_TOL})")

    t0 = time.perf_counter()
    topk = topk_times(cfg)
    say("main path bf16", time.perf_counter() - t0,
        f"top-K of a batch-{BIG_BATCH} heat map {topk['shape']}: select_topk (stable sorts) "
        f"{topk['select_topk_ms']:.3f} ms, the same by torch.topk {topk['torch_topk_ms']:.3f} ms")
    timing = {}
    for batch in (BATCH, BIG_BATCH):
        t0 = time.perf_counter()
        if batch == BATCH:
            bargs = (images, edge_idx, edge_len, calib, pad_t, size_t)
        else:
            gen = torch.Generator(device="cuda").manual_seed(2)
            big = torch.randn((batch, *images.shape[1:]), generator=gen, device="cuda")
            tile = lambda t: t[:1].expand(batch, *t.shape[1:]).contiguous()
            bargs = (big, *(tile(t) for t in (edge_idx, edge_len, calib, pad_t, size_t)))
        fwd_ms, fwd_all = median_ms(lambda: infer(m16, *bargs))
        prof = device_breakdown(lambda: infer(m16, *bargs))
        kinds_ms = ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(prof["by_kind"].items()))
        timing[batch] = dict(forward_ms=fwd_ms, images_per_s=batch * 1e3 / fwd_ms,
                             forward_ms_all=fwd_all, profile=prof)
        say("main path bf16", time.perf_counter() - t0,
            f"forward + postprocess at batch {batch}: median {fwd_ms:.2f} ms, "
            f"{batch * 1e3 / fwd_ms:.2f} images/s; profiled forward: wall {prof['wall_ms']:.2f} ms, device "
            f"{prof['device_ms']:.2f} ms (busy {100 * prof['busy_share']:.1f}%): {kinds_ms}")
        del bargs
    return dict(launches=launches, blocks=blocks, heads_same_features=heads, rows_matched=rows,
                whole_forward=whole, kernel_vs_plain_per_dcn=dcn_local, kernel_vs_plain=kvp,
                timing=timing, topk=topk)


def topk_times(cfg):
    """Device ms of ``select_topk`` (two stable descending sorts, so that
    ties break as ``jax.lax.top_k`` breaks them) on a heat map of the bf16
    forward's shape at batch BIG_BATCH, and of the same two-stage top-K by
    ``torch.topk``, which breaks ties otherwise: what the sorts cost."""
    B, C = BIG_BATCH, cfg.datasets.max_classes_num
    H = cfg.input.height_train // cfg.model.backbone.down_ratio
    W = cfg.input.width_train // cfg.model.backbone.down_ratio
    K = cfg.test.detections_per_img
    gen = torch.Generator(device="cuda").manual_seed(3)
    hm = nms_hm(torch.rand((B, H, W, C), generator=gen, device="cuda"))

    def by_torch_topk():
        scores, _ = torch.topk(hm.permute(0, 3, 1, 2).reshape(B, C, H * W), K)
        return torch.topk(scores.reshape(B, C * K), K)

    t = timed_turns([("sort", lambda: select_topk(hm, K)), ("topk", by_torch_topk)], 5)
    return dict(shape=[B * C, H * W], select_topk_ms=t["sort"], torch_topk_ms=t["topk"])


def bwd_bound_ms(cin, cout, h, w, batch, dtype=torch.float32):
    """Least times of the two backward functions at this shape, both ways:
    {"k2"|"k3": {"tf32x3": (ms, by), "fp32_fma": (ms, by)}} in fp32, and
    {"k2"|"k3": {"bf16": (ms, by)}} for bf16 inputs. Bytes: each input read
    once, each output written once (offsets and grad_offset fp32, the rest in
    the inputs' type). Operations, counted
    from dcn_bwd.cu: the contractions, 2 * 9 * Cin * Cout per pixel each
    (K2: the tap products U and grad_weight; K3: G times W), and the
    sampling outside them: 21 per pixel, tap and input channel for the
    samples, their offset derivatives and the three products with U, and 1
    for grad_weight's operand mask * s (K2; bwd_weight_kernel gathers the
    samples a second time, a choice of design that the function does not
    need, so those 8 are not counted); 8 per pixel, tap and output channel
    for the four corners' FMAs of the gather G (K3). The kernels run the
    contractions on the tensor cores as 3xTF32, so the bound is "tf32x3":
    the contractions at a third of the TF32 rate plus the sampling at the
    fp32 rate. "fp32_fma" (every operation at 67 TFLOP/s, the bound of
    fp32-FMA kernels) is kept beside it; a tensor-core kernel can beat it.
    With bf16 inputs the least time takes every contraction at the dense
    bf16 rate (989 TFLOP/s) and the sampling at the fp32 rate; the kernels
    widen to fp32 and run 3xTF32, so this bound is the one a bf16 mma.sync or
    wgmma design would chase."""
    p = batch * h * w
    contraction = 2 * p * 9 * cin * cout
    if dtype == torch.bfloat16:
        sides = {
            "k2": (2 * (p * (cin + 9 + cout) + 9 * cin * cout) + 4 * p * 18
                   + 4 * p * 18 + 2 * (p * 9 + 9 * cin * cout), 2 * contraction, (21 + 1) * p * 9 * cin),
            "k3": (4 * p * 18 + 2 * (p * (9 + cout) + 9 * cin * cout + p * cin), contraction,
                   8 * p * 9 * cout),
        }
        return {name: {"bf16": roofline_ms(nbytes, con, smp, BF16_FLOP_PER_S)}
                for name, (nbytes, con, smp) in sides.items()}
    sides = {
        "k2": (4 * (p * (cin + 18 + 9 + cout) + 9 * cin * cout + p * (18 + 9) + 9 * cin * cout),
               2 * contraction, (21 + 1) * p * 9 * cin),
        "k3": (4 * (p * (18 + 9 + cout) + 9 * cin * cout + p * cin), contraction, 8 * p * 9 * cout),
    }
    return {name: {"tf32x3": roofline_ms(nbytes, con, smp, TF32X3_FLOP_PER_S),
                   "fp32_fma": roofline_ms(nbytes, con + smp, 0, FP32_FLOP_PER_S)}
            for name, (nbytes, con, smp) in sides.items()}


def _rel_err(got, want):
    """max |got - want| and the largest |want|."""
    return float((got - want).abs().max()), float(want.abs().max())


BWD_BATCHES = (BATCH, 8)  # the main path's batch, and the run config's ims_per_batch


def bwd_contractions_cublas_ms(cin, cout, h, w, batch, gen):
    """The backward's contractions alone in cuBLAS (fp32, TF32 off), a
    yardstick only, not the same functions: K2 the tap products g W^T
    ((P, Cout) by (Cout, 9 Cin)) and grad_weight's columns^T g ((9 Cin, P)
    by (P, Cout)); K3 the gathered G by W ((P, 9 Cout) by (9 Cout, Cin))."""
    p = batch * h * w
    g = torch.randn((p, cout), generator=gen, device="cuda")
    wt = torch.randn((cout, 9 * cin), generator=gen, device="cuda")
    cols = torch.randn((p, 9 * cin), generator=gen, device="cuda")
    gcols = torch.randn((p, 9 * cout), generator=gen, device="cuda")
    wx = torch.randn((9 * cout, cin), generator=gen, device="cuda")
    t = timed_turns([("u", lambda: torch.matmul(g, wt)), ("gw", lambda: torch.matmul(cols.T, g)),
                     ("gx", lambda: torch.matmul(gcols, wx))], 3)
    return t["u"] + t["gw"], t["gx"]


def phase_backward():
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for cin, cout, h, w, count in DCN_SHAPES:
        for batch in BWD_BATCHES:
            rows.append(backward_shape(cin, cout, h, w, count, batch, gen))
            torch.cuda.empty_cache()
    return rows, backward_radius()


def backward_shape(cin, cout, h, w, count, batch, gen):
    """K2 and K3 at one shape and batch: checked, bitwise repeatable, the
    Function's grad_x bitwise that of K3 alone, timed beside the plain
    versions, the bounds and the contractions in cuBLAS."""
    t0 = time.perf_counter()
    tag = f"{cin}->{cout}@{batch}x{h}x{w}"
    x, off, mask, weight, _ = dcn_inputs(cin, cout, h, w, gen, batch)
    g = torch.randn((batch, h, w, cout), generator=gen, device="cuda")
    go, gm, gw = dcn_cuda.dcn_bwd_pom(x, off, mask, weight, g, RADIUS)
    gx = dcn_cuda.dcn_bwd_x(x, off, mask, weight, g, RADIUS)
    again = dcn_cuda.dcn_bwd_pom(x, off, mask, weight, g, RADIUS)
    gx_again = dcn_cuda.dcn_bwd_x(x, off, mask, weight, g, RADIUS)
    # grad_x through the autograd Function (K2 and K3 back to back, as the
    # train step runs them) against K3 alone
    leaves = [t.detach().requires_grad_() for t in (x, off, mask, weight)]
    DeformConv2dFunction.apply(*leaves, None, RADIUS).backward(g)
    gx_function = leaves[0].grad
    del leaves
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
            raise AssertionError(f"{name} {tag}: max abs err {err} > {BWD_TOL} x {scale}")
    del want
    # a NaN offset drops its tap: the kernels give what autograd of the
    # plain version gives, and no NaN
    nan_off = with_nan_offsets(off)
    nan_got = dict(zip(("grad_offset", "grad_mask", "grad_weight"),
                       dcn_cuda.dcn_bwd_pom(x, nan_off, mask, weight, g, RADIUS)))
    nan_got["grad_x"] = dcn_cuda.dcn_bwd_x(x, nan_off, mask, weight, g, RADIUS)
    nan_want = dict(zip(("grad_offset", "grad_mask", "grad_weight"),
                        dcn_bwd_pom_plain(x, nan_off, mask, weight, g, RADIUS)))
    nan_want["grad_x"] = dcn_bwd_x_plain(x, nan_off, mask, weight, g, RADIUS)
    for name, t in nan_got.items():
        err, _ = check_kernel(t, nan_want[name], BWD_TOL, f"NaN offsets {name} {tag}")
        errs[name]["nan_max_abs_err"] = err
    del nan_got, nan_want
    for a, b, name in ((go, again[0], "grad_offset"), (gm, again[1], "grad_mask"),
                       (gw, again[2], "grad_weight"), (gx, gx_again, "grad_x"),
                       (gx, gx_function, "grad_x through DeformConv2dFunction and alone")):
        if not torch.equal(a, b):
            raise AssertionError(f"{name} {tag}: two runs differ")
    del again, gx_again, gx_function
    errs_bf16 = backward_bf16(x, off, mask, weight, g, nan_off, tag)
    del nan_off

    bf = [x.bfloat16(), off, mask.bfloat16(), weight.bfloat16(), g.bfloat16()]
    fns = {"k2": lambda: dcn_cuda.dcn_bwd_pom(x, off, mask, weight, g, RADIUS),
           "k3": lambda: dcn_cuda.dcn_bwd_x(x, off, mask, weight, g, RADIUS),
           "p2": lambda: dcn_bwd_pom_plain(x, off, mask, weight, g, RADIUS),
           "p3": lambda: dcn_bwd_x_plain(x, off, mask, weight, g, RADIUS),
           "k2b": lambda: dcn_cuda.dcn_bwd_pom(*bf, RADIUS),
           "k3b": lambda: dcn_cuda.dcn_bwd_x(*bf, RADIUS),
           "p2b": lambda: dcn_bwd_pom_plain(*bf, RADIUS),
           "p3b": lambda: dcn_bwd_x_plain(*bf, RADIUS)}
    for fn in fns.values():
        fn()
    times = {name: [] for name in fns}
    for _ in range(3):
        for name in ("p2", "k2", "k2", "p2", "p3", "k3", "k3", "p3",
                     "p2b", "k2b", "k2b", "p2b", "p3b", "k3b", "k3b", "p3b"):
            times[name].append(cuda_ms(fns[name]))
    del x, off, mask, weight, g, go, gm, gw, gx, bf, fns
    k2_cublas, k3_cublas = bwd_contractions_cublas_ms(cin, cout, h, w, batch, gen)
    bounds = bwd_bound_ms(cin, cout, h, w, batch)
    bounds_bf16 = bwd_bound_ms(cin, cout, h, w, batch, torch.bfloat16)
    row = dict(cin=cin, cout=cout, h=h, w=w, batch=batch, count=count, errors=errs,
               errors_bf16=errs_bf16,
               pom_bf16_ms=statistics.median(times["k2b"]),
               pom_bf16_plain_ms=statistics.median(times["p2b"]),
               pom_bf16_bound_ms=bounds_bf16["k2"]["bf16"][0],
               pom_bf16_bound_by=bounds_bf16["k2"]["bf16"][1],
               x_bf16_ms=statistics.median(times["k3b"]),
               x_bf16_plain_ms=statistics.median(times["p3b"]),
               x_bf16_bound_ms=bounds_bf16["k3"]["bf16"][0],
               x_bf16_bound_by=bounds_bf16["k3"]["bf16"][1],
               pom_ms=statistics.median(times["k2"]), pom_plain_ms=statistics.median(times["p2"]),
               pom_bound_ms=bounds["k2"]["tf32x3"][0], pom_bound_by=bounds["k2"]["tf32x3"][1],
               pom_bound_fma_ms=bounds["k2"]["fp32_fma"][0], pom_cublas_ms=k2_cublas,
               x_ms=statistics.median(times["k3"]), x_plain_ms=statistics.median(times["p3"]),
               x_bound_ms=bounds["k3"]["tf32x3"][0], x_bound_by=bounds["k3"]["tf32x3"][1],
               x_bound_fma_ms=bounds["k3"]["fp32_fma"][0], x_cublas_ms=k3_cublas)
    rel = ", ".join(f"{k} {v['max_abs_err']:.3g} (max {v['scale']:.3g}, NaN {v['nan_max_abs_err']:.3g})"
                    for k, v in errs.items())
    say("backward", time.perf_counter() - t0,
        f"{tag} x{count}: {rel}; bitwise repeatable, Function = alone; "
        f"K2 {row['pom_ms']:.4f} ms (plain {row['pom_plain_ms']:.4f}, bound 3xTF32 "
        f"{row['pom_bound_ms']:.4f} {row['pom_bound_by']}, fp32 FMA {row['pom_bound_fma_ms']:.4f}, "
        f"contractions only, cuBLAS {k2_cublas:.4f}), "
        f"K3 {row['x_ms']:.4f} ms (plain {row['x_plain_ms']:.4f}, bound 3xTF32 {row['x_bound_ms']:.4f} "
        f"{row['x_bound_by']}, fp32 FMA {row['x_bound_fma_ms']:.4f}, contraction only, cuBLAS "
        f"{k3_cublas:.4f}); bf16 inputs: "
        + ", ".join(f"{k} {v['max_abs_err']:.3g} (vs fp32 kernels {v['vs_fp32_max_abs_err']:.3g}, "
                    f"NaN {v['nan_max_abs_err']:.3g})" for k, v in errs_bf16.items())
        + f"; K2 bf16 {row['pom_bf16_ms']:.4f} ms (plain {row['pom_bf16_plain_ms']:.4f}, bound "
        f"{row['pom_bf16_bound_ms']:.4f} {row['pom_bf16_bound_by']}), K3 bf16 {row['x_bf16_ms']:.4f} ms "
        f"(plain {row['x_bf16_plain_ms']:.4f}, bound {row['x_bf16_bound_ms']:.4f} "
        f"{row['x_bf16_bound_by']})")
    return row


def backward_bf16(x, off, mask, weight, g, nan_off, tag):
    """K2 and K3 on bf16 x, mask, weight and cotangent (offsets fp32), as the
    bf16 train step gives them: the gradients in their inputs' types, against
    the plain versions (fp32 autograd on the widened values, then the cast;
    grad_offset <= BWD_TOL, the bf16 ones <= BWD_BF16_TOL of scale: one bf16
    rounding on either side), with NaN offsets too; the kernels' fp32
    outputs, before the cast, against the fp32 kernels on the same values
    widened to fp32 (<= BF16_VS_FP32_TOL; the bf16 kernels widen as they
    load and sum in the fp32 kernels' order); two runs bitwise equal."""
    xb, mb, wb, gb = x.bfloat16(), mask.bfloat16(), weight.bfloat16(), g.bfloat16()
    names = ("grad_offset", "grad_mask", "grad_weight", "grad_x")
    got = [*dcn_cuda.dcn_bwd_pom(xb, off, mb, wb, gb, RADIUS), dcn_cuda.dcn_bwd_x(xb, off, mb, wb, gb, RADIUS)]
    again = [*dcn_cuda.dcn_bwd_pom(xb, off, mb, wb, gb, RADIUS), dcn_cuda.dcn_bwd_x(xb, off, mb, wb, gb, RADIUS)]
    dtypes = [t.dtype for t in got]
    if dtypes != [torch.float32] + [torch.bfloat16] * 3:
        raise AssertionError(f"bf16 {tag}: gradient dtypes {dtypes}")
    want = [*dcn_bwd_pom_plain(xb, off, mb, wb, gb, RADIUS), dcn_bwd_x_plain(xb, off, mb, wb, gb, RADIUS)]
    raw = [*dcn_cuda.dcn_bwd_pom_fp32_out(xb, off, mb, wb, gb, RADIUS),
           dcn_cuda.dcn_bwd_x_fp32_out(xb, off, mb, wb, gb, RADIUS)]
    wide = [xb.float(), off, mb.float(), wb.float(), gb.float()]
    ref = [*dcn_cuda.dcn_bwd_pom_fp32_out(*wide, RADIUS), dcn_cuda.dcn_bwd_x_fp32_out(*wide, RADIUS)]
    nan_got = [*dcn_cuda.dcn_bwd_pom(xb, nan_off, mb, wb, gb, RADIUS),
               dcn_cuda.dcn_bwd_x(xb, nan_off, mb, wb, gb, RADIUS)]
    nan_want = [*dcn_bwd_pom_plain(xb, nan_off, mb, wb, gb, RADIUS),
                dcn_bwd_x_plain(xb, nan_off, mb, wb, gb, RADIUS)]
    errs = {}
    for i, name in enumerate(names):
        tol = BWD_TOL if name == "grad_offset" else BWD_BF16_TOL
        err, scale = check_kernel(got[i], want[i], tol, f"bf16 {name} {tag}")
        nan_err, _ = check_kernel(nan_got[i], nan_want[i], tol, f"bf16 NaN offsets {name} {tag}")
        wide_err, _ = check_kernel(raw[i], ref[i], BF16_VS_FP32_TOL, f"bf16 vs fp32 kernels {name} {tag}")
        if not torch.equal(got[i], again[i]):
            raise AssertionError(f"bf16 {name} {tag}: two runs differ")
        errs[name] = dict(max_abs_err=err, scale=scale, nan_max_abs_err=nan_err,
                          vs_fp32_max_abs_err=wide_err)
    return errs


def backward_radius():
    """K3 beyond the old radius limit of 4: at radius 5, 7 and 9 (the
    largest), fp32 and bf16, against its plain version at the 128 -> 64
    shape (batch 2, offsets of std radius / 2, some beyond the clip);
    radius 10, whose halo needs more shared memory than a block may have,
    raises naming it."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(3)
    cin, cout, h, w = 128, 64, 48, 160
    out = {}
    for radius in (5, 7, dcn_cuda.BWD_X_MAX_RADIUS):
        x, off, mask, weight, _ = dcn_inputs(cin, cout, h, w, gen)
        off = off * (radius / 3.0)
        g = torch.randn((BATCH, h, w, cout), generator=gen, device="cuda")
        for dtype, tol in ((torch.float32, BWD_TOL), (torch.bfloat16, BWD_BF16_TOL)):
            args = (x.to(dtype), off, mask.to(dtype), weight.to(dtype), g.to(dtype))
            err, scale = check_kernel(dcn_cuda.dcn_bwd_x(*args, radius), dcn_bwd_x_plain(*args, radius),
                                      tol, f"K3 radius {radius} {dtype}")
            out[f"r{radius}_{str(dtype)[6:]}"] = dict(max_abs_err=err, scale=scale,
                                                       clipped_share=float((off.abs() > radius).float().mean()))
    try:
        x, off, mask, weight, _ = dcn_inputs(cin, cout, h, w, gen)
        dcn_cuda.dcn_bwd_x(x, off, mask, weight, torch.zeros((BATCH, h, w, cout), device="cuda"), 10)
    except ValueError as e:
        if "shared memory" not in str(e):
            raise
        out["radius_10_error"] = str(e)
    else:
        raise AssertionError("K3 at radius 10 did not raise")
    say("backward", time.perf_counter() - t0,
        f"K3 at radius 5 and 7 (128->64@{BATCH}x{h}x{w}) against its plain version: "
        + ", ".join(f"{k} {v['max_abs_err']:.3g} (max {v['scale']:.3g})" for k, v in out.items()
                    if k.startswith("r") and isinstance(v, dict))
        + f"; radius 10: {out['radius_10_error']}")
    return out


def scenes(cfg, n=BATCH):
    """``n`` synthetic KITTI scenes of 1242x375 with 6 cars each, encoded by
    the port's target encoder."""
    return [encode_targets(*make_scene(seed=s, num_objs=6), cfg, img_id=f"{s:06d}")
            for s in range(n)]


def _pair_heads(cfg):
    groups = [gi for gi, g in enumerate(cfg.model.head.regression_heads)
              if "extra_kpts_2d" in g or "extra_kpts_3d" in g]
    return tuple(f"heads.{kind}.{gi}." for gi in groups for kind in ("reg_features", "reg_heads"))


def step_parity(trainer, batch, grad_tol, any_bias_by_weight=False):
    """Forward, loss and backward of one step from one deep copy of the
    trainer, with the kernels and with the plain DCN. Loss terms must agree
    to STEP_LOSS_TOL relative and gradients to ``grad_tol`` of each
    tensor's largest magnitude, except where the function itself is
    ill-conditioned (tests/test_torch_train.py measures it on the CPU): the
    terms built on the edge-pair depths (PAIR_LOSS_TOL), the heads that feed
    the pair solve, whose gradient has switches (top-k of pairs, the depth
    clamp) that rounding can flip (relative Frobenius norm,
    PAIR_HEADS_FRO_TOL), and the biases that a train-mode BN removes, whose
    exact gradient is 0 (held to their layer's weight-gradient scale); with
    ``any_bias_by_weight`` every bias so (with every BN in its linear range
    the next BN removes a trunk BN's shift: its gradient is rounding noise,
    as ``parallel.workers.gradient_errors`` states). Returns the largest
    errors of each kind, the largest offset the DCNs emitted and the share
    of offsets beyond the clamp."""
    out, offsets = {}, []
    for impl in ("auto", "dense"):
        t = copy.deepcopy(trainer)
        set_dcn_impl(t.model, impl)
        hooks = [m.conv_offset_mask.register_forward_hook(
            lambda _m, _i, o: offsets.append(o[:, :18].detach().abs().flatten()))
            for m in t.model.modules() if isinstance(m, DCN) and impl == "auto"]
        logs = compute_gradients(t, batch)
        for h in hooks:
            h.remove()
        grads = {n: p.grad for n, p in t.model.named_parameters() if p.grad is not None}
        out[impl] = ({k: float(v) for k, v in logs.items()}, grads)
        del t
    (lk, gk), (lp, gp) = out["auto"], out["dense"]
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
                                    (n.startswith("heads.trunc_") and n.endswith("_conv.0.bias"))
                                    or (any_bias_by_weight and base + "weight" in gp)):
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
    batch = collate(scenes(cfg))
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
    parity0 = step_parity(trainer, batch, STEP0_GRAD_TOL)
    say("train", time.perf_counter() - t0, f"step 0 (all offsets 0) kernel vs plain: {parity0}")
    t0 = time.perf_counter()
    linear = copy.deepcopy(trainer)
    linear_range_bn(linear.model)
    parity0_linear = step_parity(linear, batch, STEP_GRAD_TOL, any_bias_by_weight=True)
    del linear
    say("train", time.perf_counter() - t0,
        f"step 0 with every BN in its linear range, kernel vs plain: {parity0_linear}")

    t0 = time.perf_counter()
    dcn_cuda.reset_launch_counts()
    steps = []
    for i in range(TRAIN_STEPS):
        before = [fwd_launches(), *bwd_launches()]
        logs = train_step(trainer, batch)
        torch.cuda.synchronize()
        after = [fwd_launches(), *bwd_launches()]
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
    bf16_launches = {k: v for k, v in launches_by_entry_point().items() if k.endswith("bf16") and v}
    if bf16_launches:
        raise AssertionError(f"the fp32 train steps launched bf16 entry points: {bf16_launches}")
    say("train", time.perf_counter() - t0,
        f"{TRAIN_STEPS} steps, launches per step {steps[-1]['launches']} (dcn_fwd, dcn_bwd_pom, "
        f"dcn_bwd_x); total_loss " + ", ".join(f"{s['logs']['total_loss']:.4f}" for s in steps)
        + "; grad_norm " + ", ".join(f"{s['logs']['grad_norm']:.4g}" for s in steps))

    # repeatable: a second trainer from the same seed reaches the same bits
    t0 = time.perf_counter()
    twin = build_trainer(cfg, device="cuda", seed=0)
    twin_logs = [{k: float(v) for k, v in train_step(twin, batch).items()} for _ in range(TRAIN_STEPS)]
    if twin_logs != [st["logs"] for st in steps]:
        raise AssertionError(f"two runs of {TRAIN_STEPS} steps from one seed give other losses: "
                             f"{[st['logs']['total_loss'] for st in steps]} vs "
                             f"{[lg['total_loss'] for lg in twin_logs]}")
    ours, theirs = trainer.model.state_dict(), twin.model.state_dict()
    differ = [k for k in ours if not torch.equal(ours[k], theirs[k])]
    if differ:
        raise AssertionError(f"two runs of {TRAIN_STEPS} steps from one seed differ in {differ[:5]}")
    del twin, ours, theirs
    say("train", time.perf_counter() - t0,
        f"a second trainer from seed 0: {TRAIN_STEPS} steps give bitwise equal losses and parameters")

    t0 = time.perf_counter()
    parity = step_parity(trainer, batch, STEP_GRAD_TOL)
    say("train", time.perf_counter() - t0, f"after {TRAIN_STEPS} steps kernel vs plain: {parity}")

    t0 = time.perf_counter()
    # what the deterministic mode costs: the same steps without it, then back
    trainer.deterministic = False
    loose_ms, loose_all = median_ms(lambda: train_step(trainer, batch))
    trainer.deterministic = True
    step_ms, step_all = median_ms(lambda: train_step(trainer, batch))
    prof = device_breakdown(lambda: train_step(trainer, batch))
    kinds = ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(prof["by_kind"].items()))
    say("train", time.perf_counter() - t0,
        f"train step at batch {BATCH}: median {step_ms:.2f} ms ({BATCH * 1e3 / step_ms:.2f} images/s; "
        f"without the deterministic mode {loose_ms:.2f} ms); "
        f"profiled step: wall {prof['wall_ms']:.2f} ms, device {prof['device_ms']:.2f} ms "
        f"(busy {100 * prof['busy_share']:.1f}%): {kinds}")
    return dict(launches=launches, steps=steps, parity_step0=parity0,
                parity_step0_linear_bn=parity0_linear, parity=parity,
                step_ms=step_ms, step_ms_all=step_all, step_ms_nondeterministic=loose_ms,
                step_ms_nondeterministic_all=loose_all, images_per_s=BATCH * 1e3 / step_ms,
                objects=n_obj, profile=prof)


def with_model(cfg, **model):
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **model))


def step_gaps(a, b):
    """Relative differences of step ``a`` against step ``b`` (each the log
    terms and the gradients by name): the RMS over the loss terms of their
    relative differences, the largest of them, and the gradients as one
    vector by relative Frobenius norm, all of them (``grad_fro``) and those
    of each part of the network (``grad_fro_parts``: the trunk, the
    up-sampling path, the heads)."""
    (la, ga), (lb, gb) = a, b
    rel = {k: abs(la[k] - v) / max(abs(v), 1e-30) for k, v in lb.items() if k != "grad_norm"}

    def fro(keys):
        va = torch.cat([ga[k].double().flatten() for k in keys])
        vb = torch.cat([gb[k].double().flatten() for k in keys])
        return float((va - vb).norm() / vb.norm())

    part = lambda name: "heads" if name.startswith("heads.") else ".".join(name.split(".")[:2])
    worst = max(rel, key=rel.get)
    return dict(loss_rms=float(np.sqrt(np.mean(np.square(list(rel.values()))))),
                loss_max=rel[worst], loss_max_term=worst, grad_fro=fro(sorted(gb)),
                grad_fro_parts={p: fro(sorted(k for k in gb if part(k) == p))
                                for p in sorted({part(k) for k in gb})})


def linear_range_bn(model):
    """Every BN's gain times LINEAR_BN_GAIN and its shift LINEAR_BN_SHIFT,
    in place: most ReLUs then work in their linear range, where train-mode
    BN does not grow a rounding difference layer by layer."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm) and m.affine:
                m.weight.mul_(LINEAR_BN_GAIN)
                m.bias.fill_(LINEAR_BN_SHIFT)


def step_of(trainer, batch):
    """compute_gradients of a deep copy: the log terms and the gradients."""
    t = copy.deepcopy(trainer)
    logs = compute_gradients(t, batch)
    grads = {n: p.grad.detach().clone() for n, p in t.model.named_parameters() if p.grad is not None}
    del t
    return {k: float(v) for k, v in logs.items()}, grads


def phase_train_bf16():
    """bf16 training (``cfg.model.fp16``) at full width, batch 2: 16
    launches per step of each bf16 entry point and none of the fp32 ones,
    finite losses and gradients, a second trainer from the same seed bitwise
    equal, the step against the fp32 step from the same weights and against
    the plain DCN's bf16 step, the step time, and ``remat``: the same step
    bitwise, with every BN's ``num_batches_tracked`` advanced by one."""
    t0 = time.perf_counter()
    cfg = with_model(dgde_run_config(), fp16=True)
    trainer = build_trainer(cfg, device="cuda", seed=0)
    batch = collate(scenes(cfg))
    # the fp32 step and the bf16 step from the same seeded weights, their
    # BNs moved into the range where the step is well conditioned
    pair = [build_trainer(c, device="cuda", seed=0) for c in (cfg, dgde_run_config())]
    for t in pair:
        linear_range_bn(t.model)
    vs_fp32 = step_gaps(*(step_of(t, batch) for t in pair))
    del pair
    if not (vs_fp32["loss_rms"] <= BF16_VS_FP32_LOSS_RMS and vs_fp32["grad_fro"] <= BF16_VS_FP32_GRAD_FRO
            and max(vs_fp32["grad_fro_parts"].values()) <= BF16_VS_FP32_PART_FRO):
        raise AssertionError(f"bf16 step against the fp32 step: {vs_fp32}")
    dcn_cuda.reset_launch_counts()
    logs = train_step(trainer, batch)
    torch.cuda.synchronize()
    launches = launches_by_entry_point()
    want = {k: (16 if k.endswith("bf16") else 0) for k in launches}
    if launches != want:
        raise AssertionError(f"bf16 step launches {launches}, not {want}")
    logs = {k: float(v) for k, v in logs.items()}
    bad = [k for k, v in logs.items() if not np.isfinite(v)]
    if bad:
        raise AssertionError(f"bf16 step: non-finite {bad}")
    check_gradients(trainer.model, 0)
    say("train_bf16", time.perf_counter() - t0,
        f"bf16 step at batch {BATCH}: launches {launches}; total_loss {logs['total_loss']:.4f}, grad_norm "
        f"{logs['grad_norm']:.4g}; against the fp32 step from the same weights: {vs_fp32}")

    t0 = time.perf_counter()
    twin = build_trainer(cfg, device="cuda", seed=0)
    twin_logs = {k: float(v) for k, v in train_step(twin, batch).items()}
    ours, theirs = trainer.model.state_dict(), twin.model.state_dict()
    differ = [k for k in ours if not torch.equal(ours[k], theirs[k])]
    if twin_logs != logs or differ:
        raise AssertionError(f"two bf16 steps from one seed differ: {differ[:5]}")
    del twin
    # remat: the forward recomputed in the backward gives the same step, and
    # BN's running statistics move once
    remat = build_trainer(with_model(cfg, remat=True), device="cuda", seed=0)
    dcn_cuda.reset_launch_counts()
    remat_logs = {k: float(v) for k, v in train_step(remat, batch).items()}
    torch.cuda.synchronize()
    remat_launches = launches_by_entry_point()
    theirs = remat.model.state_dict()
    differ = [k for k in ours if not torch.equal(ours[k], theirs[k])]
    counts = {int(v) for k, v in theirs.items() if k.endswith("num_batches_tracked")}
    if remat_logs != logs or differ or counts != {1}:
        raise AssertionError(f"remat step: losses equal {remat_logs == logs}, differing state "
                             f"{differ[:5]}, num_batches_tracked {counts}")
    if (remat_launches["dcn_fwd_bf16"], remat_launches["dcn_bwd_pom_bf16"],
            remat_launches["dcn_bwd_x_bf16"]) != (32, 16, 16):
        raise AssertionError(f"remat step launches {remat_launches}")
    del remat, ours, theirs
    say("train_bf16", time.perf_counter() - t0,
        "a second trainer from seed 0: bitwise equal; remat: bitwise the same step, "
        f"num_batches_tracked 1 everywhere, launches {remat_launches}")

    t0 = time.perf_counter()
    plain = copy.deepcopy(trainer)
    set_dcn_impl(plain.model, "dense")
    vs_plain = step_gaps(step_of(trainer, batch), step_of(plain, batch))
    del plain
    if not (vs_plain["loss_rms"] <= BF16_STEP_LOSS_RMS and vs_plain["grad_fro"] <= BF16_STEP_GRAD_FRO):
        raise AssertionError(f"bf16 step, kernels against the plain DCN: {vs_plain}")
    trainer.deterministic = False
    loose_ms, loose_all = median_ms(lambda: train_step(trainer, batch))
    trainer.deterministic = True
    step_ms, step_all = median_ms(lambda: train_step(trainer, batch))
    prof = device_breakdown(lambda: train_step(trainer, batch))
    kinds = ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(prof["by_kind"].items()))
    say("train_bf16", time.perf_counter() - t0,
        f"after a step, kernels against the plain DCN: {vs_plain}; bf16 train step at batch {BATCH}: "
        f"median {step_ms:.2f} ms (without the deterministic mode {loose_ms:.2f} ms); profiled step: "
        f"wall {prof['wall_ms']:.2f} ms, device {prof['device_ms']:.2f} ms (busy "
        f"{100 * prof['busy_share']:.1f}%): {kinds}")
    return dict(launches=launches, remat_launches=remat_launches, logs=logs, vs_fp32=vs_fp32,
                vs_plain=vs_plain, step_ms=step_ms, step_ms_all=step_all,
                step_ms_nondeterministic=loose_ms, step_ms_nondeterministic_all=loose_all,
                profile=prof)


ORACLE_SCENES, ORACLE_NOISE = 4, (0.0, 1.0)


def phase_oracle():
    """The oracle sweep (``tools/oracle_inject.py``) at 0 and 1 px on a few
    held-out scenes with ``postprocess`` on the card and on this machine's
    CPU: the same AP rows, the same valid rows, and the rows within
    ORACLE_TOL of each column's scale."""
    t0 = time.perf_counter()
    dets = {"cuda": [], "cpu": []}
    rows = {dev: oracle_inject.run_sweep(ORACLE_NOISE, ORACLE_SCENES, device=dev, detections=dets[dev])
            for dev in ("cuda", "cpu")}
    if rows["cuda"] != rows["cpu"]:
        raise AssertionError(f"oracle sweep: card {rows['cuda']} against CPU {rows['cpu']}")
    err = 0.0
    for (n1, i1, d1, v1), (n2, i2, d2, v2) in zip(dets["cuda"], dets["cpu"]):
        if (n1, i1) != (n2, i2) or not np.array_equal(v1, v2):
            raise AssertionError(f"oracle rows of {i1} at {n1} px: valid rows differ")
        scale = np.abs(d2[v2]).max(0).clip(1e-6)
        err = max(err, float((np.abs(d1[v1] - d2[v2]) / scale).max()))
    if not err <= ORACLE_TOL:
        raise AssertionError(f"oracle rows, card against CPU: {err} of a column's scale")
    z = rows["cuda"][0]
    if not z["ap_3d_07"] == z["ap_bbox"] > 0:
        raise AssertionError(f"oracle at 0 px: 3D@0.7 {z['ap_3d_07']} against bbox {z['ap_bbox']}")
    say("oracle", time.perf_counter() - t0,
        f"{ORACLE_SCENES} scenes at {ORACLE_NOISE} px: card = CPU AP rows {rows['cuda']}; rows within "
        f"{err:.3g} of each column's scale")
    return dict(rows=rows["cuda"], rows_card_vs_cpu=err)


def phase_gen(ctx):
    """The gen step on the main path's detector: launches, finite fields,
    kernel against plain, the train JSON round trip, the infer-side pass
    and its JSON, times at batch 2 and 8."""
    t0 = time.perf_counter()
    cfg, model = ctx["cfg"], ctx["model"]
    M = cfg.datasets.max_objects
    n_kpts = cfg.model.head.num_kpts
    samples = scenes(cfg)
    batch = collate(samples)
    gen_step = make_gen_step(cfg, model)
    dcn_cuda.reset_launch_counts()
    out = gen_step(batch)
    torch.cuda.synchronize()
    launches = dict(dcn_cuda.deform_conv2d.launches_by_kernel)
    if launches != {"dcn_fwd_f32": 16, "dcn_fwd_bf16": 0}:
        raise AssertionError(f"the gen step launched {launches}, not dcn_fwd_f32 16 times")
    bad = [k for k, v in out.items() if not bool(torch.isfinite(v).all())]
    n_obj = int(out["mask"].sum())
    if bad or n_obj != int(batch["reg_mask"].sum()):
        raise AssertionError(f"gen step: non-finite {bad}, {n_obj} objects of "
                             f"{int(batch['reg_mask'].sum())}")
    say("gen", time.perf_counter() - t0,
        f"gen step at batch {BATCH}: {launches['dcn_fwd_f32']} dcn_fwd_f32 launches, six fields "
        f"finite, {n_obj} objects")

    t0 = time.perf_counter()
    set_dcn_impl(model, "dense")
    plain = gen_step(batch)
    set_dcn_impl(model, "auto")
    m = out["mask"].bool()
    errs = {}
    for key in ("kpts_2d_img", "kpts_3d", "pred_rot", "pred_location"):
        err, scale = _rel_err(out[key][m], plain[key][m])
        errs[key] = err / scale
        tol = GEN_LOC_TOL if key == "pred_location" else GEN_TOL
        if not err <= tol * scale:
            raise AssertionError(f"gen step kernel vs plain: {key} rel err {err / scale} > {tol}")
    say("gen", time.perf_counter() - t0,
        f"kernel vs plain DCN: rel err {errs} (tol {GEN_TOL}, pred_location {GEN_LOC_TOL})")

    t0 = time.perf_counter()
    fields = {k: v.cpu().numpy() for k, v in out.items()}
    mask = fields["mask"].astype(bool)
    objs = np.nonzero(mask)[0]
    written = {"kpts_2d": normalize_batch_kpts(fields["kpts_2d_img"][mask], objs // M,
                                               [sm.calib.P for sm in samples]),
               "kpts_3d": fields["kpts_3d"][mask], "pred_rot": fields["pred_rot"][mask][:, None],
               "gt_location": fields["gt_location"][mask]}
    cfg0 = dataclasses.replace(cfg, test=dataclasses.replace(cfg.test, detections_threshold=0.0))
    with tempfile.TemporaryDirectory() as tmp:
        writer = GenDataTrainWriter()
        writer.add_batch(written["kpts_2d"], written["kpts_3d"], written["pred_rot"],
                         written["gt_location"], fields["pred_location"][mask],
                         [samples[k // M].img_id for k in objs])
        writer.dump(os.path.join(tmp, "gen_data_train.json"))
        back = load_gen_data_train(os.path.join(tmp, "gen_data_train.json"), n_kpts)
        differ = [k for k, v in written.items() if not np.array_equal(back[k], v.astype(np.float32))]
        if differ:
            raise AssertionError(f"train JSON round trip: {differ} differ from what was written")
        # the infer-side pass of tools/train_dgde.py:362-399, at threshold 0
        # (the seeded weights score below the shipped one)
        rows = infer(model, torch.from_numpy(np.asarray(batch["images"])),
                     torch.from_numpy(batch["edge_indices"]).long(),
                     torch.from_numpy(batch["edge_len"]).long(),
                     *(torch.from_numpy(np.asarray(batch[k], np.float32))
                       for k in ("calib_P_full", "pad_size", "image_size")), cfg=cfg0)
        rows = {k: v.cpu().numpy() for k, v in rows.items()}
        iw = GenDataInferWriter()
        for b, sm in enumerate(samples):
            iw.add_image(sm.img_id, rows["dets"][b], rows["valid"][b],
                         normalize_kpts_2d(rows["kpts_2d"][b], sm.calib.P), rows["kpts_3d"][b])
        iw.dump(os.path.join(tmp, "gen_data_infer.json"))
        arrays, img_idx = load_gen_data_infer(os.path.join(tmp, "gen_data_infer.json"), n_kpts)
    n_valid = int(rows["valid"].sum())
    if len(img_idx) != n_valid or not all(np.isfinite(v).all() for v in arrays.values()):
        raise AssertionError(f"infer JSON: {len(img_idx)} objects read back of {n_valid} valid rows")
    say("gen", time.perf_counter() - t0,
        f"train JSON of {len(objs)} objects read back equal; infer pass at detection threshold 0 "
        f"(the seeded weights score below {cfg.test.detections_threshold}): {n_valid} objects "
        f"written and read back for the GMW phase")

    t0 = time.perf_counter()
    timing = {}
    big = collate(scenes(cfg, cfg.solver.ims_per_batch))
    for n, bt in ((BATCH, batch), (cfg.solver.ims_per_batch, big)):
        timing[n] = median_ms(lambda: gen_step(bt))
    prof = device_breakdown(lambda: gen_step(big))
    kinds = ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(prof["by_kind"].items()))
    say("gen", time.perf_counter() - t0,
        "gen step " + ", ".join(f"batch {n}: median {t[0]:.2f} ms" for n, t in timing.items())
        + f"; profiled at batch {cfg.solver.ims_per_batch}: wall {prof['wall_ms']:.2f} ms, device "
        f"{prof['device_ms']:.2f} ms (busy {100 * prof['busy_share']:.1f}%): {kinds}")
    return (dict(launches=launches, objects=n_obj, kernel_vs_plain_rel_err=errs,
                 train_json_objects=len(objs), infer_objects=n_valid,
                 step_ms={n: t[0] for n, t in timing.items()},
                 step_ms_all={n: t[1] for n, t in timing.items()}, profile=prof),
            dict(arrays=arrays, img_idx=img_idx))


def gmw_batches(data, batch_size):
    """Consecutive batches of a loaded train file, as tools/train_gmw.py
    builds them."""
    return [{"kpts_2d": data["kpts_2d"][i:i + batch_size], "kpts_3d": data["kpts_3d"][i:i + batch_size],
             "pred_rot": data["pred_rot"][i:i + batch_size, 0],
             "gt_depth": data["gt_location"][i:i + batch_size, 2]}
            for i in range(0, data["kpts_2d"].shape[0] - batch_size + 1, batch_size)]


def span_breakdown(fn):
    """Device ms of one call of ``fn`` by the port's profiler spans
    (GMW_SPANS): a kernel counts for the innermost span around the op that
    launched it or, in the backward, for the span of the forward op that
    its autograd node differentiates (matched by sequence number), else for
    "rest"; and the device's busy share of the call's wall time."""
    events, wall_ms = profile_call(fn)
    events = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]

    def span(e):
        while e is not None:
            if e.name in GMW_SPANS:
                return e.name
            e = e.cpu_parent
        return None

    forward = {}
    for e in events:
        name = span(e)
        if name and e.sequence_nr >= 0 and not e.name.startswith("autograd::"):
            forward.setdefault(e.sequence_nr, name)

    def category(e):
        name = span(e)
        while name is None and e is not None:
            if e.name.startswith("autograd::engine::evaluate_function") and e.sequence_nr in forward:
                name = forward[e.sequence_nr] + " backward"
            e = e.cpu_parent
        return name or "rest"

    split = {}
    for e in events:
        ms = sum(k.duration for k in e.kernels) / 1e3
        if ms:
            key = category(e)
            split[key] = split.get(key, 0.0) + ms
    device_ms = sum(split.values())
    return dict(wall_ms=wall_ms, device_ms=device_ms, busy_share=device_ms / wall_ms, by_span=split)


def check_gmw_gradients(model, step):
    """Every parameter has a finite gradient and each tower a non-zero one."""
    bad = [n for n, p in model.named_parameters() if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    dead = [t for t in ("FeatureExtractor4d", "FeatureExtractor6d")
            if not any(bool(p.grad.any()) for n, p in model.named_parameters() if n.startswith(t))]
    if bad or dead:
        raise AssertionError(f"GMW step {step}: parameters without a finite gradient {bad[:5]}, "
                             f"towers with an all-zero gradient {dead}")


def phase_gmw(gen_ctx):
    """The GMW at the shipped config on the committed train file: 3 steps,
    repeatable, card against CPU, the NaN step, times and the device split;
    then predict and rescale on the objects the gen phase wrote."""
    t0 = time.perf_counter()
    cfg = GMWConfig()
    batches = gmw_batches(load_gen_data_train(GMW_TRAIN_JSON, cfg.num_kpts), cfg.batch_size)
    cls_w, reg_w = loss_weights_for_epoch(cfg, 1)

    def run(seed=0):
        model, state = create_gmw_state(cfg, seed=seed, steps_per_epoch=len(batches), device="cuda")
        step = make_gmw_train_step(cfg, model)
        out = []
        for i in range(GMW_STEPS):
            logs = {k: float(v) for k, v in step(state, batches[i], cls_w, reg_w).items()}
            if not all(np.isfinite(v) for v in logs.values()):
                raise AssertionError(f"GMW step {i}: non-finite losses {logs}")
            check_gmw_gradients(model, i)
            out.append(dict(logs=logs, sinkhorn_iterations=int(model.sinkhorn_iterations)))
        return model, state, step, out

    model, state, step, steps = run()
    say("gmw", time.perf_counter() - t0,
        f"{GMW_STEPS} steps at batch {cfg.batch_size} ({cfg.num_kpts} keypoints, "
        f"{cfg.num_kpts * (cfg.num_kpts - 1) // 2} edges, depth {cfg.depth}, loss weights "
        f"{cls_w}/{reg_w}): loss " + ", ".join(f"{st['logs']['loss']:.6g}" for st in steps)
        + "; Sinkhorn iterations " + ", ".join(str(st["sinkhorn_iterations"]) for st in steps))

    t0 = time.perf_counter()
    twin, _, _, twin_steps = run()
    if [st["logs"] for st in twin_steps] != [st["logs"] for st in steps]:
        raise AssertionError(f"two GMW runs from one seed: {steps} vs {twin_steps}")
    differ = [k for k, v in model.state_dict().items() if not torch.equal(v, twin.state_dict()[k])]
    if differ:
        raise AssertionError(f"two GMW runs from one seed differ in {differ[:5]}")
    del twin
    say("gmw", time.perf_counter() - t0,
        f"a second state from seed 0: {GMW_STEPS} steps give bitwise equal losses and parameters")

    # the card against the port on this machine's CPU, one step at batch 2
    t0 = time.perf_counter()
    small = dataclasses.replace(cfg, batch_size=BATCH)
    b2 = gmw_batches(load_gen_data_train(GMW_TRAIN_JSON, cfg.num_kpts), BATCH)[0]
    pair = {}
    for dev in ("cuda", "cpu"):
        mdl, st = create_gmw_state(small, seed=1, device=dev)
        with torch.no_grad():
            _, P = mdl(*(torch.from_numpy(b2[k]).to(st.device) for k in ("kpts_2d", "kpts_3d")))
        logs = {k: float(v) for k, v in make_gmw_train_step(small, mdl)(st, b2, cls_w, reg_w).items()}
        grads = torch.cat([p.grad.flatten().cpu() for p in mdl.parameters()])
        pair[dev] = (P.cpu(), logs, grads)
        del mdl, st, P
    (Pg, lg, gg), (Pc, lc, gc) = pair["cuda"], pair["cpu"]
    p_err, p_scale = _rel_err(Pg, Pc)
    loss_err = max(abs(lg[k] - lc[k]) / abs(lc[k]) for k in lc)
    grad_fro = float((gg - gc).norm() / gc.norm())
    if not (p_err <= GMW_TOL * p_scale and loss_err <= GMW_TOL and grad_fro <= GMW_GRAD_FRO):
        raise AssertionError(f"GMW card vs CPU: P {p_err / p_scale}, losses {loss_err}, gradients "
                             f"{grad_fro} (limits {GMW_TOL}, {GMW_TOL}, {GMW_GRAD_FRO})")
    card_vs_cpu = dict(P_rel_err=p_err / p_scale, loss_rel_err=loss_err, grad_rel_fro=grad_fro)
    say("gmw", time.perf_counter() - t0,
        f"card vs CPU, one step at batch {BATCH}: P {p_err / p_scale:.3g} of scale, losses "
        f"{loss_err:.3g} relative (tol {GMW_TOL}), gradients {grad_fro:.3g} relative Frobenius "
        f"(tol {GMW_GRAD_FRO})")

    # the NaN step moves the parameters as AdamW on zero gradients moves them
    t0 = time.perf_counter()
    before = copy.deepcopy(model)
    opt = torch.optim.AdamW(before.parameters(), betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay)
    opt.load_state_dict(copy.deepcopy(state.optimizer.state_dict()))
    for group in opt.param_groups:
        group["lr"] = state.schedule(state.step)
    nan_batch = {k: v.copy() for k, v in batches[GMW_STEPS].items()}
    nan_batch["kpts_2d"][1, 5, 1] = np.nan
    nan_logs = {k: float(v) for k, v in step(state, nan_batch, cls_w, reg_w).items()}
    for p in before.parameters():
        p.grad = torch.zeros_like(p)
    opt.step()
    differ = [k for k, v in before.state_dict().items() if not torch.equal(v, model.state_dict()[k])]
    if not np.isnan(nan_logs["loss"]) or differ:
        raise AssertionError(f"NaN step: loss {nan_logs['loss']}, parameters other than the "
                             f"zero-gradient AdamW step's: {differ[:5]}")
    nan_iterations = int(model.sinkhorn_iterations)
    del before, opt
    say("gmw", time.perf_counter() - t0,
        f"NaN step: loss NaN, Sinkhorn iterations {nan_iterations}, parameters bitwise those of "
        "AdamW on zero gradients")

    t0 = time.perf_counter()
    step_ms, step_all = median_ms(lambda: step(state, batches[0], cls_w, reg_w))
    torch.cuda.reset_peak_memory_stats()
    prof = span_breakdown(lambda: step(state, batches[0], cls_w, reg_w))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    spans = ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(prof["by_span"].items()))
    say("gmw", time.perf_counter() - t0,
        f"train step at batch {cfg.batch_size}: median {step_ms:.2f} ms; profiled step: wall "
        f"{prof['wall_ms']:.2f} ms, device {prof['device_ms']:.2f} ms (busy "
        f"{100 * prof['busy_share']:.1f}%, peak {peak_gb:.2f} GB): {spans}")

    t0 = time.perf_counter()
    arrays = gen_ctx["arrays"]
    n_obj = arrays["kpts_2d"].shape[0]
    predict = make_gmw_predict(cfg, model)
    depths = []
    for i in range(0, n_obj, cfg.batch_size):
        sl = slice(i, i + cfg.batch_size)
        depths.append(predict({"kpts_2d": arrays["kpts_2d"][sl], "kpts_3d": arrays["kpts_3d"][sl],
                               "pred_rot": arrays["pred_rot"][sl, 0]}).cpu().numpy())
    depths = np.concatenate(depths)
    locs = rescale_location(arrays["pred_location"], depths, arrays["dim"])
    if depths.shape != (n_obj,) or not (np.isfinite(depths).all() and np.isfinite(locs).all()):
        raise AssertionError(f"predict: {depths.shape} depths of {n_obj} objects, finite "
                             f"{np.isfinite(depths).all()}, locations finite {np.isfinite(locs).all()}")
    first = {"kpts_2d": arrays["kpts_2d"][:cfg.batch_size], "kpts_3d": arrays["kpts_3d"][:cfg.batch_size],
             "pred_rot": arrays["pred_rot"][:cfg.batch_size, 0]}
    predict_ms, predict_all = median_ms(lambda: predict(first))
    say("gmw", time.perf_counter() - t0,
        f"predict + rescale on the gen phase's {n_obj} objects: depths and locations finite "
        f"(depth {depths.min():.2f}..{depths.max():.2f} m); predict at batch {cfg.batch_size}: "
        f"median {predict_ms:.2f} ms")
    return dict(steps=steps, card_vs_cpu=card_vs_cpu, nan_step=dict(logs=nan_logs,
                sinkhorn_iterations=nan_iterations), step_ms=step_ms, step_ms_all=step_all,
                profile=prof, peak_memory_gb=peak_gb, predict_objects=n_obj, predict_ms=predict_ms,
                predict_ms_all=predict_all)


# the cli phase's tree: 8 train scenes and 16 val scenes of 6 cars at
# 1242x375, under build/. The R40 protocol gives a perfect detector AP 100
# only where at least 41 ground truths are valid at a difficulty; 8 of these
# scenes hold 21 easy cars, 16 hold 43.
CLI_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_cli"
CLI_TRAIN_SEEDS, CLI_VAL_SEEDS = tuple(range(8)), tuple(range(8, 24))
CLI_ITERS, CLI_RESUME_AT = 4, 2
FINETUNE_ITERS, FROZEN, N_VIS = 2, "backbone", 2
# detections per val image in the gmw_cli phase's infer file (16 images)
GMW_DETECTIONS = 4


def k1_batch1():
    """K1 at the 7 DCN shapes at batch 1, the eval's launch shape: fp32
    against the plain version (<= FP32_TOL of scale), and its time through
    the wrapper beside the plain version's and the bound."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for cin, cout, h, w, count in DCN_SHAPES:
        a = dcn_inputs(cin, cout, h, w, gen, batch=1)
        err, scale = check_kernel(dcn_cuda.deform_conv2d(*a, RADIUS), deform_conv2d_clamped(*a, RADIUS),
                                  FP32_TOL, f"fp32 batch 1 {cin}->{cout}@{h}x{w}")
        plain = lambda: deform_conv2d_clamped(*a, RADIUS)
        kernel = lambda: dcn_cuda.deform_conv2d(*a, RADIUS)
        times = timed_turns([("plain", plain), ("kernel", kernel), ("kernel", kernel), ("plain", plain)], 10)
        b_ms, b_by = bound_ms(cin, cout, h, w, 1)
        rows.append(dict(cin=cin, cout=cout, h=h, w=w, count=count, max_abs_err=err, scale=scale,
                         ms=times["kernel"], plain_ms=times["plain"], bound_ms=b_ms, bound_by=b_by))
    return rows


def checkpoint_differences(a, b):
    """Where two checkpoints of the port differ: parameters and BN buffers,
    AdamW state, update count."""
    differ = [k for k in b["model"] if not torch.equal(a["model"][k], b["model"][k])]
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    if a["step"] != b["step"] or sa.keys() != sb.keys():
        differ.append(f"step {a['step']} vs {b['step']} / AdamW entries")
    differ += [f"AdamW {i}.{k}" for i in sb for k in sb[i]
               if i in sa and not torch.equal(sa[i][k], sb[i][k])]
    return differ


def near_perfect(gt, rng):
    """Detections equal to the labels, score 1, locations moved by up to
    1 mm: bit-identical rotated boxes hit the reference IoU kernel's
    strict-test quirk (BEV and 3D overlap 0), as tests/test_eval.py notes.
    (Its 0.1 mm still hit the quirk in one of six draws on this tree.)"""
    dt = {k: v.copy() for k, v in gt.items()}
    dt["location"] = dt["location"] + rng.uniform(-1e-3, 1e-3, dt["location"].shape)
    dt["score"] = np.ones(len(dt["name"]))
    return dt


def ap_seconds(fn, turns=2):
    """Each matcher's result and its median host seconds over ``turns`` turns
    of native, Python loop."""
    out, secs = {}, {True: [], False: []}
    for _ in range(turns):
        for use_native in (True, False):
            t1 = time.perf_counter()
            out[use_native] = fn(use_native)
            secs[use_native].append(time.perf_counter() - t1)
    (s_n, d_n), (s_p, d_p) = out[True], out[False]
    if s_n != s_p or d_n.keys() != d_p.keys() or any(float(d_n[k]) != float(d_p[k]) for k in d_p):
        raise AssertionError("the native matcher and the Python loop give other AP")
    return {k: float(v) for k, v in d_n.items()}, {("native" if k else "python"): statistics.median(v)
                                                   for k, v in secs.items()}


def cli_finetune(run, per_iter):
    """``--finetune`` of the phase's ``model_final`` for FINETUNE_ITERS
    iterations with the backbone frozen through a YAML: the backbone's
    parameters bitwise those of the file; every live parameter with a
    gradient, and every backbone BN's running statistics, moved; the update
    count restarted; K1, K2 and K3 16 times per iteration (the frozen
    gradients are computed, as in the JAX package)."""
    t0 = time.perf_counter()
    (CLI_DIR / "finetune.yaml").write_text("MODEL:\n  FREEZE_NAMES: [backbone]\n")
    source = CLI_DIR / "resumed" / "ckpt" / "model_final.pt"
    first = len(per_iter)
    dcn_cuda.reset_launch_counts()
    out = run("finetune", "--config", str(CLI_DIR / "finetune.yaml"), "--num_iters",
              str(FINETUNE_ITERS), "--finetune", str(source))
    launches = dict(zip(("dcn_fwd", "dcn_bwd_pom", "dcn_bwd_x"),
                        (fwd_launches(), *bwd_launches())))
    if per_iter[first:] != [[16, 16, 16]] * FINETUNE_ITERS or \
            set(launches.values()) != {16 * FINETUNE_ITERS}:
        raise AssertionError(f"--finetune launches per iteration {per_iter[first:]}, in all {launches}")
    load = lambda path: torch.load(path, map_location="cpu", weights_only=True)
    src, got = load(source), load(CLI_DIR / "finetune" / "ckpt" / "model_final.pt")
    params = dict(out["trainer"].model.named_parameters())
    frozen = [k for k in params if k.startswith("backbone.")]
    live = [k for k in params if not k.startswith("backbone.")]
    changed = lambda k: not torch.equal(got["model"][k], src["model"][k])
    bn = [k for k in got["model"] if k.startswith("backbone.") and k.endswith(("running_mean", "running_var"))]
    faults = dict(frozen_moved=[k for k in frozen if changed(k)],
                  live_with_gradient_idle=[k for k in live if not changed(k) and bool(params[k].grad.any())],
                  bn_idle=[k for k in bn if not changed(k)],
                  steps=(src["step"], got["step"]), adamw_entries=len(got["optimizer"]["state"]))
    bad = [(it["iteration"], k) for it in out["iterations"] for k, v in it["logs"].items() if not np.isfinite(v)]
    if faults["frozen_moved"] or faults["live_with_gradient_idle"] or faults["bn_idle"] or bad or \
            faults["steps"] != (CLI_ITERS, FINETUNE_ITERS) or faults["adamw_entries"] != len(live):
        raise AssertionError(f"--finetune: {faults}, non-finite logs {bad}")
    n_moved = sum(changed(k) for k in live)
    step_ms = [1e3 * (it["time"] - it["data"]) for it in out["iterations"]]
    say("cli", time.perf_counter() - t0,
        f"--finetune {source.name} with {FROZEN} frozen through a YAML, {FINETUNE_ITERS} iterations: "
        f"launches per iteration {per_iter[-1]} (dcn_fwd, dcn_bwd_pom, dcn_bwd_x); the {len(frozen)} "
        f"frozen parameters bitwise the file's, {n_moved} of {len(live)} live ones moved (the rest "
        f"without a gradient), all {len(bn)} backbone BN statistics moved, update count {src['step']} "
        f"-> {got['step']}; step ms {', '.join(f'{m:.2f}' for m in step_ms)}")
    return dict(launches=launches, launches_per_iteration=per_iter[first:], frozen=len(frozen),
                live=len(live), live_moved=n_moved, bn_moved=len(bn), step_ms=step_ms,
                total_loss=[it["logs"]["total_loss"] for it in out["iterations"]])


def cli_bf16(run, per_iter):
    """The command line training in bf16 through a YAML (``MODEL: {FP16:
    true}``), FINETUNE_ITERS iterations from scratch: 16 launches per
    iteration of each bf16 entry point and none of the fp32 ones, a bf16
    model, finite losses."""
    t0 = time.perf_counter()
    (CLI_DIR / "bf16.yaml").write_text("MODEL:\n  FP16: true\n")
    first = len(per_iter)
    dcn_cuda.reset_launch_counts()
    out = run("bf16", "--config", str(CLI_DIR / "bf16.yaml"), "--num_iters", str(FINETUNE_ITERS))
    launches = launches_by_entry_point()
    want = {k: (16 * FINETUNE_ITERS if k.endswith("bf16") else 0) for k in launches}
    bad = [(it["iteration"], k) for it in out["iterations"] for k, v in it["logs"].items() if not np.isfinite(v)]
    if per_iter[first:] != [[16, 16, 16]] * FINETUNE_ITERS or launches != want or bad or \
            out["trainer"].model.dtype != torch.bfloat16:
        raise AssertionError(f"bf16 command line: launches {launches}, per iteration "
                             f"{per_iter[first:]}, non-finite logs {bad}")
    step_ms = [1e3 * (it["time"] - it["data"]) for it in out["iterations"]]
    losses = [it["logs"]["total_loss"] for it in out["iterations"]]
    say("cli", time.perf_counter() - t0,
        f"training in bf16 through a YAML (FP16: true), {FINETUNE_ITERS} iterations: launches {launches}; "
        f"total_loss {', '.join(f'{v:.4f}' for v in losses)}; step ms {', '.join(f'{m:.2f}' for m in step_ms)}")
    return dict(launches=launches, step_ms=step_ms, total_loss=losses)


def cli_vis(ev, launches, val_ids):
    """The panels of ``--eval --resume --vis N_VIS`` (the phase's eval run):
    one per image for the first N_VIS val images, the frame beside its
    square bird's-eye panel."""
    from PIL import Image

    t0 = time.perf_counter()
    w, h = KITTI_IMAGE_SIZE
    sizes = [Image.open(p).size for p in ev["vis"]]
    names = [os.path.basename(p) for p in ev["vis"]]
    if names != [f"{i}.png" for i in val_ids[:N_VIS]] or sizes != [(w + h, h)] * N_VIS or \
            launches != {"dcn_fwd_f32": 16 * (len(val_ids) + 1), "dcn_fwd_bf16": 0}:
        raise AssertionError(f"--vis {N_VIS} wrote {names} of sizes {sizes}; launches {launches}")
    say("cli", time.perf_counter() - t0,
        f"--eval --resume --vis {N_VIS}: {names} at {sizes[0][0]}x{sizes[0][1]} (frame and bird's-eye "
        f"panel), drawn outside the eval's timer")
    return dict(files=names, size=sizes[0], launches=launches, images_per_s=ev["images_per_s"])


def cli_demo():
    """``python -m dcd_tpu_torch.tools.demo --synthetic 3`` on the phase's
    checkpoint directory: 16 ``dcn_fwd_f32`` launches, finite rows, both
    PNGs at their sizes."""
    from PIL import Image

    t0 = time.perf_counter()
    dcn_cuda.reset_launch_counts()
    out = demo.run(demo.parse_args(["--synthetic", "3", "--ckpt", str(CLI_DIR / "resumed" / "ckpt"),
                                    "--out", str(CLI_DIR / "demo.png"),
                                    "--bev", str(CLI_DIR / "demo_bev.png")]))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(dcn_cuda.deform_conv2d.launches_by_kernel)
    sizes = [Image.open(p).size for p in out["written"]]
    if launches != {"dcn_fwd_f32": 16, "dcn_fwd_bf16": 0} or not np.isfinite(out["dets"]).all() or \
            sizes != [KITTI_IMAGE_SIZE, (640, 640)]:
        raise AssertionError(f"demo: launches {launches}, PNG sizes {sizes}")
    say("cli", seconds,
        f"demo --synthetic 3 --ckpt resumed/ckpt: {launches['dcn_fwd_f32']} dcn_fwd_f32 launches, "
        f"{int(out['valid'].sum())} rows over the {dgde_run_config().test.detections_threshold} "
        f"threshold, demo.png {sizes[0]} and demo_bev.png {sizes[1]} written")
    return dict(launches=launches, seconds=seconds, rows=int(out["valid"].sum()))


def cli_gen_for_gmw(run, n_batches, n_val):
    """``--generate_for_GMW --resume`` again, for the ``gmw_cli`` phase, with
    the detection threshold at 0, the score without the depth confidence
    and GMW_DETECTIONS rows per image through a YAML: the seeded weights
    score under the shipped 0.2, and the infer file needs detections."""
    t0 = time.perf_counter()
    work = CLI_DIR / "gmw"
    work.mkdir()
    (work / "gen.yaml").write_text(
        "TEST:\n  DETECTIONS_THRESHOLD: 0.0\n  UNCERTAINTY_AS_CONFIDENCE: false\n"
        f"  DETECTIONS_PER_IMG: {GMW_DETECTIONS}\n")
    here = os.getcwd()
    os.chdir(work)  # gen_data/ goes under the working directory
    try:
        dcn_cuda.reset_launch_counts()
        gen = run("resumed", "--config", str(work / "gen.yaml"), "--generate_for_GMW", "--resume")
        launches = dcn_cuda.deform_conv2d.launches_by_kernel["dcn_fwd_f32"]
    finally:
        os.chdir(here)
    arrays, img_idx = load_gen_data_infer(gen["infer_json"])
    if len(img_idx) != GMW_DETECTIONS * n_val or launches != 16 * (n_batches + n_val) or \
            not all(np.isfinite(v).all() for v in arrays.values()):
        raise AssertionError(f"gen for the GMW command line: {len(img_idx)} objects, {launches} launches")
    say("cli", time.perf_counter() - t0,
        f"--generate_for_GMW --resume with threshold 0, no depth confidence and {GMW_DETECTIONS} rows "
        f"per image (a YAML; the seeded weights score under 0.2): {len(img_idx)} objects in "
        f"gmw/gen_data/gen_data_infer.json, {launches} dcn_fwd_f32 launches")
    return dict(train=gen["train_json"], infer=gen["infer_json"], infer_objects=len(img_idx),
                launches=launches)


def write_cli_tree():
    """Phase 10's KITTI tree under build/, a fresh directory (host work: it
    runs beside ``nvcc``); returns its training root."""
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    CLI_DIR.mkdir(parents=True)
    return write_kitti_tree(str(CLI_DIR / "kitti"), train_seeds=CLI_TRAIN_SEEDS,
                            val_seeds=CLI_VAL_SEEDS, num_objs=6)


def phase_cli(root):
    """The command line, ``python -m dcd_tpu_torch.tools.train_dgde``, run
    in-process on the KITTI tree ``root`` of :func:`write_cli_tree`: training
    with checkpoints and a bitwise resume, ``--eval`` with the KITTI AP
    protocol, the ground truth fed back as detections, ``--generate_for_GMW``."""
    t0 = time.perf_counter()
    val_ids = [f"{s:06d}" for s in CLI_VAL_SEEDS]
    gt = [get_label_anno(os.path.join(root, "label_2", f"{i}.txt")) for i in val_ids]
    n_val_cars = sum(len(a["name"]) for a in gt)
    say("cli", time.perf_counter() - t0,
        f"KITTI tree of {len(CLI_TRAIN_SEEDS)} train and {len(val_ids)} val scenes at "
        f"{KITTI_IMAGE_SIZE[0]}x{KITTI_IMAGE_SIZE[1]} ({n_val_cars} val cars), written under build/ "
        f"during the build")

    t0 = time.perf_counter()
    k1 = k1_batch1()
    k1_ms = sum(r["ms"] * r["count"] for r in k1)
    say("cli", time.perf_counter() - t0,
        f"K1 fp32 at batch 1, the 7 shapes: max err {max(r['max_abs_err'] / r['scale'] for r in k1):.3g} "
        f"of scale (tol {FP32_TOL}); per forward {k1_ms:.4f} ms (plain "
        f"{sum(r['plain_ms'] * r['count'] for r in k1):.4f}, bound "
        f"{sum(r['bound_ms'] * r['count'] for r in k1):.4f})")

    def run(output, *flags):
        return train_dgde.run(train_dgde.parse_args(
            ["--data_root", root, "--output", str(CLI_DIR / output), "--batch_size", str(BATCH),
             *flags]))

    per_iter = []

    def counted_step(trainer, batch):
        before = [fwd_launches(), *bwd_launches()]
        logs = train_step(trainer, batch)
        torch.cuda.synchronize()
        after = [fwd_launches(), *bwd_launches()]
        per_iter.append([x - y for x, y in zip(after, before)])
        return logs

    here = os.getcwd()
    os.chdir(CLI_DIR)  # --generate_for_GMW writes gen_data/ under the working directory
    train_dgde.train_step = counted_step
    try:
        t0 = time.perf_counter()
        dcn_cuda.reset_launch_counts()
        its = run("straight", "--num_iters", str(CLI_ITERS))["iterations"]
        launches = dict(zip(("dcn_fwd", "dcn_bwd_pom", "dcn_bwd_x"),
                            (fwd_launches(), *bwd_launches())))
        if per_iter != [[16, 16, 16]] * CLI_ITERS:
            raise AssertionError(f"launches per iteration (dcn_fwd, dcn_bwd_pom, dcn_bwd_x) {per_iter}")
        bad = [(it["iteration"], k) for it in its for k, v in it["logs"].items() if not np.isfinite(v)]
        if len(its) != CLI_ITERS or bad:
            raise AssertionError(f"{len(its)} iterations, non-finite {bad}")
        data_ms = [1e3 * it["data"] for it in its]
        step_ms = [1e3 * (it["time"] - it["data"]) for it in its]
        say("cli", time.perf_counter() - t0,
            f"{CLI_ITERS} training iterations at batch {BATCH}: launches per iteration "
            f"{per_iter[-1]} (dcn_fwd, dcn_bwd_pom, dcn_bwd_x); total_loss "
            + ", ".join(f"{it['logs']['total_loss']:.4f}" for it in its)
            + f"; iterations 1-{CLI_ITERS - 1}: data median {statistics.median(data_ms[1:]):.2f} ms, "
            f"step median {statistics.median(step_ms[1:]):.2f} ms")

        t0 = time.perf_counter()
        run("resumed", "--num_iters", str(CLI_RESUME_AT))
        resumed = run("resumed", "--num_iters", str(CLI_ITERS), "--resume")["iterations"]
        if [it["iteration"] for it in resumed] != list(range(CLI_RESUME_AT, CLI_ITERS)) or \
                [it["logs"] for it in resumed] != [it["logs"] for it in its[CLI_RESUME_AT:]]:
            raise AssertionError("the resumed iterations differ from the straight run's")
        if per_iter != [[16, 16, 16]] * (2 * CLI_ITERS):
            raise AssertionError(f"launches per iteration of the resumed runs {per_iter[CLI_ITERS:]}")
        load = lambda out: torch.load(CLI_DIR / out / "ckpt" / "model_final.pt", map_location="cpu",
                                      weights_only=True)
        differ = checkpoint_differences(load("resumed"), load("straight"))
        if differ:
            raise AssertionError(f"{CLI_RESUME_AT} + resume + {CLI_ITERS - CLI_RESUME_AT} iterations "
                                 f"differ from {CLI_ITERS} straight in {differ[:5]}")
        say("cli", time.perf_counter() - t0,
            f"{CLI_RESUME_AT} iterations, model_final, --resume, {CLI_ITERS - CLI_RESUME_AT} more: "
            f"losses, parameters, BN buffers, AdamW state and step bitwise those of {CLI_ITERS} straight")

        t0 = time.perf_counter()
        dcn_cuda.reset_launch_counts()
        ev = run("resumed", "--eval", "--resume", "--vis", str(N_VIS))
        ev_ips = ev["images_per_s"]
        eval_launches = dict(dcn_cuda.deform_conv2d.launches_by_kernel)
        if eval_launches != {"dcn_fwd_f32": 16 * (len(val_ids) + 1), "dcn_fwd_bf16": 0}:
            raise AssertionError(f"--eval launched {eval_launches}, not dcn_fwd_f32 16 times for each "
                                 f"of {len(val_ids)} images and the warm-up")
        txts = sorted(os.listdir(ev["out_dir"]))
        with open(CLI_DIR / "resumed" / "inference" / "result.json") as f:
            result_json = json.load(f)
        if txts != [f"{i}.txt" for i in val_ids] or result_json != ev["ap"]:
            raise AssertionError(f"--eval wrote {txts} and a result.json that differs from its AP")
        n_rows = sum(1 for t in txts for line in open(os.path.join(ev["out_dir"], t)) if line.strip())
        say("cli", time.perf_counter() - t0,
            f"--eval --resume: {len(val_ids)} images one at a time, {ev['images_per_s']:.2f} images/s "
            f"(the warm-up call excluded), {eval_launches['dcn_fwd_f32']} dcn_fwd_f32 launches, "
            f"{n_rows} rows over the {ev['trainer'].cfg.test.detections_threshold} threshold, a txt "
            f"per val id and result.json")
        vis = cli_vis(ev, eval_launches, val_ids)

        t0 = time.perf_counter()
        model, cfg = ev["trainer"].model, ev["trainer"].cfg
        # every row valid: no threshold, and the score without the depth
        # confidence (which zeroes the seeded weights' scores)
        cfg0 = dataclasses.replace(cfg, test=dataclasses.replace(
            cfg.test, detections_threshold=0.0, uncertainty_as_confidence=False))
        ds = KITTIDataset(cfg, root, is_train=False, augment=False)
        errs, share, n_matched = {}, [], 0
        for i in range(2):
            s = ds.get_sample(i)
            t = s.targets
            args = (torch.from_numpy(s.image[None]).cuda(),
                    torch.from_numpy(t["edge_indices"][None]).long().cuda(),
                    torch.from_numpy(t["edge_len"][None]).long().cuda())
            post = [torch.from_numpy(np.asarray(t[k][None], np.float32)).cuda()
                    for k in ("calib_P_full", "pad_size", "image_size")]
            with torch.no_grad():
                k = model(*args, lazy_topk=True)
                set_dcn_impl(model, "dense")
                p = model(*args, lazy_topk=True)
                set_dcn_impl(model, "auto")
                rows_k, rows_p = postprocess(cfg0, k, *post), postprocess(cfg0, p, *post)
            if not torch.equal(k["points_xy"], p["points_xy"]):
                raise AssertionError(f"batch-1 forward of {s.img_id}: the kernel and the plain DCN "
                                     "chose other peaks")
            for key in ("cls", "scores", "reg_pois"):
                errs[key] = max(errs.get(key, 0.0),
                                float((k[key] - p[key]).abs().max()) / float(p[key].abs().max()))
            hit, total = rows_matched(rows_k, rows_p, PATH_TOL)
            share.append(hit)
            n_matched += total
        if max(errs.values()) > PATH_TOL or min(share) < 1.0 or not n_matched:
            raise AssertionError(f"batch-1 forward kernel vs plain: rel errs {errs}, rows matched {share}")
        say("cli", time.perf_counter() - t0,
            f"images 0-1 at batch 1, kernel vs plain DCN: same 50 peaks, rel err {errs}, all "
            f"{n_matched} rows (threshold 0, no depth confidence) within {PATH_TOL} of scale")

        t0 = time.perf_counter()
        native.library()  # the matcher's build, kept out of its time
        label_dir = os.path.join(root, "label_2")
        split = os.path.join(root, "ImageSets", "val.txt")
        eval_ap, eval_secs = ap_seconds(lambda nat: evaluate_from_files(
            label_dir, ev["out_dir"], split, current_class=["Car"], metric="R40", use_native=nat))
        if eval_ap != ev["ap"]:
            raise AssertionError("the AP of the eval's txt files differs from result.json")
        rng = np.random.RandomState(0)
        dt = [near_perfect(a, rng) for a in gt]
        gt_ap, gt_secs = ap_seconds(lambda nat: get_official_eval_result(
            gt, dt, ["Car"], metric="R40", use_native=nat))
        if set(gt_ap.values()) != {100.0}:
            raise AssertionError(f"the labels as detections give AP {gt_ap}, not 100")
        say("cli", time.perf_counter() - t0,
            f"AP host seconds, native matcher vs Python loop (equal AP): the eval's txt files "
            f"{eval_secs['native']:.4f} vs {eval_secs['python']:.4f}; the {n_val_cars} val labels fed "
            f"back as detections (score 1) {gt_secs['native']:.4f} vs {gt_secs['python']:.4f}, AP 100 "
            f"for Car at every difficulty in bbox, BEV and 3D (R40, both overlap rows)")
        del model, ev

        t0 = time.perf_counter()
        dcn_cuda.reset_launch_counts()
        gen = run("resumed", "--generate_for_GMW", "--resume")
        gen_launches = dcn_cuda.deform_conv2d.launches_by_kernel["dcn_fwd_f32"]
        train_ds = KITTIDataset(cfg, root, is_train=True, augment=False)
        n_batches = len(train_ds) // BATCH
        n_obj = sum(int(train_ds.get_sample(i).targets["reg_mask"].sum())
                    for i in range(n_batches * BATCH))
        n_kpts = cfg.model.head.num_kpts
        data = load_gen_data_train(gen["train_json"], n_kpts)
        arrays, img_idx = load_gen_data_infer(gen["infer_json"], n_kpts)
        with open(gen["infer_json"]) as f:
            infer_ids = sorted(json.load(f))
        if len(data["kpts_2d"]) != n_obj or not all(np.isfinite(v).all() for v in data.values()):
            raise AssertionError(f"gen_data_train.json: {len(data['kpts_2d'])} objects, {n_obj} in the "
                                 "train split")
        if infer_ids != val_ids or len(img_idx) != n_rows or gen_launches != 16 * (n_batches + len(val_ids)):
            raise AssertionError(f"gen_data_infer.json: images {infer_ids}, {len(img_idx)} objects of "
                                 f"{n_rows} eval rows; {gen_launches} launches")
        say("cli", time.perf_counter() - t0,
            f"--generate_for_GMW --resume: gen_data/gen_data_train.json with the {n_obj} objects of "
            f"the train split and gen_data/gen_data_infer.json with {len(val_ids)} images and the "
            f"eval's {len(img_idx)} rows, read back by the port's loaders; {gen_launches} dcn_fwd_f32 "
            f"launches")
        del gen
        finetune = cli_finetune(run, per_iter)
        bf16 = cli_bf16(run, per_iter)
        demo_run = cli_demo()
        gmw_inputs = cli_gen_for_gmw(run, n_batches, len(val_ids))
    finally:
        train_dgde.train_step = train_step
        os.chdir(here)
    torch.cuda.empty_cache()
    return dict(tree=dict(train=len(CLI_TRAIN_SEEDS), val=len(val_ids), val_cars=n_val_cars),
                k1_batch1=k1, k1_batch1_ms=k1_ms, launches=launches,
                launches_per_iteration=per_iter[:2 * CLI_ITERS],
                iterations=[dict(iteration=it["iteration"], data_ms=d, step_ms=st,
                                 total_loss=it["logs"]["total_loss"])
                            for it, d, st in zip(its, data_ms, step_ms)],
                data_ms_median=statistics.median(data_ms[1:]),
                step_ms_median=statistics.median(step_ms[1:]),
                eval_images=len(val_ids), eval_images_per_s=ev_ips, eval_launches=eval_launches,
                eval_rows=n_rows, batch1_kernel_vs_plain_rel_err=errs, ap_eval=eval_ap,
                ap_seconds_eval=eval_secs, ap_seconds_labels=gt_secs, ap_labels=gt_ap,
                gen_train_objects=n_obj, gen_infer_objects=len(img_idx), gen_launches=gen_launches,
                finetune=finetune, bf16=bf16, vis=vis, demo=demo_run, gmw_inputs=gmw_inputs)


# the gmw_cli phase: GMWConfig()'s scale through the command line's flags
GMW_CLI_EPOCHS, GMW_CLI_EVERY = 2, 1
# refined locations, card against the host's CPU, of the largest
# coordinate: phase 9 holds predict to the CPU at GMW_TOL
GMW_CLI_TOL = GMW_TOL


def phase_gmw_cli(inputs):
    """Stage 2's command line, ``python -m dcd_tpu_torch.tools.train_gmw``,
    in-process on the JSONs the cli phase wrote, at GMWConfig()'s scale
    (73 keypoints, 2628 edges, batch 8, top-1500) with ``--kitti_path`` on
    the cli phase's tree: GMW_CLI_EPOCHS epochs with validation and a
    checkpoint every GMW_CLI_EVERY; the same run again, bitwise equal;
    ``--evaluate --resume`` on the card (traced through
    ``utils/profiling.py``) and on the host's CPU from the same
    checkpoint, the refined locations within GMW_CLI_TOL of scale."""
    t0 = time.perf_counter()
    base = ["--train_data", inputs["train"], "--val_data", inputs["infer"],
            "--kitti_path", str(CLI_DIR / "kitti"), "--epochs", str(GMW_CLI_EPOCHS),
            "--val_every", str(GMW_CLI_EVERY), "--save_every", str(GMW_CLI_EVERY)]

    def run(log_dir, *flags):
        return train_gmw.run(train_gmw.parse_args([*base, "--log_dir", str(CLI_DIR / log_dir), *flags]))

    a = run("gmw_a")
    steps = [s for e in a["epochs"] for s in e["steps"]]
    n_train = len(load_gen_data_train(inputs["train"])["kpts_2d"])
    batch = GMWConfig().batch_size
    names = sorted(p.name for p in (CLI_DIR / "gmw_a" / "ckpt").glob("*.pt"))
    want = sorted([f"checkpoint_epoch_{e}.pt" for e in range(GMW_CLI_EVERY, GMW_CLI_EPOCHS + 1, GMW_CLI_EVERY)]
                  + ["checkpoint_final.pt", "model_best.pt"])
    validated = [e["epoch"] for e in a["epochs"] if "validation" in e]
    bad = [k for s in steps for k, v in s.items() if not np.isfinite(v)]
    if len(steps) != GMW_CLI_EPOCHS * (n_train // batch) or bad or names != want or \
            validated != list(range(GMW_CLI_EVERY, GMW_CLI_EPOCHS + 1, GMW_CLI_EVERY)) or \
            a["best_epoch"] is None or not np.isfinite(a["final"]["depths"]).all():
        raise AssertionError(f"train_gmw: {len(steps)} steps, non-finite {bad[:5]}, checkpoints {names}, "
                             f"validated at {validated}, best epoch {a['best_epoch']}")
    step_ms = [1e3 * s["seconds"] for s in steps]
    epoch_s = [e["seconds"] for e in a["epochs"]]
    predict_ms = [1e3 * t for e in a["epochs"] if "validation" in e
                  for t in e["validation"]["predict_seconds"]]
    ap = a["final"]["ap"][train_gmw.AP_KEY]
    last_losses = ", ".join(f"{e['steps'][-1]['loss']:.4f}" for e in a["epochs"])
    say("gmw_cli", time.perf_counter() - t0,
        f"train_gmw on {n_train} objects ({n_train // batch} steps/epoch at batch {batch}), "
        f"{GMW_CLI_EPOCHS} epochs: loss {last_losses} (each epoch's last step); "
        f"step median {statistics.median(step_ms[1:]):.2f} ms, epoch median "
        f"{statistics.median(epoch_s[1:]):.3f} s, predict median {statistics.median(predict_ms):.2f} ms "
        f"(batch {batch}, {len(a['final']['depths'])} objects); checkpoints {names}, best epoch "
        f"{a['best_epoch']}; Car AP3D|R40 moderate {ap:.4f}")

    t1 = time.perf_counter()
    b = run("gmw_b")
    load = lambda d, name: torch.load(CLI_DIR / d / "ckpt" / name, map_location="cpu", weights_only=True)
    same_ckpts = all(not checkpoint_differences(ca, cb) and ca["epoch"] == cb["epoch"]
                     for ca, cb in ((load("gmw_a", n), load("gmw_b", n)) for n in names))
    same_logs = [{k: v for k, v in s.items() if k != "seconds"} for s in steps] == \
        [{k: v for k, v in s.items() if k != "seconds"} for e in b["epochs"] for s in e["steps"]]
    if not (same_ckpts and same_logs):
        raise AssertionError(f"a second train_gmw run differs: checkpoints equal {same_ckpts}, "
                             f"losses equal {same_logs}")
    say("gmw_cli", time.perf_counter() - t1,
        f"the same run again: losses and the {len(names)} checkpoints (weights, AdamW state, update "
        f"count, epoch) bitwise equal")

    t1 = time.perf_counter()
    timer = StepTimer(warmup=0)
    with trace_session(str(CLI_DIR / "gmw_trace")) as prof:
        timer.start()
        card = run("gmw_a", "--evaluate", "--resume")
        timer.stop()
    device_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)) / 1e3
    trace_mb = (CLI_DIR / "gmw_trace" / TRACE_FILE).stat().st_size / 2 ** 20
    shutil.copytree(CLI_DIR / "gmw_a" / "ckpt", CLI_DIR / "gmw_cpu" / "ckpt")
    t2 = time.perf_counter()
    cpu = run("gmw_cpu", "--evaluate", "--resume", "--device", "cpu")
    cpu_s = time.perf_counter() - t2
    keys = [(img, det) for img in sorted(card["final"]["refined"]) for det in sorted(card["final"]["refined"][img])]
    got = np.array([card["final"]["refined"][i][d] for i, d in keys])
    ref = np.array([cpu["final"]["refined"][i][d] for i, d in keys])
    err = float(np.abs(got - ref).max()) / float(np.abs(ref).max())
    if card["final"]["refined"].keys() != cpu["final"]["refined"].keys() or err > GMW_CLI_TOL or \
            not device_ms or not np.isfinite(got).all():
        raise AssertionError(f"--evaluate card vs CPU: refined locations {err:.3g} of scale (tol "
                             f"{GMW_CLI_TOL}); device ms {device_ms}")
    say("gmw_cli", time.perf_counter() - t1,
        f"--evaluate --resume on the card {1e3 * timer.times[0]:.1f} ms ({device_ms:.2f} ms of kernels "
        f"in its trace_session, trace.json {trace_mb:.1f} MiB) and on the CPU {1e3 * cpu_s:.1f} ms: "
        f"the {len(keys)} refined locations within {err:.3g} of scale (tol {GMW_CLI_TOL}); AP "
        f"{card['final']['ap'][train_gmw.AP_KEY]:.4f} and {cpu['final']['ap'][train_gmw.AP_KEY]:.4f}")
    return dict(train_objects=n_train, infer_objects=len(keys), steps=len(steps), step_ms=step_ms,
                step_ms_median=statistics.median(step_ms[1:]), epoch_s=epoch_s,
                epoch_s_median=statistics.median(epoch_s[1:]), predict_ms=predict_ms,
                predict_ms_median=statistics.median(predict_ms), checkpoints=names,
                best_epoch=a["best_epoch"], metric_by_epoch={e["epoch"]: e["validation"]["metric"]
                                                             for e in a["epochs"] if "validation" in e},
                ap=a["final"]["ap"], repeat_bitwise=True, evaluate_card_ms=1e3 * timer.times[0],
                evaluate_card_device_ms=device_ms, evaluate_cpu_ms=1e3 * cpu_s,
                card_vs_cpu_rel_err=err, losses=[s["loss"] for s in steps])


BWD_KERNELS = ("bwd_pom_kernel", "bwd_weight_kernel", "bwd_x_kernel")


# phase 12: two gloo ranks on the one card against one process
DIST_WORLD = 2
DIST_CLI_ITERS = 3
DIST_TIMED_STEPS = 1
# a collective of phase 12 that waits longer fails the phase instead of the call
DIST_TIMEOUT = datetime.timedelta(seconds=120)
DIST_CLI_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_dist_cli"


def _tf32_off():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def dist_rank(rank, world, jobs, cli_runs, spawned_at):
    """A rank of phase 12, TF32 off as in this process: the ``jobs`` of
    ``parallel.workers.suite_worker`` in the gloo group it was spawned into,
    then, that group left, the command line's ``cli_runs``, each with its
    own rendezvous (``tools/multiprocess_smoke.cli_worker``). Returns the
    jobs' results, the command line's, and the rank's seconds: from the
    spawn to its first line, each job, the command line, and the wall clock
    at its return."""
    from dcd_tpu_torch.parallel import shutdown
    from dcd_tpu_torch.parallel.workers import digest, suite_worker
    from dcd_tpu_torch.tools.multiprocess_smoke import cli_worker

    seconds = dict(spawn=time.time() - spawned_at)
    _tf32_off()
    out = []
    for name, args in jobs:
        t0 = time.perf_counter()
        out += suite_worker(rank, world, [(name, args)])
        seconds[name] = time.perf_counter() - t0
    shutdown()
    t0 = time.perf_counter()
    cli = cli_worker(rank, world, cli_runs, False)
    seconds["cli"] = time.perf_counter() - t0
    if rank:  # rank 0 brings the arrays back; the others their digests
        for res in out:
            for key in {"grads", "first_state", "state"} & set(res):
                res[key] = digest(res[key])
    seconds["returned_at"] = time.time()
    return out, cli, seconds


def phase_dist(cli_root):
    """Data parallelism on the card: two processes over gloo on the one H100
    against one process (the DGDE step, the GMW step, the command line), and
    one rank over NCCL."""
    import torch.distributed as torch_dist

    from dcd_tpu_torch.parallel import initialize_distributed, launch, shutdown
    from dcd_tpu_torch.parallel.mesh import _claim_card
    from dcd_tpu_torch.parallel.workers import (dgde_step, dgde_step_agreement, digest,
                                                gmw_step, gradient_errors)
    from dcd_tpu_torch.tools import multiprocess_smoke

    torch.cuda.empty_cache()
    out = {}
    t0 = time.perf_counter()
    cfg = dgde_run_config()
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, ims_per_batch=BATCH))
    batch = {k: v for k, v in collate(scenes(cfg)).items() if k != "img_ids"}
    # the seeded weights with every BN in its linear range: at the seeded
    # weights train-mode BN grows a rounding difference (cuDNN's algorithms
    # at batch 1 against 2) through the network (PERF.md, Findings)
    model = build_detector(cfg, "cpu")
    linear_range_bn(model)
    weights = {k: v.numpy() for k, v in model.state_dict().items()
               if not k.endswith("num_batches_tracked")}
    del model
    gcfg = GMWConfig()
    gbatch = gmw_batches(load_gen_data_train(GMW_TRAIN_JSON, gcfg.num_kpts), gcfg.batch_size)[0]
    gweights = loss_weights_for_epoch(gcfg, 1)
    # (a), (c) and then (b) in one spawn of two ranks on the card
    shutil.rmtree(DIST_CLI_DIR, ignore_errors=True)
    DIST_CLI_DIR.mkdir(parents=True)
    cli_out = str(DIST_CLI_DIR / "logs")
    cli_runs = multiprocess_smoke.cli_runs(cli_root, None, cli_out, "cuda", "gloo",
                                           DIST_CLI_ITERS, ["--batch_size", str(BATCH)])
    jobs = [("dgde_step_worker", (cfg, batch, 1, 0, "cuda", True, 0, weights, True)),
            ("gmw_step_worker", (gcfg, gbatch, 1, 0, "cuda", gweights))]
    t1 = time.perf_counter()
    suites, clis, seconds = zip(*launch(dist_rank, DIST_WORLD, (jobs, cli_runs, time.time()),
                                        timeout=DIST_TIMEOUT, start_method="forkserver"))
    ranks, granks = zip(*suites)
    t2 = time.perf_counter()
    returned = time.time() - max(s["returned_at"] for s in seconds)
    one = dgde_step(cfg, batch, 1, 0, "cuda", timed=DIST_TIMED_STEPS, weights=weights)
    gone = gmw_step(gcfg, gbatch, 1, 0, "cuda", loss_weights=gweights)
    rank0 = seconds[0]
    say("dist", time.perf_counter() - t0,
        f"inputs {t1 - t0:.2f} s, the 2 ranks {t2 - t1:.2f} s (of it in rank 0: from the spawn to "
        f"its first line {rank0['spawn']:.2f} s, the DGDE step {rank0['dgde_step_worker']:.2f} s "
        f"({', '.join(f'{k} {v:.2f}' for k, v in ranks[0]['seconds'].items())}), the GMW step "
        f"{rank0['gmw_step_worker']:.2f} s, the command line {rank0['cli']:.2f} s; from the last "
        f"rank's return to the results here {returned:.2f} s), one process's steps "
        f"{time.perf_counter() - t2:.2f} s")

    agreement = [dgde_step_agreement(cfg, ranks[0], one)]
    want = {"dcn_fwd_f32": 16, "dcn_fwd_bf16": 0, "dcn_bwd_pom_f32": 16, "dcn_bwd_pom_bf16": 0,
            "dcn_bwd_x_f32": 16, "dcn_bwd_x_bf16": 0}
    bad = [f"rank {r}: {res['launches']}" for r, res in enumerate(ranks) if res["launches"] != want]
    bad += [f"rank 0 over its limits: {a}; worst gradients {gradient_errors(cfg, ranks[0], one)[-4:]}"
            for a in agreement if max(a.values()) > 1]
    bad += [f"rank {r} not bitwise repeatable" for r, res in enumerate(ranks) if not res["bitwise"]]
    bad += [f"rank {r}'s {key} differ from rank 0's" for r, res in enumerate(ranks[1:], 1)
            for key in ("grads", "first_state", "state") if res[key] != digest(ranks[0][key])]
    if not all(np.isfinite(v) for v in ranks[0]["logs"][0].values()):
        bad.append(f"non-finite logs {ranks[0]['logs'][0]}")
    if bad:
        raise AssertionError(f"the 2-rank DGDE step: {bad}")
    prof = ranks[0]["profile"]
    out["dgde_step"] = dict(
        agreement=agreement, launches_per_rank=ranks[0]["launches"],
        total_loss=[ranks[0]["logs"][0]["total_loss"], one["logs"][0]["total_loss"]],
        step_ms_2_ranks=prof["wall_ms"], step_ms_one_process=one["step_ms"],
        profile_rank0=prof)
    worst = {k: max(a[k] for a in agreement) for k in agreement[0]}
    say("dist", 0.0,
        f"(a) DGDE step at full width, fp32, BNs in their linear range, 2 gloo ranks at batch 1 "
        f"on the one card against one process at batch 2: each category over its limit "
        f"{json.dumps({k: float(f'{v:.3g}') for k, v in worst.items()})}; launches per rank "
        f"{ranks[0]['launches']}; bitwise repeatable, ranks' weights bitwise equal; the 2-rank "
        f"step under the host's profiler {prof['wall_ms']:.2f} ms (one process at batch 2 "
        f"{statistics.median(one['step_ms']):.2f} ms), "
        f"{prof['all_reduce_sum_calls']} BN and loss all-reduces {prof['all_reduce_sum_ms']:.2f} ms "
        f"on the host; all "
        f"{prof['grad_all_reduce_mb']:.1f} MB of gradients all-reduced once "
        f"{prof['grad_all_reduce_ms']:.2f} ms")

    loss_err = max(abs(r["logs"][0][k] - v) / abs(v) for r in granks
                   for k, v in gone["logs"][0].items())
    a = np.concatenate([v.ravel() for v in granks[0]["grads"].values()]).astype(np.float64)
    b = np.concatenate([gone["grads"][k].ravel() for k in granks[0]["grads"]]).astype(np.float64)
    grad_fro = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    same = granks[1]["state"] == digest(granks[0]["state"])
    if loss_err > DIST_GMW_LOSS_TOL or grad_fro > GMW_GRAD_FRO or not same:
        raise AssertionError(f"the 2-rank GMW step: losses {loss_err} (tol {DIST_GMW_LOSS_TOL}), "
                             f"gradients {grad_fro} (tol {GMW_GRAD_FRO}), ranks equal {same}")
    out["gmw_step"] = dict(loss_rel=loss_err, grad_fro=grad_fro, loss=granks[0]["logs"][0]["loss"])
    say("dist", 0.0,
        f"(c) GMW step at GMWConfig() batch {gcfg.batch_size}, 2 gloo ranks against one process: "
        f"losses {loss_err:.3g} relative (tol {DIST_GMW_LOSS_TOL}), gradients {grad_fro:.3g} "
        f"(tol {GMW_GRAD_FRO}), ranks' weights bitwise equal")
    del ranks, one, granks, gone

    # (b) the command line over 2 processes on phase 10's tree
    cli = multiprocess_smoke.check_cli(clis, cli_root, cli_out, DIST_CLI_ITERS)
    out["cli"] = dict(checks=cli["checks"], losses=cli["losses"], eval_images=cli["images"],
                      ap_keys=len(cli["ap"]))
    say("dist", 0.0,
        f"(b) train_dgde --num_processes 2 --dist_backend gloo, {DIST_CLI_ITERS} iterations at "
        f"--batch_size {BATCH}: total_loss {', '.join(f'{x:.4f}' for x in cli['losses'][0])}; "
        f"--eval --resume sharded {cli['images']} images; " + ", ".join(k for k, v in cli["checks"].items() if v))

    # (d) this process as one rank over NCCL: a communicator made on the
    # card, one DDP step; a second rank claiming the card is refused
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=DIST_CLI_DIR) as tmp:
        group = initialize_distributed(f"file://{tmp}/rendezvous", 1, 0, backend="nccl",
                                       device=torch.device("cuda", 0))
        try:
            backend = torch_dist.get_backend(group)
            nccl = dgde_step(cfg, {k: v[:1] for k, v in batch.items()}, 1, 0, "cuda:0")
            store = torch_dist.HashStore()
            props = torch.cuda.get_device_properties(0)
            store.set("card/1", f"{socket.gethostname()}:{getattr(props, 'uuid', 0)}")
            try:
                _claim_card(store, 0, 2, torch.device("cuda", 0))
                refused = None
            except RuntimeError as e:
                refused = str(e)
        finally:
            shutdown()
    if backend != "nccl" or nccl["launches"] != want or \
            not all(np.isfinite(v) for v in nccl["logs"][0].values()):
        raise AssertionError(f"the NCCL step: {backend}, {nccl['launches']}, {nccl['logs'][0]}")
    if refused is None or "share card" not in refused:
        raise AssertionError(f"a second NCCL rank on the card was not refused: {refused}")
    out["nccl"] = dict(backend=backend, total_loss=nccl["logs"][0]["total_loss"], refused=refused)
    say("dist", time.perf_counter() - t0,
        f"(d) one rank over NCCL: a DDP step at batch 1, total_loss "
        f"{nccl['logs'][0]['total_loss']:.4f}, launches {nccl['launches']}; a second rank on the "
        f"card refused: {refused[:150]}")
    return out


def tensor_core_instructions():
    """HMMA/HGMMA instructions in the SASS of each instantiation of the
    forward kernel and of each backward kernel that multiplies (cuobjdump of
    the built library); raises unless every bf16 forward and every backward
    one has them."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(cuda_build.LIBRARY)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    counts = {}
    for section in sass.split("Function : ")[1:]:
        name = section.split("\n", 1)[0].strip()
        if "dcn_fwd_kernel" in name:
            m = re.search(r"dcn_fwd_kernelI(13__nv_bfloat16|f)Li(\d+)ELi(\d+)E", name)
            key = f"{'bf16' if m[1] != 'f' else 'fp32'} {m[2]}x{m[3]}" if m else name[:60]
        else:
            # the backward kernels are templates on the loaded type (and K3 on
            # the words of its hit masks)
            kernel = next((k for k in BWD_KERNELS if f"{len(k)}{k}I" in name), None)
            if kernel is None:
                continue
            m = re.search(rf"{len(kernel)}{kernel}I(13__nv_bfloat16|f)(?:Li(\d+)E)?E", name)
            key = (f"{kernel} {'fp32' if m[1] == 'f' else 'bf16'}" + (f" w{m[2]}" if m[2] else "")
                   if m else name[:60])
        counts[key] = len(re.findall(r"\bH(?:G)?MMA\b", section))
    bf16 = {k: v for k, v in counts.items() if k.startswith("bf16")}
    if not bf16 or not all(bf16.values()):
        raise AssertionError(f"a bf16 forward kernel has no HMMA/HGMMA in its SASS: {counts}")
    for kernel in BWD_KERNELS:
        inst = {k: v for k, v in counts.items() if k.startswith(kernel + " ")}
        # fp32 and bf16 (K3: with 1, 2 and 4 words of hits each)
        if len(inst) != (6 if kernel == "bwd_x_kernel" else 2) or not all(inst.values()):
            raise AssertionError(f"a backward kernel has no HMMA/HGMMA in its SASS: {counts}")
    return counts


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
    # phase 12's ranks are forked from a fork server that imports this script
    # and torch._dynamo (a process's first torch.optim optimizer imports it,
    # about 10 s on the card's machine) while the phases before it run
    forkserver = multiprocessing.get_context("forkserver")
    forkserver.set_forkserver_preload([Path(__file__).stem, "torch._dynamo"])
    multiprocessing.forkserver.ensure_running()

    # phase 10's tree is written while nvcc compiles (both only use the host)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        tree = pool.submit(write_cli_tree)
        built = cuda_build.build()
        cli_root = tree.result()
    cuda_build.library()
    ptxas = [ln.strip() for ln in built["log"].splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    say("build", built["seconds"], f"{built['command']}\n  " + "\n  ".join(ptxas))
    t1 = time.perf_counter()
    mma = tensor_core_instructions()
    say("build", time.perf_counter() - t1,
        "tensor-core instructions in the SASS of each forward and backward kernel: "
        + ", ".join(f"{k} {v}" for k, v in mma.items()))

    shapes = phase_kernel()
    main_path, ctx = phase_main_path()
    main_bf16 = phase_main_path_bf16(ctx)
    torch.cuda.empty_cache()
    backward, radius = phase_backward()
    train = phase_train()
    train_bf16 = phase_train_bf16()
    torch.cuda.empty_cache()
    oracle = phase_oracle()
    gen, gen_ctx = phase_gen(ctx)
    del ctx
    torch.cuda.empty_cache()
    gmw = phase_gmw(gen_ctx)
    del gen_ctx
    torch.cuda.empty_cache()
    cli = phase_cli(cli_root)
    gmw_cli = phase_gmw_cli(cli["gmw_inputs"])
    torch.cuda.empty_cache()
    dist = phase_dist(cli_root)

    def total(key):
        return sum(r[key] * r["count"] for r in shapes)

    # K1 in each precision: the fp32 forward's launches (main path) and the
    # bf16 forward's (main path in bf16), per forward at batch 2
    kernels = [{
        "name": name,
        "route": "cuda",
        "source": "dcd_tpu_torch/csrc/dcn_fwd.cu",
        "replaces": "dcd_tpu/ops/dcn_pallas.py:370",
        # the layout variants of the same TPU kernel (wc, C = 64 lane-packed)
        "also_replaces": ["dcd_tpu/ops/dcn_pallas.py:102", "dcd_tpu/ops/dcn_pallas.py:225"],
        "launches": launches,
        "max_abs_err": max(r[f"{tag}_max_abs_err"] for r in shapes),
        "ms": total(f"{tag}_ms"),
        "plain_ms": total(f"{tag}_plain_ms"),
        "bound_ms": total(f"{tag}_bound_ms"),
        "bound_by": max(("bytes", "operations"),
                        key=lambda b: sum(r[f"{tag}_bound_ms"] * r["count"] for r in shapes
                                          if r[f"{tag}_bound_by"] == b)),
        "library_ms": None,
    } for name, tag, launches in (("dcn_fwd", "fp32", main_path["launches"]),
                                  ("dcn_fwd_bf16", "bf16", main_bf16["launches"]["dcn_fwd_bf16"]))]
    # K2 and K3 per train step at batch 2: the sum over the 16 DCN blocks;
    # fp32 launches from the fp32 train phase, bf16 ones from the bf16 phase
    step_rows = [r for r in backward if r["batch"] == BATCH]
    for name, key, replaces, also, cuda_kernels in (
            ("dcn_bwd_pom", "pom", "dcd_tpu/ops/dcn_pallas.py:859", "dcd_tpu/ops/dcn_pallas.py:746",
             ["bwd_pom_kernel", "bwd_weight_kernel", "bwd_weight_reduce_kernel"]),
            ("dcn_bwd_x", "x", "dcd_tpu/ops/dcn_pallas.py:1246", "dcd_tpu/ops/dcn_pallas.py:1163",
             ["bwd_x_kernel"])):
        grads = ("grad_offset", "grad_mask", "grad_weight") if key == "pom" else ("grad_x",)
        for tag, errors, launches in (("", "errors", train["launches"][name]),
                                      ("_bf16", "errors_bf16",
                                       train_bf16["launches"][f"{name}_bf16"])):
            kernels.append({
                "name": name + tag,
                "route": "cuda",
                "source": "dcd_tpu_torch/csrc/dcn_bwd.cu",
                "replaces": replaces,
                "also_replaces": [also],  # the wc layout variant
                "cuda_kernels": cuda_kernels,
                "launches": launches,
                "max_abs_err": max(r[errors][gname]["max_abs_err"] for r in backward for gname in grads),
                "ms": sum(r[f"{key}{tag}_ms"] * r["count"] for r in step_rows),
                "plain_ms": sum(r[f"{key}{tag}_plain_ms"] * r["count"] for r in step_rows),
                "bound_ms": sum(r[f"{key}{tag}_bound_ms"] * r["count"] for r in step_rows),
                "bound_by": max(("bytes", "operations"),
                                key=lambda b: sum(r[f"{key}{tag}_bound_ms"] * r["count"] for r in step_rows
                                                  if r[f"{key}{tag}_bound_by"] == b)),
                "library_ms": None,
            })
    say("done", time.perf_counter() - t0, "all phases passed")
    details = {"card": smi, "build_seconds": built["seconds"], "tensor_core_instructions": mma,
               "shapes": shapes, "main_path": main_path, "main_path_bf16": main_bf16,
               "backward": backward, "backward_radius": radius, "train": train,
               "train_bf16": train_bf16, "oracle": oracle, "gen": gen, "gmw": gmw, "cli": cli,
               "gmw_cli": gmw_cli, "dist": dist}
    # every profiled kernel by name goes to a file; the line keeps the top ones
    DETAILS_FILE.parent.mkdir(parents=True, exist_ok=True)
    DETAILS_FILE.write_text(json.dumps(details, indent=1))
    for prof in (main_path["profile"], train["profile"], train_bf16["profile"], gen["profile"],
                 *(t["profile"] for t in main_bf16["timing"].values())):
        prof.pop("kernels")
    print("[details] " + json.dumps(details))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
