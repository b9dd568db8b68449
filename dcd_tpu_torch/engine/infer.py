"""Inference: build the detector, run it, decode heatmap peaks to KITTI rows.

:func:`postprocess` is the counterpart of ``dcd_tpu/engine/infer.py`` (the
reference ``PostProcessor``, DGDE/model/head/detector_infer.py:27-243):
max-pool NMS + top-K + score threshold, FCOS 2D boxes, class-mean
dimensions, multi-bin orientation, the soft depth ensemble (which fixes the
ray for the orientation), then the final depth by ``output_depth`` ('edges',
the shipped default, is the mean of the edge-pair depths), uncertainty as
confidence, and KITTI rows
``[cls, alpha, box2d(4), dims hwl(3), locs(3), roty, score]``. Every image
keeps K rows plus a validity mask.

:func:`build_detector` and :func:`infer` are the entry points, the
counterparts of ``dcd_tpu.engine.train.build_model`` and
``make_eval_forward``: weights in, images out, rows back.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from ..config import Config
from ..models.detector import KeypointDetector
from ..models.gmw import lecun_normal_
from ..models.layers import DCN
from ..models.predictor import Converter_key2channel
from ..ops import codec
from ..ops.nms import nms_hm, select_point_of_interest, select_topk


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """``cuda`` unless the caller names another device; raises when CUDA is
    asked for and there is no card (nothing falls back to the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was asked for and no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    return dev


def build_detector(cfg: Config, device: Union[str, torch.device, None] = None,
                   seed: int = 0) -> KeypointDetector:
    """The detector in eval mode on ``device``, with random weights drawn
    from ``torch.Generator`` ``seed`` (load a state dict over them for real
    weights). With ``cfg.model.fp16`` its activations are bf16 and its
    parameters fp32, as in the JAX package; :func:`postprocess` runs in fp32
    either way."""
    dev = resolve_device(device)
    model = KeypointDetector(cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


@torch.no_grad()
def init_weights(model: KeypointDetector, gen: torch.Generator) -> None:
    """Redraw every weight from ``gen`` from the distribution that the JAX
    package's ``model.init`` gives it (flax's defaults): every conv of the
    trunk, the projections, the heads and ``EdgeFusion`` :func:`lecun_normal_`
    (``nn.Conv``'s default), every DCN kernel uniform in +-1/sqrt(fan_in)
    (``variance_scaling(1/3, "fan_in", "uniform")``), the uncertainty heads
    a normal of variance 1e-4 / fan_avg (``uncertainty_init``), zero biases
    but the class head's focal prior, zero offset convs (the module's own
    init), unit BN with zero running mean, and the bilinear upsampling
    kernels kept."""
    heads = model.heads
    head = model.cfg.model.head
    small = {}
    for group, convs in zip(head.regression_heads, heads.reg_heads):
        for key, conv in zip(group, convs):
            if "uncertainty" in key and head.uncertainty_init:
                small[id(conv)] = (1e-4 / ((conv.in_channels + conv.out_channels) / 2)) ** 0.5
    skip = set()
    for mod in model.modules():
        if isinstance(mod, DCN):
            skip.add(id(mod.conv_offset_mask))
    for mod in model.modules():
        if not isinstance(mod, (DCN, torch.nn.Conv2d, torch.nn.Conv1d)) or id(mod) in skip:
            continue
        if isinstance(mod, DCN):
            bound = 1.0 / mod.weight[0].numel() ** 0.5
            mod.weight.copy_(torch.rand(mod.weight.shape, generator=gen) * (2 * bound) - bound)
        elif id(mod) in small:
            mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen) * small[id(mod)])
        else:
            lecun_normal_(mod.weight, gen)
        if mod.bias is not None and mod is not heads.class_head[3]:
            mod.bias.zero_()


def postprocess(cfg: Config, predictions: Dict[str, torch.Tensor], calib_P: torch.Tensor,
                pad_size: torch.Tensor, img_size: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Head outputs -> (B, K, 14) KITTI rows + validity.

    calib_P: (B, 3, 4); pad_size: (B, 2); img_size: (B, 2) original (w, h).
    Takes either the lazy path's outputs (``reg_pois``) or the dense map
    (``reg``).
    """
    head = cfg.model.head
    k2c = Converter_key2channel(head.regression_heads, head.regression_channels)
    down = cfg.model.backbone.down_ratio
    K = cfg.test.detections_per_img

    if "reg_pois" in predictions:
        B = predictions["cls"].shape[0]
        scores, clses = predictions["scores"], predictions["clses"]
        points = predictions["points_xy"]
        pois = predictions["reg_pois"].float()
    else:
        hm = nms_hm(predictions["cls"])
        B = hm.shape[0]
        scores, indexs, clses, ys, xs = select_topk(hm, K=K)
        points = torch.stack([xs, ys], dim=-1)
        pois = select_point_of_interest(indexs, predictions["reg"]).float()

    N = B * K
    pois = pois.reshape(N, -1)
    points = points.reshape(N, 2)
    scores = scores.reshape(N)
    clses = clses.reshape(N)
    valid = scores >= cfg.test.detections_threshold

    def per_det(x):
        return torch.repeat_interleave(x.float(), K, dim=0)

    P_det, pad_det, size_det = per_det(calib_P), per_det(pad_size), per_det(img_size)

    reg2d = torch.relu(pois[:, k2c("2d_dim")])
    offset3d = pois[:, k2c("3d_offset")]
    dims_off = pois[:, k2c("3d_dim")]
    orient = torch.cat([pois[:, k2c("ori_cls")], pois[:, k2c("ori_offset")]], dim=1)

    # 2D box in original-image pixels (anno_encoder.py:74-91)
    box2d = torch.cat([points - reg2d[:, :2], points + reg2d[:, 2:]], dim=1)
    box2d = box2d * down - pad_det.repeat(1, 2)
    wmax = size_det[:, 0] - 1
    hmax = size_det[:, 1] - 1
    zero = torch.zeros_like(wmax)
    box2d = torch.stack([
        torch.minimum(torch.maximum(box2d[:, 0], zero), wmax),
        torch.minimum(torch.maximum(box2d[:, 1], zero), hmax),
        torch.minimum(torch.maximum(box2d[:, 2], zero), wmax),
        torch.minimum(torch.maximum(box2d[:, 3], zero), hmax),
    ], dim=1)

    dev = pois.device
    dims = codec.decode_dimension(
        clses, dims_off, torch.tensor(head.dimension_mean, device=dev),
        torch.tensor(head.dimension_std, device=dev), head.dimension_reg)  # (N, 3) l/h/w

    direct_depth = codec.decode_depth(pois[:, k2c("depth")].squeeze(-1), head.depth_mode,
                                      head.depth_reference, head.depth_range)
    direct_unc = torch.exp(pois[:, k2c("depth_uncertainty")])
    kpt_offset = pois[:, k2c("corner_offset")].reshape(N, 10, 2)
    kpt_depths = codec.decode_depth_from_keypoints(kpt_offset, dims, P_det, down,
                                                   depth_range=head.depth_range)
    kpt_unc = torch.exp(pois[:, k2c("corner_uncertainty")])

    combined_depths = torch.cat([direct_depth[:, None], kpt_depths], dim=1)  # (N, 4)
    combined_unc = torch.cat([direct_unc, kpt_unc], dim=1)
    depth_weights = 1.0 / combined_unc
    depth_weights = depth_weights / depth_weights.sum(dim=1, keepdim=True)
    soft_depth = (combined_depths * depth_weights).sum(dim=1)
    estimated_depth_error = (depth_weights * combined_unc).sum(dim=1)

    coarse_loc = codec.decode_location(points, offset3d, soft_depth, P_det, pad_det, down)
    rotys, alphas = codec.decode_axes_orientation(orient, coarse_loc, cfg.input.orientation_bin_size)

    ek2 = pois[:, k2c("extra_kpts_2d")].reshape(N, -1, 2)
    ek3 = pois[:, k2c("extra_kpts_3d")].reshape(N, -1, 3)
    ek2_img = codec.decode_kpts_2d_img(ek2, points, offset3d, pad_det, down)
    mode = head.output_depth
    if mode == "edges":
        final_depth = codec.decode_pairs_kpts_depth(
            ek2_img, ek3, rotys, P_det, clamp=head.pairs_depth_clamp).mean(dim=1)
    elif mode == "soft":
        final_depth = soft_depth
    elif mode == "hard":
        final_depth = torch.gather(combined_depths, 1,
                                   torch.argmin(combined_unc, dim=1)[:, None]).squeeze(1)
    elif mode == "direct":
        final_depth = direct_depth
    else:
        raise ValueError(f"unknown OUTPUT_DEPTH mode {mode!r}")

    locations = codec.decode_location(points, offset3d, final_depth, P_det, pad_det, down)
    locations = torch.cat([locations[:, :1], locations[:, 1:2] + dims[:, 1:2] / 2.0,
                           locations[:, 2:]], dim=1)  # 3D centre -> bottom centre
    dims_hwl = torch.roll(dims, shifts=-1, dims=1)  # l,h,w -> h,w,l

    if cfg.test.uncertainty_as_confidence:
        conf = 1.0 - torch.clamp(estimated_depth_error, 0.01, 1.0)
        scores = scores * conf
        scores = torch.where(torch.isnan(scores), torch.zeros_like(scores), scores)

    result = torch.cat([clses[:, None], alphas[:, None], box2d, dims_hwl, locations,
                        rotys[:, None], scores[:, None]], dim=1)
    return {
        "dets": result.reshape(B, K, 14),
        "valid": (valid & (scores > 0)).reshape(B, K),
        "kpts_2d": ek2_img.reshape(B, K, -1, 2),
        "kpts_3d": ek3.reshape(B, K, -1, 3),
    }


@torch.no_grad()
def infer(model: KeypointDetector, images: torch.Tensor, edge_indices: torch.Tensor,
          edge_len: torch.Tensor, calib_P: torch.Tensor, pad_size: torch.Tensor,
          img_size: torch.Tensor, cfg: Optional[Config] = None) -> Dict[str, torch.Tensor]:
    """Images (B, H, W, 3) -> KITTI rows, on the model's device; the heads
    take the lazy top-K path when ``cfg.test.lazy_reg_heads`` is set.
    ``cfg`` (the model's unless given) sets the test-time options, such as
    the detection threshold."""
    cfg = model.cfg if cfg is None else cfg
    dev = next(model.parameters()).device
    preds = model(images.to(dev), edge_indices.to(dev), edge_len.to(dev),
                  lazy_topk=cfg.test.lazy_reg_heads)
    return postprocess(cfg, preds, calib_P.to(dev), pad_size.to(dev), img_size.to(dev))


def format_kitti_lines(dets, valid, class_names=("Car", "Pedestrian", "Cyclist"), decimals=2):
    """KITTI txt rows of one image's detections (reference
    generate_kitti_3d_detection: fixed field order, 2 decimals)."""
    lines = []
    dets = np.asarray(dets)
    valid = np.asarray(valid)
    for row, ok in zip(dets, valid):
        if not ok:
            continue
        cls = class_names[int(row[0])]
        vals = " ".join(f"{v:.{decimals}f}" for v in row[1:14])
        lines.append(f"{cls} 0.00 0 {vals}")
    return lines
