"""The inputs of a run, made from its seed.

Inference: batches of KITTI-sized frames (the traffic's ``image`` size,
1242x375) padded to the input canvas, normalised, as the program's loader
hands them: fp32 NHWC in pinned host memory, the pad region at the value
that a zero pixel normalises to. A frame is smooth random structure (a
coarse random field upsampled, plus pixel noise), drawn on the device in one
call per batch and copied to the host once. With each batch go its camera
(KITTI's P2), pad offset, image size and the boundary ring that edge fusion
reads.

Training: synthetic KITTI scenes (the frozen scene generator) encoded by the
frozen numpy target encoder and collated, as the program's loader hands a
batch: torch tensors in pinned host memory.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from .data import synthetic, target_encoder
from .data.edges import KITTI_P2, get_edge_indices


@dataclass
class FrameBatch:
    images: torch.Tensor  # (B, H, W, 3) fp32
    edge_indices: torch.Tensor  # (B, L, 2) int64
    edge_len: torch.Tensor  # (B,) int64
    calib_P: torch.Tensor  # (B, 3, 4) fp32
    pad_size: torch.Tensor  # (B, 2) fp32
    img_size: torch.Tensor  # (B, 2) fp32

    def to(self, device) -> "FrameBatch":
        return FrameBatch(*(getattr(self, f).to(device) for f in self.__dataclass_fields__))

    def narrow(self, start: int, n: int) -> "FrameBatch":
        return FrameBatch(*(getattr(self, f)[start:start + n] for f in self.__dataclass_fields__))


def frame_geometry(cfg, batch: int, image_size):
    """Edge ring, camera, pad and size of ``batch`` frames of
    ``image_size`` (w, h) on the configuration's canvas (host tensors)."""
    img_w, img_h = image_size
    in_w, in_h = cfg.input.width_train, cfg.input.height_train
    down = cfg.model.backbone.down_ratio
    pad = target_encoder.pad_offset(img_w, img_h, in_w, in_h)
    ring = get_edge_indices((img_w, img_h), pad, down)
    edge = np.zeros((cfg.max_edge_length, 2), np.int64)
    edge[:len(ring)] = ring
    rep = lambda a: torch.from_numpy(np.ascontiguousarray(np.repeat(a[None], batch, 0)))  # noqa: E731
    # the loader's count: the ring's length less one (reference kitti.py:336)
    return (rep(edge), torch.full((batch,), len(ring) - 1, dtype=torch.int64),
            rep(KITTI_P2.astype(np.float32)), rep(pad.astype(np.float32)),
            rep(np.array([img_w, img_h], np.float32)))


@torch.no_grad()
def frame_batches(cfg, traffic, seed: int, device, pin: bool) -> List[FrameBatch]:
    """``traffic["pool"]`` distinct batches of ``traffic["batch"]`` frames,
    in host memory (pinned where ``pin``)."""
    B = traffic["batch"]
    img_w, img_h = traffic["image"]
    in_w, in_h = cfg.input.width_train, cfg.input.height_train
    pad = target_encoder.pad_offset(img_w, img_h, in_w, in_h)
    mean = torch.tensor(cfg.input.pixel_mean, device=device)
    std = torch.tensor(cfg.input.pixel_std, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    geometry = frame_geometry(cfg, B, (img_w, img_h))
    out = []
    for _ in range(traffic["pool"]):
        coarse = torch.rand((B, 3, img_h // 16 + 1, img_w // 16 + 1), generator=gen, device=device)
        img = F.interpolate(coarse, size=(img_h, img_w), mode="bilinear", align_corners=False)
        img = img + 0.05 * torch.randn((B, 3, img_h, img_w), generator=gen, device=device)
        img = ((img.clamp(0, 1) * 255).round() / 255).permute(0, 2, 3, 1)
        canvas = torch.zeros((B, in_h, in_w, 3), device=device)
        canvas[:, pad[1]:pad[1] + img_h, pad[0]:pad[0] + img_w] = img
        images = torch.empty(canvas.shape, dtype=canvas.dtype, pin_memory=pin)
        images.copy_((canvas - mean) / std)  # straight into the host buffer
        out.append(FrameBatch(images, *geometry))
    return out


def scene_batches(cfg, traffic, seed: int, pin: bool) -> List[Dict[str, torch.Tensor]]:
    """``traffic["pool"]`` distinct collated batches of ``traffic["batch"]``
    synthetic scenes of ``traffic["image"]`` (w, h) with
    ``traffic["objects"]`` cars each, every scene of its own seed drawn from
    ``seed``."""
    B, pool = traffic["batch"], traffic["pool"]
    seeds = np.random.default_rng(seed).integers(0, 2 ** 31 - 1, size=B * pool)
    out = []
    for p in range(pool):
        samples = [target_encoder.encode_targets(
            *synthetic.make_scene(seed=int(s), num_objs=traffic["objects"],
                                  extra_kpts_num=cfg.model.head.extra_kpts_num,
                                  image_size=tuple(traffic["image"])), cfg)
            for s in seeds[p * B:(p + 1) * B]]
        batch = target_encoder.collate(samples)
        tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        out.append({k: v.pin_memory() if pin else v for k, v in tensors.items()})
    return out
