"""Multi-scale training with static-shape buckets.

A copy of the JAX package's ``dcd_tpu/data/multiscale.py``. Under PyTorch a
new shape costs no compile, but the buckets keep the JAX package's batches:
the same sizes, chosen per batch by the same seeded draw.

The reference's RandomResize cycles a fixed list of training sizes
(``INPUT.MULTI_TRAIN_SIZE`` config/defaults.py:64, chosen per batch pair by
a seeded counter, augmentations.py:89-132) — under torch that's free;
under XLA every input shape is a separate compiled program, so
multi-scale becomes *bucketed*: each size in the list is one static
bucket, every batch is resized+padded to exactly one bucket, and the
train step compiles once per bucket.

Bucket choice is deterministic per batch index (seeded, like the
reference's choice list) so all processes pick the same bucket for the
same step — mandatory for SPMD.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ..config import Config
from .augmentations import resize_scene
from .kitti_geometry import Calibration
from .target_encoder import EncodedSample, encode_targets


@dataclasses.dataclass(frozen=True)
class ScaleBucket:
    width: int
    height: int

    def cfg_for(self, cfg: Config) -> Config:
        return dataclasses.replace(
            cfg, input=dataclasses.replace(cfg.input, width_train=self.width, height_train=self.height)
        )


def make_buckets(cfg: Config) -> List[ScaleBucket]:
    sizes = getattr(cfg.input, "multi_train_size", None) or (
        (cfg.input.width_train, cfg.input.height_train),
    )
    return [ScaleBucket(int(w), int(h)) for (w, h) in sizes]


def bucket_schedule(num_buckets: int, seed: int = 63, length: int = 100000) -> np.ndarray:
    """Deterministic bucket index per batch (reference seeds 63 and repeats
    each choice for 2 consecutive samples; here per *batch*)."""
    rng = np.random.RandomState(seed)
    return rng.choice(num_buckets, size=length).astype(np.int32)


def encode_at_bucket(
    img: np.ndarray,
    objs,
    calib: Calibration,
    cfg: Config,
    bucket: ScaleBucket,
    img_id: str = "000000",
    is_train: bool = True,
) -> EncodedSample:
    """Resize the scene so it fits the bucket, then encode at the bucket's
    static input shape."""
    img_h, img_w = img.shape[:2]
    scale = min(bucket.width / img_w, bucket.height / img_h)
    if abs(scale - 1.0) > 1e-6:
        img, objs, calib = resize_scene(img, objs, calib, scale)
    return encode_targets(
        img, objs, calib, bucket.cfg_for(cfg), img_id=img_id, is_train=is_train
    )
