"""Gen-for-GMW step: eval-mode forward + per-object interchange fields.

The counterpart of ``dcd_tpu/engine/gen.py`` (the data collection inside the
reference's ``Loss_Computation.prepare_predictions``/``generate_data``,
detector_loss.py:148-173, :365-402, run with frozen BN, trainer.py:62-67,
97-98): for each ground-truth object slot, gather the predicted keypoints
at the ground-truth centre, decode the pair-depth location and the yaw, and
emit kpts_2d in image pixels, kpts_3d, pred_rot, the ground-truth and
predicted locations, and the slot mask.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping

import torch

from ..config import Config
from ..models.detector import KeypointDetector
from ..models.predictor import Converter_key2channel
from ..ops import codec
from ..ops.nms import select_point_of_interest
from .train import batch_to_device


def make_gen_step(cfg: Config, model: KeypointDetector) -> Callable[[Mapping], Dict[str, torch.Tensor]]:
    """``gen_step(batch) -> fields`` on the model's device, for a collated
    batch of :mod:`dcd_tpu_torch.data.target_encoder`. The forward runs in
    eval mode (BN frozen) and computes the dense regression map, not the
    lazy top-K path; the model's mode is restored after it. Each field is
    flat over the B * max_objects slots. (The JAX step also decodes the
    dimensions, which none of its outputs uses.)"""
    head = cfg.model.head
    k2c = Converter_key2channel(head.regression_heads, head.regression_channels)
    down = cfg.model.backbone.down_ratio
    M = cfg.datasets.max_objects

    @torch.no_grad()
    def gen_step(batch: Mapping) -> Dict[str, torch.Tensor]:
        dev = next(model.parameters()).device
        batch = batch_to_device(batch, dev)
        was_training = model.training
        model.eval()
        try:
            reg = model(batch["images"], batch["edge_indices"], batch["edge_len"])["reg"]
        finally:
            model.train(was_training)
        K = reg.shape[0] * M

        def flat(x):
            return x.reshape((K,) + tuple(x.shape[2:]))

        pois = select_point_of_interest(batch["target_centers"], reg).reshape(K, -1)
        m3d = flat(batch["reg_mask"]).float()
        centers = flat(batch["target_centers"]).float()
        gt_offset3d = flat(batch["offset_3D"]).float()
        # an identity P in the empty slots keeps their decode finite
        eye = torch.tensor([[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 0]], device=dev)
        safe_P = torch.where(m3d[:, None, None] > 0, flat(batch["Calib_P"]).float(), eye)
        pad_size = torch.repeat_interleave(batch["pad_size"].float(), M, dim=0)

        pred_ek2 = pois[:, k2c("extra_kpts_2d")].reshape(K, -1, 2)
        pred_ek3 = pois[:, k2c("extra_kpts_3d")].reshape(K, -1, 3)
        pred_orient = torch.cat([pois[:, k2c("ori_cls")], pois[:, k2c("ori_offset")]], dim=1)
        kpts_2d_img = codec.decode_kpts_2d_img(pred_ek2, centers, gt_offset3d, pad_size, down)
        pairs, _ = codec.decode_pairs_kpts_depth(
            kpts_2d_img, pred_ek3, flat(batch["rotys"]).float(), safe_P, training=True,
            pairs_topk=head.pairs_topk, clamp=head.pairs_depth_clamp)
        pred_loc = codec.decode_location(centers, pois[:, k2c("3d_offset")], pairs.mean(dim=1),
                                         safe_P, pad_size, down)
        pred_rotys, _ = codec.decode_axes_orientation(pred_orient, pred_loc,
                                                      cfg.input.orientation_bin_size)
        return {
            "kpts_2d_img": kpts_2d_img,
            "kpts_3d": pred_ek3,
            "pred_rot": pred_rotys,
            "gt_location": flat(batch["locations"]).float(),
            "pred_location": pred_loc,
            "mask": m3d,
        }

    return gen_step
