"""Oracle injection: ground-truth head outputs through the port's decode and
evaluator.

The twin of the JAX package's ``tools/oracle_inject.py``: the same flags,
and ``--device`` (``cuda`` unless asked for ``cpu``; with no card it
raises). Head outputs are built from the port's ``target_encoder`` targets
as the exact inverse of every decode in ``engine/infer.py::postprocess``
(heatmap peaks, 2D extents, 3D offsets, dimensions, multibin orientation,
depth, the 10 box keypoints and the 73 extra keypoints), optionally with
Gaussian pixel noise on the keypoints, and pushed through the port's
``postprocess`` (top-K, box decode, orientation, the mean edge-pair depth
over all 2628 pairs, uncertainty rescoring), ``format_kitti_lines`` at 6
decimals and the port's KITTI evaluator (R40, Car, moderate). No network
weights are involved. The noise draws (``np.random.RandomState(17)`` per
noise level) and the scores are the JAX tool's, so both give the same table.

    python -m dcd_tpu_torch.tools.oracle_inject [--scenes 24] [--noise 0 1 8] \\
        [--out build/oracle_3d.md] [--device cpu]

The table goes to ``--out`` (by default under ``build/``); the JAX
package's numbers are in ``docs/ORACLE_3D.md``.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
from typing import List, Optional

import numpy as np
import torch

from ..config import dgde_run_config
from ..data import synthetic
from ..data.target_encoder import encode_targets
from ..engine.infer import format_kitti_lines, postprocess, resolve_device
from ..evaluation import kitti_eval
from ..models.predictor import Converter_key2channel

DEFAULT_OUT = os.path.join("build", "oracle_3d.md")


def build_oracle_predictions(cfg, sample, noise_px=0.0, rng=None, score_base=0.95):
    """GT targets -> the head-output dict ``postprocess`` consumes (numpy,
    a batch of one), the number of objects injected and of those skipped
    (no in-frame 2D box target). ``noise_px`` adds N(0, noise_px^2)
    original-image-pixel noise to the 10 box keypoints and the 73 extra
    keypoints, drawn from ``rng`` in the JAX tool's order."""
    head = cfg.model.head
    k2c = Converter_key2channel(head.regression_heads, head.regression_channels)
    down = cfg.model.backbone.down_ratio
    H, W = cfg.input.height_train, cfg.input.width_train
    Ho, Wo = H // down, W // down
    num_cls = cfg.datasets.max_classes_num
    R_total = sum(c for group in head.regression_channels for c in group)
    nb = cfg.input.orientation_bin_size

    t = sample.targets
    cls_map = np.zeros((Ho, Wo, num_cls), np.float32)
    reg_map = np.zeros((Ho, Wo, R_total), np.float32)
    mean = np.asarray(head.dimension_mean, np.float32)
    alpha_centers = np.array([0.0, np.pi / 2, np.pi, -np.pi / 2], np.float32)
    if head.dimension_reg[0] != "exp" or head.dimension_reg[2] or head.depth_mode != "inv_sigmoid":
        raise ValueError("the oracle inverts the exp dimension and inv_sigmoid depth decodes")

    n_obj = n_skipped = 0
    for i in range(len(t["reg_mask"])):
        if t["reg_mask"][i] <= 0:
            continue
        cx, cy = int(t["target_centers"][i][0]), int(t["target_centers"][i][1])
        box = t["bboxes_2d"][i]
        if box[2] <= box[0] or box[3] <= box[1]:
            n_skipped += 1  # no 2D target in the encoder
            continue
        v = np.zeros(R_total, np.float32)
        v[k2c("2d_dim")] = [cx - box[0], cy - box[1], box[2] - cx, box[3] - cy]
        v[k2c("3d_offset")] = t["offset_3D"][i]

        kpts = t["keypoints"][i][:, :2].copy()  # (10, 2) relative to the centre, feature map
        if noise_px > 0:
            kpts += rng.randn(*kpts.shape).astype(np.float32) * (noise_px / down)
        v[k2c("corner_offset")] = kpts.reshape(-1)
        v[k2c("corner_uncertainty")] = np.log(0.05)

        cls_id = int(t["cls_ids"][i])
        v[k2c("3d_dim")] = np.log(t["dimensions"][i] / mean[cls_id])

        offs = float(t["alphas"][i]) - alpha_centers[:nb]
        offs = np.where(offs > np.pi, offs - 2 * np.pi, offs)
        offs = np.where(offs < -np.pi, offs + 2 * np.pi, offs)
        ori_cls = np.zeros(nb * 2, np.float32)
        ori_off = np.zeros(nb * 2, np.float32)
        for b in range(nb):
            # logits (0, s): the softmax picks the bin of smallest |offset|
            ori_cls[2 * b + 1] = 8.0 - 2.0 * abs(offs[b])
            ori_off[2 * b] = np.sin(offs[b])
            ori_off[2 * b + 1] = np.cos(offs[b])
        v[k2c("ori_cls")] = ori_cls
        v[k2c("ori_offset")] = ori_off

        v[k2c("depth")] = -np.log(float(t["locations"][i][2]))  # sigmoid^-1(1 / (1 + z))
        v[k2c("depth_uncertainty")] = np.log(0.01)

        # decode: (ch + center + offset_3D) * down - pad, so ch = target - offset_3D
        ek2 = (t["extra_kpts_2d"][i][:, :2] - t["offset_3D"][i][None, :]).copy()
        if noise_px > 0:
            ek2 += rng.randn(*ek2.shape).astype(np.float32) * (noise_px / down)
        v[k2c("extra_kpts_2d")] = ek2.reshape(-1)
        v[k2c("extra_kpts_3d")] = t["extra_kpts_3d"][i].reshape(-1)

        reg_map[cy, cx] = v
        cls_map[cy, cx, cls_id] = score_base - 0.002 * n_obj  # distinct scores
        n_obj += 1
    return {"cls": cls_map[None], "reg": reg_map[None]}, n_obj, n_skipped


def _label_line(ob) -> str:
    return (f"Car {ob.truncation:.2f} {ob.occlusion} {ob.alpha:.2f} "
            f"{ob.box2d[0]:.2f} {ob.box2d[1]:.2f} {ob.box2d[2]:.2f} {ob.box2d[3]:.2f} "
            f"{ob.h:.2f} {ob.w:.2f} {ob.l:.2f} "
            f"{ob.t[0]:.2f} {ob.t[1]:.2f} {ob.t[2]:.2f} {ob.ry:.2f}\n")


def run_sweep(noise_levels, n_scenes, seed0=10_000, image_size=None, num_objs=8,
              device=None, detections: Optional[list] = None) -> List[dict]:
    """Rows {noise_px, ap_bbox, ap_bev_05, ap_3d_05, ap_bev_07, ap_3d_07,
    n_obj, n_skipped} (Car, moderate, R40), one per noise level, with
    ``postprocess`` on ``device``. A list given as ``detections`` receives
    (noise, image id, rows, valid) of every image."""
    dev = resolve_device(device)
    cfg = dgde_run_config()
    kw = {} if image_size is None else {"image_size": image_size}
    raw = [synthetic.make_scene(seed=seed0 + s, num_objs=num_objs, **kw) for s in range(n_scenes)]
    samples = [encode_targets(img, objs, calib, cfg, img_id=f"{seed0 + s:06d}")
               for s, (img, objs, calib) in enumerate(raw)]

    rows = []
    for noise in noise_levels:
        rng = np.random.RandomState(17)
        tmp = tempfile.mkdtemp()
        try:
            rd, gd = os.path.join(tmp, "r"), os.path.join(tmp, "g")
            os.makedirs(rd)
            os.makedirs(gd)
            tot_obj = tot_skip = 0
            for si, (s, (_, objs, _)) in enumerate(zip(samples, raw)):
                # distinct scores across the split: the protocol mints at most
                # one recall threshold per distinct true-positive score
                preds, n_obj, n_skip = build_oracle_predictions(
                    cfg, s, noise, rng, score_base=0.92 - 0.0021 * si * num_objs)
                tot_obj += n_obj
                tot_skip += n_skip
                t = s.targets
                out = postprocess(cfg, {k: torch.from_numpy(v).to(dev) for k, v in preds.items()},
                                  *(torch.from_numpy(np.asarray(t[k], np.float32)[None]).to(dev)
                                    for k in ("calib_P_full", "pad_size", "image_size")))
                dets = out["dets"][0].cpu().numpy()
                valid = out["valid"][0].cpu().numpy()
                if detections is not None:
                    detections.append((noise, s.img_id, dets, valid))
                # 6 decimals: at 2 the near-exact boxes land exactly on the
                # labels, the protocol IoU's coincident-polygon case
                with open(os.path.join(rd, f"{s.img_id}.txt"), "w") as f:
                    f.write("\n".join(format_kitti_lines(dets, valid, decimals=6)) + "\n")
                with open(os.path.join(gd, f"{s.img_id}.txt"), "w") as f:
                    f.writelines(_label_line(ob) for ob in objs)
            split = os.path.join(tmp, "val.txt")
            with open(split, "w") as f:
                f.write("\n".join(s.img_id for s in samples))
            _, ret = kitti_eval.evaluate_from_files(gd, rd, split, 0, metric="R40")
        finally:
            shutil.rmtree(tmp)
        rows.append({
            "noise_px": noise,
            "ap_bbox": float(ret["Car_image/moderate"]),
            "ap_bev_05": float(ret["Car_bev_moderate_R40_0.50"]),
            "ap_3d_05": float(ret["Car_3d_moderate_R40_0.50"]),
            "ap_bev_07": float(ret["Car_bev_moderate_R40_0.70"]),
            "ap_3d_07": float(ret["Car_3d_moderate_R40_0.70"]),
            "n_obj": tot_obj,
            "n_skipped": tot_skip,
        })
        print(f"# noise={noise:>5.2f}px: {rows[-1]}", file=sys.stderr)
    return rows


def table(rows, scenes, device) -> List[str]:
    md = [
        "# Oracle injection through the PyTorch port",
        "",
        f"`python -m dcd_tpu_torch.tools.oracle_inject --scenes {scenes}` on {device}: "
        "ground-truth head outputs (the inverse of every decode of "
        "`engine/infer.py::postprocess`, from the port's `target_encoder` targets) "
        "through the port's `postprocess` and KITTI evaluator. Gaussian pixel noise "
        "on the 10 box keypoints and the 73 extra keypoints only. Car moderate, R40; "
        f"held-out synthetic scenes (seeds 10000+, {scenes} images). The JAX "
        "package's table: docs/ORACLE_3D.md.",
        "",
        "| kpt noise (px) | bbox AP | BEV@0.5 | 3D@0.5 | BEV@0.7 | 3D@0.7 |",
        "|---|---|---|---|---|---|",
    ]
    for r in rows:
        md.append(f"| {r['noise_px']:.2f} | {r['ap_bbox']:.2f} | {r['ap_bev_05']:.2f} "
                  f"| {r['ap_3d_05']:.2f} | {r['ap_bev_07']:.2f} | {r['ap_3d_07']:.2f} |")
    md += ["", f"objects injected per sweep: {rows[0]['n_obj']} (skipped, no in-frame 2D box "
           f"target: {rows[0]['n_skipped']})"]
    return md


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="oracle injection through the port")
    ap.add_argument("--scenes", type=int, default=24)
    ap.add_argument("--noise", type=float, nargs="*", default=[0.0, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    rows = run_sweep(args.noise, args.scenes, device=args.device)
    md = table(rows, args.scenes, resolve_device(args.device))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(md) + "\n")
    print("\n".join(md))
    z = rows[0]
    ok = z["ap_3d_07"] >= z["ap_bbox"] - 0.01 and z["ap_3d_07"] >= 80.0
    print(f"\nRESULT: {'OK' if ok else 'FAIL'} (zero-noise 3D@0.7 = {z['ap_3d_07']:.2f}, "
          f"bbox ceiling = {z['ap_bbox']:.2f})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
