"""Two-stage artifact of the port: trained DGDE -> gen_data -> trained GMW ->
rescaled locations -> KITTI AP, on the same held-out synthetic scenes,
showing what stage 2 does to the 3D metrics against stage 1.

The twin of the JAX package's ``tools/two_stage_artifact.py`` (the reference
README.md:39-63 and GMW/main.py:486-564, through the same writers, loaders
and predict functions as the command lines), with the same flags and
``--device`` (``cuda`` unless asked for ``cpu``; with no card it raises):

1. restore the stage-1 weights that the port's
   ``dcd_tpu_torch.tools.convergence_run --save_ckpt DIR`` saved
   (``DIR/model_final.pt``; an orbax checkpoint of the JAX package cannot be
   read);
2. the gen step over the train pool (BN frozen, GT centres) ->
   ``gen_data_train.json``;
3. inference over the held-out val scenes -> stage-1 KITTI txts and
   ``gen_data_infer.json``;
4. GMW training on (2), the depths of (3) refined and the locations
   rescaled (GMW/main.py:540-548), stage-2 txts;
5. the KITTI evaluator on both txt sets, and the depth MAE of the
   detections matched to the labels by 2D IoU > 0.5.

It writes ``--out`` (``build/TWO_STAGE.md`` by default; the JAX package's
run is ``docs/TWO_STAGE.md``).

    python -m dcd_tpu_torch.tools.convergence_run --steps 600 --batch 16 --accum 2 \\
        --pool 256 --save_ckpt build/convergence_ckpt
    python -m dcd_tpu_torch.tools.two_stage_artifact --ckpt build/convergence_ckpt/model_final
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import Config, dgde_run_config
from ..data import synthetic
from ..data.gen_data import (GenDataInferWriter, GenDataTrainWriter, load_gen_data_infer,
                             load_gen_data_train, normalize_batch_kpts, normalize_kpts_2d)
from ..data.target_encoder import collate, encode_targets
from ..engine.gen import make_gen_step
from ..engine.gmw_train import (GMWConfig, create_gmw_state, loss_weights_for_epoch,
                                make_gmw_predict, make_gmw_train_step, rescale_location)
from ..engine.infer import build_detector, format_kitti_lines, infer
from ..evaluation import kitti_eval
from ..utils.checkpoint import Checkpointer
from .convergence_run import VAL_SEED0, _label_line

AP_KEYS = [
    ("bbox", "Car_image/moderate"),
    ("bev@0.5", "Car_bev_moderate_R40_0.50"),
    ("3d@0.5", "Car_3d_moderate_R40_0.50"),
    ("bev@0.7", "Car_bev_moderate_R40_0.70"),
    ("3d@0.7", "Car_3d_moderate_R40_0.70"),
]


def iou_2d(a, b) -> float:
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / max(ua, 1e-9)


def matched_depth_errors(det_rows, gt_objs) -> List[float]:
    """|z_det - z_gt| for detections matched to GT by 2D IoU > 0.5 (each GT
    once, greedily in row order)."""
    errs, used = [], set()
    for row in det_rows:
        best, best_j = 0.5, None
        for j, ob in enumerate(gt_objs):
            if j in used:
                continue
            v = iou_2d(row[2:6], ob.box2d)
            if v > best:
                best, best_j = v, j
        if best_j is not None:
            used.add(best_j)
            errs.append(abs(row[11] - gt_objs[best_j].t[2]))
    return errs


def run_config() -> Config:
    """The JAX tool's configuration: ``dgde_run_config()`` with bf16
    activations, pretrain off."""
    cfg = dgde_run_config()
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, fp16=True,
                                                              pretrain=False))


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="two-stage artifact of the port")
    ap.add_argument("--ckpt", default=os.path.join("build", "convergence_ckpt", "model_final"),
                    help="a DGDE checkpoint of the port (convergence_run --save_ckpt DIR)")
    ap.add_argument("--pool", type=int, default=256)
    ap.add_argument("--val_scenes", type=int, default=16)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--reg_start", type=int, default=30,
                    help="epoch of the cls->reg loss-weight flip (the reference flips at 50 of "
                    "100, GMW/main.py:312-315; scaled to the shorter schedule here)")
    ap.add_argument("--gmw_batch", type=int, default=8)
    ap.add_argument("--out", default=os.path.join("build", "TWO_STAGE.md"))
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, cfg: Optional[Config] = None,
        gmw_cfg: Optional[GMWConfig] = None, scene_kw: Optional[Dict] = None) -> Dict:
    """The artifact of ``args`` on ``cfg`` (by default :func:`run_config`);
    ``gmw_cfg`` replaces the GMW's widths and ``scene_kw`` goes to
    ``make_scene`` (the tests shrink both). Returns the AP of both stages,
    the matched depth MAEs and counts, each val image's stage-1 and stage-2
    depths, and the table's lines."""
    t0 = time.time()
    cfg = run_config() if cfg is None else cfg
    scene_kw = scene_kw or {}
    model = build_detector(cfg, args.device)
    ckpt_dir = os.path.dirname(os.path.abspath(args.ckpt))
    Checkpointer(ckpt_dir).load_model(model, args.ckpt)
    dev = next(model.parameters()).device
    print(f"# restored {args.ckpt} on {dev}", file=sys.stderr)
    tmp = tempfile.mkdtemp()
    try:
        return _stages(args, cfg, gmw_cfg, scene_kw, model, dev, tmp, t0)
    finally:
        shutil.rmtree(tmp)


def _stages(args, cfg, gmw_cfg, scene_kw, model, dev, tmp, t0) -> Dict:
    # ---- 2. gen_data over the train pool (GT-centre interchange) ----
    gen_cfg = dataclasses.replace(cfg, test=dataclasses.replace(cfg.test, generate_gmw=True))
    gen_step = make_gen_step(gen_cfg, model)
    writer = GenDataTrainWriter()
    M = cfg.datasets.max_objects
    for lo in range(0, args.pool, args.batch):
        samples = [encode_targets(*synthetic.make_scene(seed=s, num_objs=8, **scene_kw), cfg,
                                  img_id=f"{s:06d}")
                   for s in range(lo, min(lo + args.batch, args.pool))]
        if len(samples) < args.batch:
            break
        batch = {k: v for k, v in collate(samples).items() if not isinstance(v, list)}
        out = {k: v.cpu().numpy() for k, v in gen_step(batch).items()}
        m = out["mask"].astype(bool)
        objs = np.nonzero(m.reshape(-1))[0]
        kpts_norm = normalize_batch_kpts(out["kpts_2d_img"][m], objs // M,
                                         [s.calib.P for s in samples], per_sample_calib=False)
        writer.add_batch(kpts_norm, out["kpts_3d"][m], out["pred_rot"][m], out["gt_location"][m],
                         out["pred_location"][m], [samples[k // M].img_id for k in objs])
    train_json = os.path.join(tmp, "gen_data_train.json")
    writer.dump(train_json)
    with open(train_json) as f:  # the interchange is batched (reference schema)
        n_train_objs = sum(len(b) for b in json.load(f)["kpts_2d"])
    print(f"# gen_data_train: {n_train_objs} objects", file=sys.stderr)

    # ---- 3. stage-1 inference on held-out val + gen_data_infer ----
    # the heatmap's confidence alone, as the convergence tools score: the
    # uncertainty->confidence rescoring zeroes every score until the depth
    # uncertainties train below 1 m
    eval_cfg = dataclasses.replace(
        cfg, test=dataclasses.replace(cfg.test, uncertainty_as_confidence=False))
    val_raw = [synthetic.make_scene(seed=VAL_SEED0 + s, num_objs=8, **scene_kw)
               for s in range(args.val_scenes)]
    val_samples = [encode_targets(img, objs, calib, cfg, img_id=f"{VAL_SEED0 + s:06d}")
                   for s, (img, objs, calib) in enumerate(val_raw)]
    gd, rd1, rd2 = (os.path.join(tmp, d) for d in ("gt", "stage1", "stage2"))
    for d in (gd, rd1, rd2):
        os.makedirs(d)
    iw = GenDataInferWriter()
    ids, stage1_rows = [], {}
    model.eval()
    for s, (_, objs, _) in zip(val_samples, val_raw):
        t = s.targets
        im, ei, el = (torch.from_numpy(np.asarray(a)[None]) for a in
                      (s.image, t["edge_indices"], t["edge_len"]))
        post = [torch.from_numpy(np.asarray(t[k], np.float32)[None])
                for k in ("calib_P_full", "pad_size", "image_size")]
        o = {k: v.cpu().numpy() for k, v in
             infer(model, im, ei.long(), el.long(), *post, cfg=eval_cfg).items()}
        dets, valid = o["dets"][0], o["valid"][0]
        stage1_rows[s.img_id] = (dets[valid], objs)
        with open(os.path.join(rd1, f"{s.img_id}.txt"), "w") as f:
            f.write("\n".join(format_kitti_lines(dets, valid)) + "\n")
        with open(os.path.join(gd, f"{s.img_id}.txt"), "w") as f:
            f.writelines(_label_line(ob) for ob in objs)
        iw.add_image(s.img_id, dets, valid, normalize_kpts_2d(o["kpts_2d"][0], s.calib.P),
                     o["kpts_3d"][0])
        ids.append(s.img_id)
    infer_json = os.path.join(tmp, "gen_data_infer.json")
    iw.dump(infer_json)
    split = os.path.join(tmp, "val.txt")
    with open(split, "w") as f:
        f.write("\n".join(ids))

    # ---- 4. GMW training on the interchange ----
    n_kpts = cfg.model.head.num_kpts
    gcfg = dataclasses.replace(gmw_cfg or GMWConfig(), num_kpts=n_kpts, epochs=args.epochs,
                               batch_size=args.gmw_batch, reg_loss_start_epoch=args.reg_start)
    train = load_gen_data_train(train_json, n_kpts)
    N = train["kpts_2d"].shape[0]
    gmodel, gstate = create_gmw_state(gcfg, 1, steps_per_epoch=max(N // gcfg.batch_size, 1),
                                      device=dev)
    gstep = make_gmw_train_step(gcfg, gmodel)
    predict = make_gmw_predict(gcfg, gmodel)
    rng = np.random.RandomState(0)
    gmw_steps = 0
    for epoch in range(1, args.epochs + 1):
        cls_w, reg_w = loss_weights_for_epoch(gcfg, epoch)
        order = rng.permutation(N)
        last = {}
        for lo in range(0, N - gcfg.batch_size + 1, gcfg.batch_size):
            idx = order[lo:lo + gcfg.batch_size]
            batch = {"kpts_2d": train["kpts_2d"][idx], "kpts_3d": train["kpts_3d"][idx],
                     "pred_rot": train["pred_rot"][idx, 0],
                     "gt_depth": train["gt_location"][idx, 2]}
            last = gstep(gstate, batch, cls_w, reg_w)
            gmw_steps += 1
        if epoch % 10 == 0 or epoch == args.epochs:
            print(f"# gmw epoch {epoch}: "
                  + " ".join(f"{k}={float(v):.4f}" for k, v in last.items()), file=sys.stderr)

    # ---- refine the val detections, write the stage-2 txts ----
    arrays, img_idx = load_gen_data_infer(infer_json, n_kpts)
    n_val = arrays["kpts_2d"].shape[0]
    refined = {}
    bs = max(args.gmw_batch, 1)
    for lo in range(0, n_val, bs):
        sl = slice(lo, min(lo + bs, n_val))
        batch = {"kpts_2d": arrays["kpts_2d"][sl], "kpts_3d": arrays["kpts_3d"][sl],
                 "pred_rot": arrays["pred_rot"][sl, 0]}
        depths = predict(batch).cpu().numpy()
        locs = rescale_location(arrays["pred_location"][sl], depths, arrays["dim"][sl])
        for k, (img, det) in enumerate(img_idx[sl]):
            refined.setdefault(img, {})[det] = locs[k]
    with open(infer_json) as f:
        raw = json.load(f)
    stage2_rows = {}
    for img in ids:
        lines, rows = [], []
        for det, a in enumerate(raw.get(img, [])):
            loc = refined.get(img, {}).get(det, a["pred_location"])
            box, dim = a["box"], a["dim"]
            ori = a["pred_rot"][0] if isinstance(a["pred_rot"], list) else a["pred_rot"]
            score = a["score"][0] if isinstance(a["score"], list) else a["score"]
            alpha = ori - np.arctan2(loc[0], loc[2])
            lines.append(f"Car -1.00 -1 {alpha:.7f} " + " ".join(f"{v:.7f}" for v in box) + " "
                         + " ".join(f"{v:.7f}" for v in dim) + " "
                         + " ".join(f"{v:.7f}" for v in loc) + f" {ori:.7f} {score:.7f}")
            rows.append([0, alpha, *box, *dim, *loc, ori, score])
        with open(os.path.join(rd2, f"{img}.txt"), "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
        stage2_rows[img] = np.asarray(rows).reshape(-1, 14)

    # ---- 5. KITTI AP + matched depth MAE, both stages ----
    results = {}
    for tag, rdir in (("stage1", rd1), ("stage2", rd2)):
        _, ret = kitti_eval.evaluate_from_files(gd, rdir, split, 0, metric="R40")
        results[tag] = {k: round(float(v), 3) for k, v in ret.items()}
    errs1, errs2, n_dets = [], [], 0
    for img in ids:
        dets1, objs = stage1_rows[img]
        n_dets += len(dets1)
        errs1 += matched_depth_errors(dets1, objs)
        errs2 += matched_depth_errors(stage2_rows[img], objs)
    mae1 = float(np.mean(errs1)) if errs1 else float("nan")
    mae2 = float(np.mean(errs2)) if errs2 else float("nan")
    wall = time.time() - t0
    device_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    md = [
        "# Two-stage artifact of the PyTorch port: trained DGDE -> gen_data -> trained GMW -> "
        "KITTI AP",
        "",
        f"`python -m dcd_tpu_torch.tools.two_stage_artifact --ckpt {args.ckpt} --pool {args.pool} "
        f"--epochs {args.epochs} --reg_start {args.reg_start}` on {device_name}: the reference",
        "pipeline (README.md:39-63) on synthetic data: stage 1 restored from the port's",
        f"convergence-run checkpoint, gen_data over the {args.pool}-scene train pool "
        f"({n_train_objs} objects),",
        f"the GMW trained {args.epochs} epochs ({gmw_steps} steps; cls->reg flip at "
        f"{args.reg_start}, GMW/main.py:312-315),",
        "depths refined and locations rescaled (GMW/main.py:540-548) on "
        f"{args.val_scenes} held-out scenes",
        f"({n_dets} stage-1 detections), scored by the KITTI evaluator.",
        "",
        "| metric (Car moderate R40) | stage 1 | stage 2 (GMW-refined) |",
        "|---|---|---|",
    ]
    for label, key in AP_KEYS:
        md.append(f"| {label} | {results['stage1'][key]:.2f} | {results['stage2'][key]:.2f} |")
    md += [f"| depth MAE of 2D-matched dets (m) | {mae1:.3f} | {mae2:.3f} |", "",
           f"matched detections: {len(errs1)} (stage 1) / {len(errs2)} (stage 2); "
           f"wall {wall:.0f}s"]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(md) + "\n")
    print("\n".join(md))
    moved = abs(mae2 - mae1) > 1e-6 or any(results["stage2"][k] != results["stage1"][k]
                                           for _, k in AP_KEYS)
    print(f"\nRESULT: stage2 {'moved metrics' if moved else 'DID NOT move metrics'}; "
          f"depth MAE {mae1:.3f} -> {mae2:.3f}")
    depths = {img: (stage1_rows[img][0][:, 11], stage2_rows[img][:, 11]) for img in ids}
    return dict(results=results, mae=(mae1, mae2), matched=(len(errs1), len(errs2)), depths=depths,
                n_train_objs=n_train_objs, n_dets=n_dets, gmw_steps=gmw_steps, moved=moved,
                wall=wall, md=md)


def main(argv: Optional[List[str]] = None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
