"""Full-size synthetic training run of the port: does the assembled detector
learn?

The twin of the JAX package's ``tools/convergence_run.py``: the same flags
and configuration, ``--device`` (``cuda`` unless asked for ``cpu``; with no
card it raises) and ``--seed`` (the initial weights' seed; 0, the default,
as the JAX run's key), so that runs from several draws show how far one
run's numbers are noise. ``dgde_run_config()`` at full size (384x1280, the
shipped head widths) with bf16 activations (``fp16``), pretrain off,
``remat`` from the flag, warmup of 100 steps to a base LR of 3e-4 and
``--accum`` microbatches per step; a pool of ``--pool`` synthetic scenes
(``make_scene(seed=s, num_objs=8)``) cycled in batches of ``--batch``, and
every ``--eval_every`` steps the KITTI evaluator on a held-out synthetic
split (seeds 10000+, scores from the heatmap alone, one column group per
``--depth_modes`` entry).

    python -m dcd_tpu_torch.tools.convergence_run --steps 300 --batch 16 --accum 2 \\
        --eval_every 300 --save_ckpt build/convergence_ckpt

The loss curve goes to ``--out_jsonl`` through ``utils/writer.py`` (one row
per logged step, the AP rows under ``ap/``), the summary table to
``--out_md``, both under ``build/`` by default. ``--save_ckpt DIR`` saves the
trainer as ``DIR/model_final.pt`` (``utils/checkpoint.py``; trained weights
stay out of git). The JAX package's run is ``docs/CONVERGENCE.md``.
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
from ..data.target_encoder import collate, encode_targets
from ..engine.infer import format_kitti_lines, infer
from ..engine.train import batch_to_device, build_trainer, train_step
from ..evaluation import kitti_eval
from ..utils.checkpoint import Checkpointer
from ..utils.writer import MetricWriter

OUT_DIR = os.path.join("build", "convergence_run")
VAL_SEED0 = 10_000


def run_config(accum: int = 1, remat: bool = False, base: Optional[Config] = None) -> Config:
    """The JAX tool's configuration (its :65-73) over ``base`` (by default
    ``dgde_run_config()``)."""
    cfg = dgde_run_config() if base is None else base
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, fp16=True, pretrain=False, remat=remat),
        solver=dataclasses.replace(cfg.solver, lr_warmup=True, warmup_steps=100, base_lr=3e-4,
                                   grad_accum_steps=accum),
    )


def make_batches(cfg: Config, pool: int, batch: int, **scene_kw) -> List[Dict[str, np.ndarray]]:
    """The pool of encoded synthetic scenes in collated batches, in order."""
    samples = [encode_targets(*synthetic.make_scene(seed=s, num_objs=8, **scene_kw), cfg,
                              img_id=f"{s:06d}") for s in range(pool)]
    return [{k: v for k, v in collate(samples[lo:lo + batch]).items() if not isinstance(v, list)}
            for lo in range(0, pool, batch)]


def _label_line(ob) -> str:
    return (f"Car {ob.truncation:.2f} {ob.occlusion} {ob.alpha:.2f} "
            f"{ob.box2d[0]:.2f} {ob.box2d[1]:.2f} {ob.box2d[2]:.2f} {ob.box2d[3]:.2f} "
            f"{ob.h:.2f} {ob.w:.2f} {ob.l:.2f} "
            f"{ob.t[0]:.2f} {ob.t[1]:.2f} {ob.t[2]:.2f} {ob.ry:.2f}\n")


class Evaluator:
    """The official evaluator on a held-out synthetic split, per depth mode.
    Scores are the heatmap's alone: the shipped score multiplies by
    1 - clip(estimated depth error, 0.01, 1), which is 0 until the depth
    uncertainties train below 1 m, so it would hide all learning of a short
    synthetic run (as the JAX tool notes)."""

    def __init__(self, cfg: Config, val_scenes: int, depth_modes: List[str], **scene_kw):
        eval_cfg = dataclasses.replace(
            cfg, test=dataclasses.replace(cfg.test, uncertainty_as_confidence=False))
        self.modes = depth_modes
        self.cfgs = {m: dataclasses.replace(eval_cfg, model=dataclasses.replace(
            eval_cfg.model, head=dataclasses.replace(eval_cfg.model.head, output_depth=m)))
            for m in depth_modes}
        self.raw = [synthetic.make_scene(seed=VAL_SEED0 + s, num_objs=8, **scene_kw)
                    for s in range(val_scenes)]
        self.samples = [encode_targets(img, objs, calib, cfg, img_id=f"{VAL_SEED0 + s:06d}")
                        for s, (img, objs, calib) in enumerate(self.raw)]

    def __call__(self, model, step: int) -> dict:
        tmp = tempfile.mkdtemp()
        try:
            gd = os.path.join(tmp, "g")
            rds = {m: os.path.join(tmp, f"r_{m}") for m in self.modes}
            for d in (gd, *rds.values()):
                os.makedirs(d)
            n_valid, max_score = 0, 0.0
            was_training = model.training
            model.eval()
            with torch.no_grad():
                for s, (_, objs, _) in zip(self.samples, self.raw):
                    t = s.targets
                    args = [torch.from_numpy(np.asarray(a)[None]) for a in
                            (s.image, t["edge_indices"], t["edge_len"])]
                    args[1], args[2] = args[1].long(), args[2].long()
                    post = [torch.from_numpy(np.asarray(t[k], np.float32)[None])
                            for k in ("calib_P_full", "pad_size", "image_size")]
                    for m in self.modes:
                        out = infer(model, *args, *post, cfg=self.cfgs[m])
                        dets, valid = out["dets"][0].cpu().numpy(), out["valid"][0].cpu().numpy()
                        if m == self.modes[0]:
                            n_valid += int(valid.sum())
                            if dets.shape[0]:
                                max_score = max(max_score, float(dets[:, 13].max()))
                        with open(os.path.join(rds[m], f"{s.img_id}.txt"), "w") as f:
                            f.write("\n".join(format_kitti_lines(dets, valid)) + "\n")
                    with open(os.path.join(gd, f"{s.img_id}.txt"), "w") as f:
                        f.writelines(_label_line(ob) for ob in objs)
            model.train(was_training)
            split = os.path.join(tmp, "val.txt")
            with open(split, "w") as f:
                f.write("\n".join(s.img_id for s in self.samples))
            rec = {"step": step, "n_valid": n_valid, "max_raw_score": round(max_score, 4)}
            for m in self.modes:
                _, ret = kitti_eval.evaluate_from_files(gd, rds[m], split, 0, metric="R40")
                sfx = "" if m == self.modes[0] else f"_{m}"
                rec[f"ap_bbox_mod{sfx}"] = round(float(ret["Car_image/moderate"]), 3)
                rec[f"ap_bev_mod_05{sfx}"] = round(float(ret["Car_bev_moderate_R40_0.50"]), 3)
                rec[f"ap_3d_mod_05{sfx}"] = round(float(ret["Car_3d_moderate_R40_0.50"]), 3)
                rec[f"ap_bev_mod_07{sfx}"] = round(float(ret["Car_bev_moderate_R40_0.70"]), 3)
                rec[f"ap_3d_mod_07{sfx}"] = round(float(ret["Car_3d_moderate_R40_0.70"]), 3)
        finally:
            shutil.rmtree(tmp)
        print(f"#   eval@{step}: {rec}", file=sys.stderr)
        return rec


def summary(args, hist, ap_hist, wall, device_name) -> List[str]:
    """The table of docs/CONVERGENCE.md's layout."""
    first, last = hist[0], hist[-1]
    keys = [k for k in last if k.endswith("_MAE") or k.endswith("IoU")] + [
        "total_loss", "hm_loss", "depth_loss", "keypoint_loss", "orien_loss"]
    md = [
        "# Convergence: full-size synthetic training run of the PyTorch port",
        "",
        f"`python -m dcd_tpu_torch.tools.convergence_run --steps {args.steps} --batch {args.batch} "
        f"--accum {args.accum} --pool {args.pool}{' --remat' if args.remat else ''}` on "
        f"{device_name}: full 384x1280 input, shipped head widths, bf16 activations, pretrain "
        f"off. Raw curves: {args.out_jsonl}.",
        "",
        f"- wall: {wall:.0f}s for {args.steps} steps "
        f"({args.steps * args.batch / wall:.1f} img/s incl. logging and evaluation)",
        "",
        f"| metric | step 0 | step {last['step']} |",
        "|---|---|---|",
    ]
    for k in sorted(set(keys)):
        if k in first and k in last:
            md.append(f"| {k} | {first[k]:.4f} | {last[k]:.4f} |")
    if ap_hist:
        modes = [m.strip() for m in args.depth_modes.split(",") if m.strip()]
        md += ["", "## Official-evaluator AP trajectory (held-out synthetic val, moderate)", "",
               f"OUTPUT_DEPTH mode of the headline columns: **{modes[0]}**.", "",
               "| step | bbox | bev@0.5 | 3d@0.5 | bev@0.7 | 3d@0.7 |"
               + "".join(f" 3d@0.5 ({m}) | 3d@0.7 ({m}) |" for m in modes[1:])
               + " n_valid dets | max score |",
               "|---|---|---|---|---|---|" + "---|---|" * len(modes[1:]) + "---|---|"]
        for rec in ap_hist:
            extra = "".join(f" {rec[f'ap_3d_mod_05_{m}']:.2f} | {rec[f'ap_3d_mod_07_{m}']:.2f} |"
                            for m in modes[1:])
            md.append(f"| {rec['step']} | {rec['ap_bbox_mod']:.2f} | {rec['ap_bev_mod_05']:.2f} "
                      f"| {rec['ap_3d_mod_05']:.2f} | {rec['ap_bev_mod_07']:.2f} "
                      f"| {rec['ap_3d_mod_07']:.2f} |" + extra
                      + f" {rec['n_valid']} | {rec['max_raw_score']:.2f} |")
    loss_ok = last["total_loss"] < first["total_loss"]
    md += ["", f"**total_loss {'decreased' if loss_ok else 'DID NOT decrease'}: "
           f"{first['total_loss']:.3f} -> {last['total_loss']:.3f}**", ""]
    if ap_hist:
        md += [f"**detection emergence: n_valid {ap_hist[0]['n_valid']} -> "
               f"{ap_hist[-1]['n_valid']}, max score {ap_hist[0]['max_raw_score']:.2f} -> "
               f"{ap_hist[-1]['max_raw_score']:.2f}**", ""]
    return md


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="full-size synthetic training run of the port")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--pool", type=int, default=64)
    ap.add_argument("--log_every", type=int, default=10)
    ap.add_argument("--accum", type=int, default=1, help="gradient-accumulation microbatches")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--eval_every", type=int, default=0,
                    help="every N steps (and at the end) the KITTI evaluator on a held-out "
                    "synthetic split")
    ap.add_argument("--val_scenes", type=int, default=16)
    ap.add_argument("--depth_modes", default="edges",
                    help="comma list of OUTPUT_DEPTH modes evaluated at each AP checkpoint")
    ap.add_argument("--save_ckpt", default=None,
                    help="checkpoint directory; saves model_final at the end")
    ap.add_argument("--out_md", default=os.path.join(OUT_DIR, "CONVERGENCE.md"))
    ap.add_argument("--out_jsonl", default=os.path.join(OUT_DIR, "metrics.jsonl"))
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=0, help="the initial weights' seed")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, cfg: Optional[Config] = None, **scene_kw) -> dict:
    """The run of ``args`` on ``cfg`` (by default :func:`run_config` of the
    flags); ``scene_kw`` goes to ``make_scene`` (the tests shrink the
    scenes). Returns the logged rows, the AP rows and the wall seconds."""
    cfg = run_config(args.accum, args.remat) if cfg is None else cfg
    print(f"# encoding {args.pool} scenes...", file=sys.stderr)
    batches = make_batches(cfg, args.pool, args.batch, **scene_kw)
    trainer = build_trainer(cfg, args.device, seed=args.seed, iters_per_epoch=len(batches))
    batches = [batch_to_device(b, trainer.device) for b in batches]  # the pool stays on the card
    device_name = (torch.cuda.get_device_name(trainer.device) if trainer.device.type == "cuda"
                   else "cpu")
    modes = [m.strip() for m in args.depth_modes.split(",") if m.strip()]
    evaluate = Evaluator(cfg, args.val_scenes, modes, **scene_kw) if args.eval_every else None
    ckptr = Checkpointer(args.save_ckpt) if args.save_ckpt else None

    # the writer appends to DIR/metrics.jsonl; the run starts the file anew
    jsonl_dir = os.path.dirname(os.path.abspath(args.out_jsonl))
    written = os.path.join(jsonl_dir, "metrics.jsonl")
    if os.path.exists(written):
        os.remove(written)
    writer = MetricWriter(jsonl_dir, use_tensorboard=False)
    hist, ap_hist = [], []
    t0 = time.perf_counter()
    try:
        for it in range(args.steps):
            if evaluate is not None and it % args.eval_every == 0:
                ap_hist.append(evaluate(trainer.model, it))
                if ckptr is not None and it > 0:
                    ckptr.save("model_final", trainer)  # a lost machine keeps the weights
            logs = train_step(trainer, batches[it % len(batches)])
            if it % args.log_every == 0 or it == args.steps - 1:
                rec = {"step": it, **{k: round(float(v), 5) for k, v in logs.items()}}
                hist.append(rec)
                writer.write_scalars(it, {k: v for k, v in rec.items() if k != "step"})
                print(f"step {it}: total={rec['total_loss']:.3f} "
                      f"edges_MAE={rec.get('edges_MAE', float('nan')):.3f}", file=sys.stderr)
                if not np.isfinite(rec["total_loss"]):
                    raise FloatingPointError(f"non-finite loss at step {it}: {rec}")
        if evaluate is not None:
            ap_hist.append(evaluate(trainer.model, args.steps))
            for rec in ap_hist:
                writer.write_scalars(rec["step"], {k: v for k, v in rec.items() if k != "step"},
                                     prefix="ap/")
    finally:
        writer.close()
    if os.path.abspath(args.out_jsonl) != written:
        os.replace(written, args.out_jsonl)
    wall = time.perf_counter() - t0
    if ckptr is not None:
        ckptr.save("model_final", trainer)
        print(f"# saved checkpoint to {args.save_ckpt}/model_final", file=sys.stderr)
    md = summary(args, hist, ap_hist, wall, device_name)
    os.makedirs(os.path.dirname(os.path.abspath(args.out_md)), exist_ok=True)
    with open(args.out_md, "w") as f:
        f.write("\n".join(md) + "\n")
    return dict(hist=hist, ap=ap_hist, wall=wall, trainer=trainer, md=md)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    out = run(args)
    hist, ap_hist = out["hist"], out["ap"]
    first, last = hist[0], hist[-1]
    ok = last["total_loss"] < first["total_loss"]
    if ap_hist:
        # learning shows: detections appear or the AP rises over the run
        ok = ok and (ap_hist[-1]["n_valid"] > ap_hist[0]["n_valid"]
                     or ap_hist[-1]["ap_bbox_mod"] > ap_hist[0]["ap_bbox_mod"])
    print(json.dumps({"steps": args.steps, "first_loss": first["total_loss"],
                      "last_loss": last["total_loss"], "wall_sec": round(out["wall"], 1),
                      "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
