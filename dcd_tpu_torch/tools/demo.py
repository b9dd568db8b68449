"""Single-image demo of the port: DGDE inference on one image, the detections
drawn on it.

The twin of the JAX package's ``tools/demo.py``: the same flags, and
``--device`` (``cuda`` unless asked for ``cpu``; with no card it raises).

    python -m dcd_tpu_torch.tools.demo --image 000001.png --calib 000001.txt \\
        --ckpt logs/ckpt --out demo.png [--bev bev.png]
    python -m dcd_tpu_torch.tools.demo --synthetic 3 --out demo.png   # no data needed

``--ckpt`` is a checkpoint of the port: a file, or a checkpoint directory
whose ``last_checkpoint`` names one (as the JAX demo reads its checkpoint
directory). An orbax checkpoint of the JAX package raises. Without it the
detector keeps random weights drawn from seed 0 (the port's draw, not JAX's).
The forward is the dense-head one the JAX demo runs (no lazy top-K).
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import dgde_run_config, load_yaml_config
from ..data.kitti_geometry import Calibration
from ..data.synthetic import make_scene
from ..data.target_encoder import encode_targets
from ..engine.infer import build_detector, postprocess
from ..utils.checkpoint import Checkpointer
from ..utils.visualize import draw_bev, draw_detections


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="DGDE demo on the port")
    p.add_argument("--image", default=None)
    p.add_argument("--calib", default=None)
    p.add_argument("--synthetic", type=int, default=None, help="render a synthetic scene by seed")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--config", default=None)
    p.add_argument("--out", default="demo.png")
    p.add_argument("--bev", default=None)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p.parse_args(argv)


def load_checkpoint(model: torch.nn.Module, path: str) -> str:
    """The weights of ``path`` (a checkpoint file, or a directory whose
    ``last_checkpoint`` names one) into ``model``; returns the file read."""
    ckptr = Checkpointer(path if os.path.isdir(path) else os.path.dirname(os.path.abspath(path)))
    if os.path.isdir(path) and ckptr.has_checkpoint():
        path = ckptr.last_checkpoint()
    path = ckptr.resolve(path)  # an orbax directory raises here
    ckptr.load_model(model, path)
    return path


def run(args: argparse.Namespace) -> Dict:
    """Detect and draw. Returns the rows (numpy), their validity, the image
    and the files written."""
    cfg = dgde_run_config()
    if args.config:
        cfg = load_yaml_config(args.config, base=cfg)

    if args.synthetic is not None:
        img, _, calib = make_scene(seed=args.synthetic, num_objs=6)
    else:
        from PIL import Image

        img = np.asarray(Image.open(args.image).convert("RGB"))
        calib = Calibration.from_kitti_file(args.calib)

    model = build_detector(cfg, device=args.device, seed=0)
    if args.ckpt:
        load_checkpoint(model, args.ckpt)

    s = encode_targets(img, None, calib, cfg, is_train=False)
    t = s.targets
    dev = next(model.parameters()).device

    def tensor(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x)[None], dtype=dtype, device=dev)

    with torch.no_grad():
        preds = model(tensor(s.image), tensor(t["edge_indices"], torch.long),
                      tensor(t["edge_len"], torch.long))
        out = postprocess(cfg, preds, tensor(t["calib_P_full"]), tensor(t["pad_size"]),
                          tensor(t["image_size"]))
    dets = out["dets"][0].cpu().numpy()
    valid = out["valid"][0].cpu().numpy()
    print(f"{int(valid.sum())} detections above threshold {cfg.test.detections_threshold}")
    written = [args.out]
    draw_detections(img, dets, valid, calib).save(args.out)
    print("wrote", args.out)
    if args.bev:
        draw_bev(dets, valid).save(args.bev)
        print("wrote", args.bev)
        written.append(args.bev)
    return dict(dets=dets, valid=valid, image=img, written=written)


def main(argv: Optional[List[str]] = None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
