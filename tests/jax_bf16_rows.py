"""bf16 against fp32 inference of the JAX package on its own trained
weights: JAX's number beside the port's ``dcd_tpu_torch/tools/bf16_rows.py``.

    JAX_PLATFORMS=cpu python tests/jax_bf16_rows.py [--ckpt runs_ckpt_r5] [--scenes 16]

Loads the committed orbax checkpoint of the JAX package's convergence run
into ``create_train_state``'s template (with ``pretrain`` off, so that
nothing is fetched), runs the inference forward with the lazy top-K heads and
``postprocess`` in fp32 and in bf16 on the held-out synthetic scenes of the
convergence tools (seeds 10000+, 8 cars), heat-map scores at detection
threshold 0, with the DCN in its clamped dense form (the function of the
TPU kernel and of the port's), and prints the port tool's comparison
(``bf16_rows.compare``) as one JSON object.
"""

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dcd_tpu.config import dgde_run_config  # noqa: E402
from dcd_tpu.data import synthetic  # noqa: E402
from dcd_tpu.data.target_encoder import collate, encode_targets  # noqa: E402
from dcd_tpu.engine.infer import postprocess  # noqa: E402
from dcd_tpu.engine.train import build_model, create_train_state  # noqa: E402
from dcd_tpu.utils.checkpoint import Checkpointer  # noqa: E402
from dcd_tpu_torch.config import dgde_run_config as port_dgde_run_config  # noqa: E402
from dcd_tpu_torch.tools.bf16_rows import ROW_TOLS, compare  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default="runs_ckpt_r5")
    ap.add_argument("--scenes", type=int, default=16)
    args = ap.parse_args()

    base = dgde_run_config()
    cfg = dataclasses.replace(
        base,
        model=dataclasses.replace(base.model, pretrain=False, backbone=dataclasses.replace(
            base.model.backbone, dcn_impl="dense")),
        test=dataclasses.replace(base.test, uncertainty_as_confidence=False,
                                 detections_threshold=0.0))
    _, state = create_train_state(cfg, jax.random.PRNGKey(0))
    state = Checkpointer(args.ckpt).load(state)
    variables = {"params": state.params, "batch_stats": state.batch_stats}

    def forward(fp16):
        model = build_model(dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, fp16=fp16)))

        @jax.jit
        def run(v, images, ei, el, *post):
            preds = model.apply(v, images, ei, el, train=False, lazy_topk=True)
            return preds, postprocess(cfg, preds, *post)
        return run

    runs = {fp16: forward(fp16) for fp16 in (False, True)}
    samples = [encode_targets(*synthetic.make_scene(seed=10_000 + s, num_objs=8), cfg)
               for s in range(args.scenes)]
    port_cfg = port_dgde_run_config()
    as_torch = lambda tree: {k: torch.from_numpy(np.asarray(v).astype(np.float32) if
                                                 np.asarray(v).dtype == jnp.bfloat16 else np.asarray(v))
                             for k, v in tree.items()}
    per_batch = []
    for lo in range(0, len(samples), 4):
        b = collate(samples[lo:lo + 4])
        inputs = [jnp.asarray(b[k]) for k in ("images", "edge_indices", "edge_len")]
        post = [jnp.asarray(np.asarray(b[k], np.float32)) for k in ("calib_P_full", "pad_size", "image_size")]
        outs = {fp16: run(variables, *inputs, *post) for fp16, run in runs.items()}
        per_batch.append(compare(port_cfg, as_torch(outs[False][0]), as_torch(outs[True][0]),
                                 as_torch(outs[False][1]), as_torch(outs[True][1]),
                                 base.test.detections_threshold))
    result = {
        "ckpt": args.ckpt,
        "scenes": args.scenes,
        "cls_max_abs": max(r["cls_max_abs"] for r in per_batch),
        "matched_peaks": float(np.mean([r["matched_peaks"] for r in per_batch])),
        "heads": {k: max(r["heads"][k] for r in per_batch if r["heads"][k] is not None)
                  for k in per_batch[0]["heads"]},
        "rows_median_err": float(np.median(sum((r["rows_errs"] for r in per_batch), []))),
    }
    for tag in ("rows", "confident_rows"):
        n = sum(r[tag] for r in per_batch)
        result[tag] = n
        result[f"{tag}_within"] = {t: sum(r[f"{tag}_within"][t] for r in per_batch) / max(n, 1)
                                   for t in map(str, ROW_TOLS)}
    print(json.dumps(result))


if __name__ == "__main__":
    main()
