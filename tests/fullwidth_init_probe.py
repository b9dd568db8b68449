"""The step-0 heat map of the JAX package's ``model.init`` against the port's
seeded initialisation (``build_trainer``) at the shipped widths and depth: a
script, not collected by pytest.

Both packages take ``dgde_run_config()`` with the convergence tools' settings
(pretrain off; fp32 unless ``--bf16``) and the first two scenes of the
convergence pool (``make_scene(seed=s, num_objs=8)``, s = 0, 1). For each seed
the script prints hm_loss and dims_loss, the number of positives, and the
class logits' mean and spread at the heat map's positives and over all
pixels, with ``EdgeFusion`` on and off (off: no boundary ring is passed).
``--res H W`` cuts the input (384 1280 by default) to keep the CPU's memory
small: the widths and the depth stay the shipped ones.

    JAX_PLATFORMS=cpu python tests/fullwidth_init_probe.py --seeds 0 1 2 3 --res 192 640
"""
import argparse
import dataclasses
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]
from torch_port_common import with_dcn  # noqa: E402

from dcd_tpu.config import dgde_run_config as jax_dgde_run_config  # noqa: E402
from dcd_tpu.data import synthetic as jsyn  # noqa: E402
from dcd_tpu.data.target_encoder import collate as jcollate, encode_targets as jencode  # noqa: E402
from dcd_tpu.engine.loss import compute_losses as jloss  # noqa: E402
from dcd_tpu.engine.train import build_model  # noqa: E402
from dcd_tpu_torch.config import dgde_run_config  # noqa: E402
from dcd_tpu_torch.engine.loss import compute_losses  # noqa: E402
from dcd_tpu_torch.engine.train import batch_to_device, build_trainer  # noqa: E402
from dcd_tpu_torch.tools.convergence_run import run_config  # noqa: E402


def jax_run_config(accum=2):
    """tools/convergence_run.py's configuration (its :65-73), fp32."""
    cfg = jax_dgde_run_config()
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, fp16=False, pretrain=False),
        solver=dataclasses.replace(cfg.solver, lr_warmup=True, warmup_steps=100, base_lr=3e-4,
                                   grad_accum_steps=accum),
    )


def with_res(cfg, H, W):
    return dataclasses.replace(cfg, input=dataclasses.replace(cfg.input, height_train=H,
                                                              width_train=W))


def stats(cls, hm_target):
    """Logit mean and spread at the positives and over every pixel."""
    p = np.clip(np.asarray(cls, np.float64), 1e-6, 1 - 1e-6)
    logit = np.log(p / (1 - p))
    pos = np.asarray(hm_target) == 1.0
    return dict(pos_mean=logit[pos].mean(), pos_std=logit[pos].std(), all_mean=logit.mean(),
                all_std=logit.std(), mean_sigmoid=p.mean())


def fmt(d):
    return " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in d.items())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--res", type=int, nargs=2, default=[384, 1280])
    ap.add_argument("--scenes", type=int, default=2)
    ap.add_argument("--bf16", action="store_true", help="bf16 activations in both packages")
    args = ap.parse_args()
    H, W = args.res
    jcfg = jax_run_config()
    jcfg = with_dcn(with_res(dataclasses.replace(
        jcfg, model=dataclasses.replace(jcfg.model, fp16=args.bf16)), H, W), "gather")
    tcfg = run_config(accum=2)
    tcfg = with_dcn(with_res(dataclasses.replace(
        tcfg, model=dataclasses.replace(tcfg.model, fp16=args.bf16)), H, W), "dense")
    batch = jcollate([jencode(*jsyn.make_scene(seed=s, num_objs=8), jcfg, img_id=f"{s:06d}")
                      for s in range(args.scenes)])
    hm_t = np.transpose(batch["hm"], (0, 2, 3, 1))
    print(f"# {args.scenes} scenes at {H}x{W}, {'bf16' if args.bf16 else 'fp32'}, "
          f"positives {(hm_t == 1).sum()}", flush=True)
    jb = {k: jnp.asarray(v) for k, v in batch.items() if not isinstance(v, list)}
    tb = batch_to_device({k: v for k, v in batch.items() if not isinstance(v, list)},
                         torch.device("cpu"))
    model = build_model(jcfg)
    L = (jcfg.output_height + jcfg.output_width) * 2
    init = jax.jit(lambda r: model.init(r, jnp.zeros((1, H, W, 3)), jnp.zeros((1, L, 2), jnp.int32),
                                        jnp.ones((1,), jnp.int32), train=False))

    @jax.jit
    def jfwd(variables, ei, el):
        preds, _ = model.apply(variables, jb["images"], ei, el, train=True, mutable=["batch_stats"])
        _, ld, _ = jloss(jcfg, preds, jb)
        return preds["cls"], ld["hm_loss"], ld["dims_loss"]

    for seed in args.seeds:
        t0 = time.time()
        variables = init(jax.random.PRNGKey(seed))
        for fusion in (True, False):
            ei, el = (jb["edge_indices"], jb["edge_len"]) if fusion else (None, None)
            cls, hm, dims = jfwd(variables, ei, el)
            print(f"jax  seed {seed} fusion {fusion}: hm_loss={float(hm):.4f} "
                  f"dims_loss={float(dims):.4f} {fmt(stats(cls, hm_t))}", flush=True)
        tr = build_trainer(tcfg, "cpu", seed=seed)
        for fusion in (True, False):
            ei, el = (tb["edge_indices"], tb["edge_len"]) if fusion else (None, None)
            with torch.no_grad():
                p = tr.model(tb["images"], ei, el)
                _, ld, _ = compute_losses(tcfg, p, tb)
            print(f"port seed {seed} fusion {fusion}: hm_loss={float(ld['hm_loss']):.4f} "
                  f"dims_loss={float(ld['dims_loss']):.4f} "
                  f"{fmt(stats(p['cls'].float().numpy(), hm_t))}", flush=True)
        print(f"# seed {seed}: {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
