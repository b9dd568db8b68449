"""A paired convergence study of the two packages at a size the CPU can train:
a script, not collected by pytest.

Each run trains one arm from one seed with the convergence tools' solver
(warm-up of 100 steps to a base LR of 3e-4, two microbatches per step, the
schedule's epoch of 16 steps as theirs, so that its decays at epochs 80 and
90 fall after the run; both arms take it from ``--iters_per_epoch``) on a
pool of synthetic scenes (``make_scene(seed=s, num_objs=8)``, KITTI-sized
images encoded at ``--res``), then scores the KITTI bbox AP (moderate, R40)
of the held-out scenes 10000+ with ``uncertainty_as_confidence`` off, as
both convergence tools do. The arms:

* ``jax``: the JAX package's ``create_train_state(cfg, PRNGKey(seed))`` and
  ``make_train_step`` under ``jax.jit``, its eval-mode ``postprocess``;
* ``port``: the port's ``build_trainer(cfg, "cpu", seed)`` and ``train_step``,
  its ``infer``;
* ``port_jax_init``: the port from the JAX arm's initial weights at the same
  seed (``utils/weights.py::from_jax_variables``), which removes the draw.

Both packages sample with the clamped DCN: trained offsets leave the clamp,
where the JAX package's unbounded gather form would compute another
function. The port runs its clamped plain form (``dcn_impl="dense"``). The
JAX package's clamped ``dense`` form enumerates 64 shifts per tap, and XLA's
CPU compiler did not finish one train step of it at these widths in 15
minutes and 10 GB, so the JAX arm runs its gather form on offsets clipped to
the window (:func:`clamped_gather`): the dense form's function, its clip
included (:func:`check_clamped_gather` holds the two together, forward and
gradients, on offsets that reach past the clamp). The config is the shipped
one at ``--channels`` and ``--head`` widths. One JSON line per run goes to ``--out``: every step's
hm_loss and total_loss, the AP, valid detections and largest score after
each step of ``--eval_at`` and the last, the wall seconds.

    JAX_PLATFORMS=cpu XLA_FLAGS="--xla_cpu_multi_thread_eigen=false \\
        intra_op_parallelism_threads=1" python tests/convergence_study.py \\
        --arm jax --seed 0 --out build/study.jsonl
    python tests/convergence_study.py --summary build/study.jsonl

``--summary`` prints, per arm, hm_loss over the last 100 steps and the AP as
mean +- standard error over the seeds.
"""
import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

VAL_SEED0 = 10_000
RADIUS = 3  # the clamp of every DCN in both configurations (dcn_radius)


def clamped_gather():
    """Route the JAX package's gather-form DCN through offsets clipped to
    [-RADIUS, RADIUS], as ``deform_conv2d_dense`` clips them; the package's
    files stay as they are."""
    import jax.numpy as jnp

    from dcd_tpu.models import layers

    gather = layers.deform_conv2d

    def clipped(x, offset, *a, **kw):
        return gather(x, jnp.clip(offset, -RADIUS, RADIUS), *a, **kw)

    layers.deform_conv2d = clipped
    return gather


def check_clamped_gather():
    """The clipped gather against ``deform_conv2d_dense`` on offsets of std
    2.5 px (a third of them past the clamp): outputs and gradients within
    1e-5 of their scale."""
    import jax
    import jax.numpy as jnp

    from dcd_tpu.ops.dcn import deform_conv2d, deform_conv2d_dense

    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(1, 9, 11, 4), jnp.float32)
    off = jnp.asarray(rng.randn(1, 9, 11, 18) * 2.5, jnp.float32)
    mask = jnp.asarray(rng.rand(1, 9, 11, 9), jnp.float32)
    w = jnp.asarray(rng.randn(3, 3, 4, 5), jnp.float32)

    def f(fn):
        return lambda x, o, m, w: (fn(x, o, m, w) ** 2).sum()

    gathered = f(lambda x, o, m, w: deform_conv2d(x, jnp.clip(o, -RADIUS, RADIUS), m, w))
    dense = f(lambda x, o, m, w: deform_conv2d_dense(x, o, m, w, radius=RADIUS))
    for a, b in zip(jax.grad(gathered, (0, 1, 2, 3))(x, off, mask, w),
                    jax.grad(dense, (0, 1, 2, 3))(x, off, mask, w)):
        a, b = np.asarray(a), np.asarray(b)
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), np.abs(a - b).max()
    assert abs(float(gathered(x, off, mask, w) - dense(x, off, mask, w))) <= 1e-5 * float(
        dense(x, off, mask, w))


def configs(args):
    """(JAX config, port config): the convergence tools' solver, fp32, the
    clamped DCN, at the study's widths and resolution."""
    from dcd_tpu.config import dgde_run_config as jax_dgde_run_config
    from dcd_tpu_torch.config import dgde_run_config

    out = []
    for make in (jax_dgde_run_config, dgde_run_config):
        cfg = make()
        out.append(dataclasses.replace(
            cfg,
            input=dataclasses.replace(cfg.input, height_train=args.res[0], width_train=args.res[1]),
            model=dataclasses.replace(
                cfg.model, fp16=False, pretrain=False,
                backbone=dataclasses.replace(cfg.model.backbone, channels=tuple(args.channels),
                                             dcn_impl="gather" if make is jax_dgde_run_config
                                             else "dense"),
                head=dataclasses.replace(cfg.model.head, num_channel=args.head)),
            solver=dataclasses.replace(cfg.solver, lr_warmup=True, warmup_steps=100,
                                       base_lr=3e-4, grad_accum_steps=2),
            test=dataclasses.replace(cfg.test, uncertainty_as_confidence=False),
        ))
    return out


def data(jcfg, args):
    """The pool's batches and the held-out scenes, encoded by the JAX package
    (the port's encoder gives the same arrays bitwise: test_torch_data.py)."""
    from dcd_tpu.data import synthetic
    from dcd_tpu.data.target_encoder import collate, encode_targets

    kw = dict(num_objs=8, depth_range=tuple(args.depth_range))
    samples = [encode_targets(*synthetic.make_scene(seed=s, **kw), jcfg, img_id=f"{s:06d}")
               for s in range(args.pool)]
    batches = [{k: v for k, v in collate(samples[lo:lo + args.batch]).items()
                if not isinstance(v, list)} for lo in range(0, args.pool, args.batch)]
    raw = [synthetic.make_scene(seed=VAL_SEED0 + s, **kw) for s in range(args.val_scenes)]
    val = [encode_targets(img, objs, calib, jcfg, img_id=f"{VAL_SEED0 + s:06d}")
           for s, (img, objs, calib) in enumerate(raw)]
    return batches, val, raw


def bbox_ap(rows, val, raw):
    """KITTI bbox AP (moderate, R40) of per-scene (dets, valid) rows, with the
    port's evaluator (bitwise the JAX package's: test_torch_eval.py)."""
    from dcd_tpu_torch.engine.infer import format_kitti_lines
    from dcd_tpu_torch.evaluation import kitti_eval
    from dcd_tpu_torch.tools.convergence_run import _label_line

    tmp = tempfile.mkdtemp()
    try:
        gd, rd = os.path.join(tmp, "g"), os.path.join(tmp, "r")
        os.makedirs(gd)
        os.makedirs(rd)
        for s, (_, objs, _), (dets, valid) in zip(val, raw, rows):
            with open(os.path.join(rd, f"{s.img_id}.txt"), "w") as f:
                f.write("\n".join(format_kitti_lines(dets, valid)) + "\n")
            with open(os.path.join(gd, f"{s.img_id}.txt"), "w") as f:
                f.writelines(_label_line(ob) for ob in objs)
        split = os.path.join(tmp, "val.txt")
        with open(split, "w") as f:
            f.write("\n".join(s.img_id for s in val))
        _, ret = kitti_eval.evaluate_from_files(gd, rd, split, 0, metric="R40")
        return float(ret["Car_image/moderate"])
    finally:
        shutil.rmtree(tmp)


def jax_variables(jcfg, seed, iters_per_epoch):
    import jax

    from dcd_tpu.engine.train import create_train_state

    return create_train_state(jcfg, jax.random.PRNGKey(seed), iters_per_epoch=iters_per_epoch)


def run_jax(jcfg, args, batches, val, raw):
    import jax
    import jax.numpy as jnp

    from dcd_tpu.engine.infer import postprocess
    from dcd_tpu.engine.train import make_train_step

    check_clamped_gather()
    clamped_gather()
    model, state = jax_variables(jcfg, args.seed, args.iters_per_epoch)
    step = jax.jit(make_train_step(jcfg, model, iters_per_epoch=args.iters_per_epoch),
                   donate_argnums=(0,))
    fwd = jax.jit(lambda p, bs, im, ei, el, cp, ps, sz: postprocess(
        jcfg, model.apply({"params": p, "batch_stats": bs}, im, ei, el, train=False,
                          lazy_topk=jcfg.test.lazy_reg_heads), cp, ps, sz))
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]

    def rows():
        out = []
        for s in val:
            t = s.targets
            o = fwd(state.params, state.batch_stats, jnp.asarray(s.image[None]),
                    *(jnp.asarray(t[k][None]) for k in ("edge_indices", "edge_len",
                                                         "calib_P_full", "pad_size",
                                                         "image_size")))
            out.append((np.asarray(o["dets"])[0], np.asarray(o["valid"])[0]))
        return out

    hist, evals = [], []
    for it in range(args.steps):
        state, logs = step(state, jb[it % len(jb)])
        hist.append({k: float(logs[k]) for k in ("hm_loss", "total_loss")})
        if it + 1 in args.eval_at or it + 1 == args.steps:
            evals.append(evaluation(it + 1, rows(), val, raw))
    return hist, evals


def run_port(jcfg, tcfg, args, batches, val, raw, from_jax):
    import torch

    from dcd_tpu_torch.engine.infer import infer
    from dcd_tpu_torch.engine.train import batch_to_device, build_trainer, train_step
    from dcd_tpu_torch.utils.weights import from_jax_variables, load_state

    torch.set_num_threads(1)
    cpu = torch.device("cpu")
    trainer = build_trainer(tcfg, "cpu", seed=args.seed, iters_per_epoch=args.iters_per_epoch)
    if from_jax:
        _, state = jax_variables(jcfg, args.seed, args.iters_per_epoch)
        load_state(trainer.model, from_jax_variables(
            {"params": state.params, "batch_stats": state.batch_stats}, tcfg))
    tb = [batch_to_device(b, cpu) for b in batches]

    def rows():
        trainer.model.eval()
        out = []
        for s in val:
            t = s.targets
            a = [torch.from_numpy(np.asarray(x)[None]) for x in
                 (s.image, t["edge_indices"], t["edge_len"])]
            a[1], a[2] = a[1].long(), a[2].long()
            post = [torch.from_numpy(np.asarray(t[k], np.float32)[None])
                    for k in ("calib_P_full", "pad_size", "image_size")]
            o = infer(trainer.model, *a, *post, cfg=tcfg)
            out.append((o["dets"][0].numpy(), o["valid"][0].numpy()))
        trainer.model.train()
        return out

    hist, evals = [], []
    for it in range(args.steps):
        logs = train_step(trainer, tb[it % len(tb)])
        hist.append({k: float(logs[k]) for k in ("hm_loss", "total_loss")})
        if it + 1 in args.eval_at or it + 1 == args.steps:
            evals.append(evaluation(it + 1, rows(), val, raw))
    return hist, evals


def evaluation(step, rows, val, raw):
    rec = dict(step=step, ap_bbox=bbox_ap(rows, val, raw),
               n_valid=int(sum(int(v.sum()) for _, v in rows)),
               max_score=float(max(float(d[:, 13].max()) for d, _ in rows)))
    print(json.dumps(rec), flush=True)
    return rec


def summary(path):
    runs = [json.loads(line) for line in open(path) if line.strip()]
    for arm in ("jax", "port", "port_jax_init"):
        rs = [r for r in runs if r["arm"] == arm]
        if not rs:
            continue
        se = (lambda x: x.std(ddof=1) / np.sqrt(len(x)) if len(x) > 1 else float("nan"))
        hm = np.array([np.mean(r["hm_loss"][-100:]) for r in rs])
        print(f"{arm:14s} n={len(rs)} seeds={sorted(r['seed'] for r in rs)} "
              f"hm_loss(last 100)={hm.mean():.4f}+-{se(hm):.4f} "
              f"cpu s={np.mean([r['seconds'] for r in rs]):.0f}; per seed hm",
              [round(h, 4) for h in hm])
        for i, e in enumerate(rs[0]["evals"]):
            ap = np.array([r["evals"][i]["ap_bbox"] for r in rs])
            print(f"    step {e['step']}: bbox AP={ap.mean():.3f}+-{se(ap):.3f} "
                  f"valid={np.mean([r['evals'][i]['n_valid'] for r in rs]):.1f} "
                  f"max score={np.mean([r['evals'][i]['max_score'] for r in rs]):.3f}; per seed",
                  [round(a, 2) for a in ap])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arm", choices=["jax", "port", "port_jax_init"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--pool", type=int, default=64)
    ap.add_argument("--val_scenes", type=int, default=16)
    ap.add_argument("--res", type=int, nargs=2, default=[96, 320])
    ap.add_argument("--channels", type=int, nargs=6, default=[8, 8, 16, 16, 32, 32])
    ap.add_argument("--head", type=int, default=32)
    ap.add_argument("--depth_range", type=float, nargs=2, default=[8.0, 55.0],
                    help="the scenes' object distances in metres (make_scene's default)")
    ap.add_argument("--iters_per_epoch", type=int, default=16,
                    help="the LR schedule's epoch (its decays at epochs 80 and 90): the "
                    "convergence tools' 256 / 16, so that no decay falls inside the run")
    ap.add_argument("--eval_at", type=int, nargs="*", default=[300],
                    help="steps after which to score the AP, besides the last")
    ap.add_argument("--out", default=os.path.join("build", "convergence_study.jsonl"))
    ap.add_argument("--summary", default=None, help="print the summary of a --out file")
    args = ap.parse_args()
    if args.summary:
        summary(args.summary)
        return
    t0 = time.time()
    jcfg, tcfg = configs(args)
    batches, val, raw = data(jcfg, args)
    if args.arm == "jax":
        hist, evals = run_jax(jcfg, args, batches, val, raw)
    else:
        hist, evals = run_port(jcfg, tcfg, args, batches, val, raw, args.arm == "port_jax_init")
    rec = dict(arm=args.arm, seed=args.seed, steps=args.steps, res=args.res,
               depth_range=args.depth_range, iters_per_epoch=args.iters_per_epoch,
               channels=args.channels, head=args.head, batch=args.batch, pool=args.pool,
               evals=evals, seconds=time.time() - t0,
               hm_loss=[h["hm_loss"] for h in hist], total_loss=[h["total_loss"] for h in hist])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(json.dumps({k: v for k, v in rec.items() if k not in ("hm_loss", "total_loss")}))
    sys.stdout.flush()


if __name__ == "__main__":
    main()
