"""How far the JAX package's own two-stage chain moves under rounding-size
changes: the measurement behind the limits of
``tests/test_torch_gen.py::test_slice_end_to_end_matches_jax``.

The chain is the test's: the small DGDE configuration's gen step and
inference rows (detection threshold 0) on two synthetic scenes, from shared
calibrated weights -> train JSON -> 2 GMW train steps (16 features, depth 2,
top-64) -> infer JSON -> ``make_gmw_predict`` -> ``rescale_location``.
It is run on the unperturbed inputs, with the images multiplied by
(1 + 1e-6 randn) and with every weight (the DGDE variables and the GMW's
initial parameters) multiplied by (1 + 1e-7 randn), a few draws each. The
refined depths of the objects matched by 2D box centre are compared with
the unperturbed run's, as the test compares the port's with JAX's.

    JAX_PLATFORMS=cpu python tests/conditioning_probe.py [--draws 3] [--out runs.npz]

XLA's CPU thread count is fixed when JAX starts, so a run at one thread is
a second process:

    JAX_PLATFORMS=cpu XLA_FLAGS="--xla_cpu_multi_thread_eigen=false \\
        intra_op_parallelism_threads=1" python tests/conditioning_probe.py \\
        --draws 0 --out one_thread.npz
    JAX_PLATFORMS=cpu python tests/conditioning_probe.py --draws 3 --compare one_thread.npz

Prints one line per run: the largest change of a refined depth in metres
and as a share of the largest refined depth (the test's scale).

``--train`` measures instead the limits of
``tests/test_torch_train.py::test_one_step_matches_make_grad_fn`` and
``::test_grad_accum_matches_microbatch_composition``: the port's own
``compute_gradients`` on that test's weights and microbatch (the small
configuration cut to 8 DCN blocks) at torch's default thread count against
one intra-op thread, and against the same step with every weight multiplied
by (1 + 1e-7 randn); per draw it prints the largest relative change of each
kind that the test holds (loss terms, pair terms, gradients, those of each
part of the network, pair heads by relative Frobenius norm), the number of
gradients that move by over 5e-3 of their scale, and each part's gradients
as one vector by relative Frobenius norm.

    JAX_PLATFORMS=cpu python tests/conditioning_probe.py --train --draws 3

``--steps`` measures the limits of
``tests/test_torch_train.py::test_convergence_solver_steps_match_jax``: four
steps of the convergence tools' solver from the JAX package's initial weights
(``model.init``) of that test's configuration, the port's
own run under one intra-op thread against torch's default and under every
weight times (1 + 1e-7 randn), then the port against JAX; per run the
largest relative change of each step's loss terms, of the BN running
statistics after the last step and of the eval-mode rows then.

    JAX_PLATFORMS=cpu python tests/conditioning_probe.py --steps --draws 3
"""

import argparse
import dataclasses
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dcd_tpu.data import gen_data  # noqa: E402
from dcd_tpu.data import synthetic  # noqa: E402
from dcd_tpu.data.target_encoder import collate, encode_targets  # noqa: E402
from dcd_tpu.engine import gmw_train  # noqa: E402
from dcd_tpu.engine.gen import make_gen_step  # noqa: E402
from dcd_tpu.engine.infer import postprocess  # noqa: E402
from torch_port_common import calibrated_variables, small_configs  # noqa: E402

B = 2
GCFG = dict(features=16, depth=2, topk=64)


class _Forward:
    def __init__(self, preds):
        self.preds = preds

    def apply(self, *args, **kwargs):
        return self.preds


def _setup():
    jcfg, tcfg = small_configs()
    samples = [encode_targets(*synthetic.make_scene(seed=s, num_objs=3, image_size=(120, 60),
                                                   depth_range=(6.0, 20.0)), jcfg, img_id=f"{s:06d}")
               for s in range(B)]
    batch = collate(samples)
    jmodel, variables = calibrated_variables(jcfg, tcfg, batch["images"].astype(np.float32),
                                             batch["edge_indices"], batch["edge_len"], seed=4)
    jcfg0 = dataclasses.replace(jcfg, test=dataclasses.replace(jcfg.test, detections_threshold=0.0))

    @jax.jit
    def dgde(v, b, *post):
        preds = jmodel.apply(v, b["images"], b["edge_indices"], b["edge_len"], train=False)
        gen = make_gen_step(jcfg, _Forward(preds))(v["params"], v["batch_stats"], b)
        return gen, postprocess(jcfg0, preds, *post)

    gcfg = gmw_train.GMWConfig(num_kpts=jcfg.model.head.num_kpts, **GCFG)
    gm, gstate = gmw_train.create_gmw_state(gcfg, jax.random.PRNGKey(1))
    return dict(jcfg=jcfg, samples=samples, batch=batch, variables=variables, dgde=dgde,
                gcfg=gcfg, gm=gm, gstate=gstate,
                gstep=jax.jit(gmw_train.make_gmw_train_step(gcfg, gm)),
                predict=jax.jit(gmw_train.make_gmw_predict(gcfg, gm)))


def chain(ctx, images, variables, gmw_params):
    """Refined (depth, location) per (image, row) slot and the rows."""
    jcfg, samples, batch = ctx["jcfg"], ctx["samples"], ctx["batch"]
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    b["images"] = jnp.asarray(images)
    post = [jnp.asarray(batch[k]) for k in ("calib_P_full", "pad_size", "image_size")]
    out, rows = ctx["dgde"](variables, b, *post)
    out = {k: np.asarray(v) for k, v in out.items()}
    rows = {k: np.asarray(v) for k, v in rows.items()}
    with tempfile.TemporaryDirectory() as tmp:
        m = out["mask"].astype(bool)
        objs = np.where(m.reshape(-1))[0]
        writer = gen_data.GenDataTrainWriter()
        writer.add_batch(
            gen_data.normalize_batch_kpts(out["kpts_2d_img"][m], objs // jcfg.datasets.max_objects,
                                          [s.calib.P for s in samples]),
            out["kpts_3d"][m], out["pred_rot"][m], out["gt_location"][m], out["pred_location"][m],
            [samples[k // jcfg.datasets.max_objects].img_id for k in objs])
        writer.dump(os.path.join(tmp, "train.json"))
        iw = gen_data.GenDataInferWriter()
        for i, s in enumerate(samples):
            iw.add_image(s.img_id, rows["dets"][i], rows["valid"][i],
                         gen_data.normalize_kpts_2d(rows["kpts_2d"][i], s.calib.P), rows["kpts_3d"][i])
        iw.dump(os.path.join(tmp, "infer.json"))
        train = gen_data.load_gen_data_train(os.path.join(tmp, "train.json"))
        arrays, _ = gen_data.load_gen_data_infer(os.path.join(tmp, "infer.json"))
    n = min(4, train["kpts_2d"].shape[0])
    gb = {"kpts_2d": train["kpts_2d"][:n], "kpts_3d": train["kpts_3d"][:n],
          "pred_rot": train["pred_rot"][:n, 0], "gt_depth": train["gt_location"][:n, 2]}
    state = ctx["gstate"].replace(params=gmw_params)
    for _ in range(2):
        state, _ = ctx["gstep"](state, {k: jnp.asarray(v) for k, v in gb.items()},
                                jnp.float32(1.0), jnp.float32(0.1))
    pb = {"kpts_2d": arrays["kpts_2d"], "kpts_3d": arrays["kpts_3d"],
          "pred_rot": arrays["pred_rot"][:, 0]}
    depth = np.asarray(ctx["predict"](state.params, pb))
    locs = gmw_train.rescale_location(arrays["pred_location"], depth, arrays["dim"])
    slots = [(i, k) for i in range(B) for k in np.nonzero(rows["valid"][i])[0]]
    return {slot: (d, loc) for slot, d, loc in zip(slots, depth, locs)}, rows


def matched_change(a, b):
    """Largest |refined depth change| over the objects matched by box
    centre, the largest refined depth, and how many objects moved by more
    than 1e-4 of it."""
    (ra, rows_a), (rb, rows_b) = a, b
    diffs, scale = [], 0.0
    for i in range(B):
        ct = rows_b["dets"][i][:, 2:6]
        for j, row in enumerate(rows_a["dets"][i]):
            k = int(np.argmin(np.abs(ct - row[2:6]).sum(1)))
            if np.abs(ct[k] - row[2:6]).max() <= 1e-3 and (i, j) in ra and (i, k) in rb:
                diffs.append(abs(float(ra[(i, j)][0]) - float(rb[(i, k)][0])))
                scale = max(scale, abs(float(ra[(i, j)][0])))
    return max(diffs), scale, sum(d > 1e-4 * scale for d in diffs)


def _scaled(tree, rel, rng):
    return jax.tree.map(lambda a: a * (1 + rel * rng.randn(*np.shape(a))).astype(np.float32), tree)


def _step_changes(a, b, pair_prefixes, pair_terms):
    """Largest relative change of each kind between two (logs, grads) of the
    port's step, as the train test measures port against JAX."""
    (la, ga, sa), (lb, gb, sb) = a, b
    out = {"loss": (0.0, ""), "pair_loss": (0.0, ""), "grad_norm": (0.0, ""), "grad": (0.0, ""),
           "pair_heads_fro": (0.0, ""), "bn_stats": (0.0, "")}

    def worse(kind, value, name):
        if value > out[kind][0]:
            out[kind] = (value, name)

    for k, v in lb.items():
        kind = "pair_loss" if k in pair_terms else "grad_norm" if k == "grad_norm" else "loss"
        worse(kind, abs(la[k] - v) / max(abs(v), 1e-30), k)
    for n, want in sb.items():
        worse("bn_stats", float(np.abs(sa[n] - want).max() / max(np.abs(want).max(), 1e-30)), n)
    over, parts = 0, {}
    for n, want in gb.items():
        got = ga[n]
        if n.startswith(pair_prefixes):
            worse("pair_heads_fro", float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)), n)
            continue
        part = "heads" if n.startswith("heads.") else ".".join(n.split(".")[:2])
        parts.setdefault(part, []).append(n)
        if not n.endswith(".bias") or n[: -len("bias")] + "weight" not in gb:
            rel = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
            worse("grad", rel, n)
            worse(f"grad {part}", rel, n) if f"grad {part}" in out else out.update({f"grad {part}": (rel, n)})
            over += rel > 5e-3
    out["grads over 5e-3"] = over
    for part, names in parts.items():
        a = np.concatenate([np.asarray(ga[n], np.float64).ravel() for n in names])
        b = np.concatenate([np.asarray(gb[n], np.float64).ravel() for n in names])
        out[f"fro {part}"] = float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
    return out


def train_probe(draws):
    import torch

    import test_torch_train as T
    from dcd_tpu_torch.engine.train import build_trainer, compute_gradients
    from dcd_tpu_torch.utils.weights import from_jax_variables, load_state
    from torch_port_common import numpy_variables

    jcfg, tcfg = T._configs()
    _, variables = numpy_variables(jcfg, seed=3)
    samples = [encode_targets(*synthetic.make_scene(seed=s, num_objs=3, image_size=(120, 60),
                                                   depth_range=(6.0, 20.0)), jcfg)
               for s in range(2)]
    batch = {k: v[:1] for k, v in collate(samples).items()}
    state = from_jax_variables(variables, tcfg)

    def step(perturb=None):
        trainer = build_trainer(tcfg, device="cpu")
        load_state(trainer.model, state)
        if perturb is not None:
            with torch.no_grad():
                for p_ in trainer.model.parameters():
                    p_.mul_(1 + 1e-7 * torch.from_numpy(perturb.randn(*p_.shape)).float())
        logs = compute_gradients(trainer, batch)
        grads = {n: np.zeros(tuple(p_.shape), np.float32) if p_.grad is None else p_.grad.numpy().copy()
                 for n, p_ in trainer.model.named_parameters()}
        stats = {n: b_.numpy().copy() for n, b_ in trainer.model.named_buffers()
                 if n.endswith(("running_mean", "running_var"))}
        return {k: float(v) for k, v in logs.items()}, grads, stats

    prefixes, terms = T._pair_heads(tcfg), T.PAIR_TERMS
    threads = torch.get_num_threads()
    base = step()
    torch.set_num_threads(1)
    one = step()
    torch.set_num_threads(threads)
    print(f"threads {threads} vs 1: {_step_changes(one, base, prefixes, terms)}", flush=True)
    for d in range(draws):
        for n_threads in (threads, 1):
            torch.set_num_threads(n_threads)
            ref = base if n_threads == threads else one
            got = step(np.random.RandomState(100 + d))
            print(f"draw {d}, {n_threads} thread(s), weights x (1 + 1e-7 randn): "
                  f"{_step_changes(got, ref, prefixes, terms)}", flush=True)
        torch.set_num_threads(threads)


def _steps_changes(a, b):
    """Largest relative change between two runs of the convergence solver's
    steps (logs of each step, BN statistics and rows after the last), as
    ``test_convergence_solver_steps_match_jax`` measures port against JAX.
    ``b`` may be JAX's (its statistics as a flax tree)."""
    (la, sa, ra), (lb, sb, rb) = a, b
    out = {}
    for i, (x, y) in enumerate(zip(la, lb)):
        for k, v in y.items():
            rel = abs(x[k] - v) / max(abs(v), 1e-30)
            key = ("pair terms" if k in PAIR_TERMS_ else k if k in ("grad_norm", "lr")
                   else "loss terms" if k.endswith("_loss") else "metrics")
            if rel > out.get(key, (0.0,))[0]:
                out[key] = (rel, f"step {i} {k}")
    worst = (0.0, "")
    for n, want in sb.items():
        rel = float(np.abs(sa[n] - want).max() / max(np.abs(want).max(), 1e-30))
        worst = max(worst, (rel, n))
    out["bn stats"] = worst
    out["rows"] = float(np.abs(ra["dets"] - rb["dets"]).max() / np.abs(rb["dets"]).max())
    v = rb["valid"]
    out["valid rows"] = (float(np.abs(ra["dets"][v] - rb["dets"][v]).max() / np.abs(rb["dets"][v]).max())
                         if v.any() else None, int(v.sum()))
    out["valid equal"] = bool(np.array_equal(ra["valid"], rb["valid"]))
    return out


PAIR_TERMS_ = set()


def steps_probe(draws):
    """The limits of test_torch_train.py::test_convergence_solver_steps_match_jax:
    the port's own run at torch's default thread count against one intra-op
    thread and against every weight times (1 + 1e-7 randn), then the port
    (one thread, as the test runs) against JAX."""
    import torch

    import test_torch_train as T
    from dcd_tpu_torch.utils.weights import from_jax_variables

    PAIR_TERMS_.update(T.PAIR_TERMS)
    reference = T.jax_reference()
    variables = T.flax_init_variables()
    _, tcfg = T._convergence_configs()
    threads = torch.get_num_threads()
    base = T.port_convergence_steps(reference, variables)
    torch.set_num_threads(1)
    one = T.port_convergence_steps(reference, variables)
    print(f"threads {threads} vs 1: {_steps_changes(base, one)}", flush=True)
    for d in range(draws):
        for n_threads, ref in ((1, one), (threads, base)):
            torch.set_num_threads(n_threads)
            got = T.port_convergence_steps(reference, variables, np.random.RandomState(200 + d))
            print(f"draw {d}, {n_threads} thread(s), weights x (1 + 1e-7 randn): "
                  f"{_steps_changes(got, ref)}", flush=True)
    torch.set_num_threads(1)
    jlogs, jstats, jrows = T.jax_convergence_steps(reference, variables)
    jstats = from_jax_variables({"params": {}, "batch_stats": jstats}, tcfg)
    print(f"port (1 thread) vs JAX: {_steps_changes(one, (jlogs, jstats, jrows))}", flush=True)
    torch.set_num_threads(threads)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--draws", type=int, default=3)
    ap.add_argument("--train", action="store_true", help="measure the train step instead")
    ap.add_argument("--steps", action="store_true",
                    help="measure the convergence solver's steps instead")
    ap.add_argument("--out", default=None, help="save the unperturbed run's depths (npz)")
    ap.add_argument("--compare", default=None, help="an --out file to compare with")
    args = ap.parse_args()
    if args.train:
        return train_probe(args.draws)
    if args.steps:
        return steps_probe(args.draws)
    ctx = _setup()
    images = ctx["batch"]["images"].astype(np.float32)
    base = chain(ctx, images, ctx["variables"], ctx["gstate"].params)
    print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}: {len(base[0])} refined objects", flush=True)
    if args.out:
        np.savez(args.out, slots=np.array(list(base[0])), depth=np.array([v[0] for v in base[0].values()]),
                 dets=base[1]["dets"], valid=base[1]["valid"])
    if args.compare:
        f = np.load(args.compare)
        other = ({tuple(s): (d, None) for s, d in zip(f["slots"], f["depth"])},
                 {"dets": f["dets"], "valid": f["valid"]})
        worst, scale, n = matched_change(base, other)
        print(f"threads: this run vs {args.compare}: {worst:.6g} m, {worst / scale:.3g} of "
              f"{scale:.4g} m; {n} objects over 1e-4 of it")
    for d in range(args.draws):
        rng = np.random.RandomState(100 + d)
        runs = {
            "images x (1 + 1e-6 randn)": chain(ctx, images * (1 + 1e-6 * rng.randn(*images.shape)).astype(np.float32),
                                               ctx["variables"], ctx["gstate"].params),
            "weights x (1 + 1e-7 randn)": chain(ctx, images, _scaled(ctx["variables"], 1e-7, rng),
                                                _scaled(ctx["gstate"].params, 1e-7, rng)),
        }
        for name, run in runs.items():
            worst, scale, n = matched_change(run, base)
            print(f"draw {d}, {name}: {worst:.6g} m, {worst / scale:.3g} of {scale:.4g} m; "
                  f"{n} objects over 1e-4 of it", flush=True)


if __name__ == "__main__":
    main()
