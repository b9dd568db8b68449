"""Where the deeper head's fp32 train step parts between the CUDA kernels and
the plain DCN on the card, and how far the plain step moves on its own.

The step is chip_smoke.py's phase 7d one: ``dgde_run_config()`` with
``head.deeper_head`` at full width and depth, 384x1280, the phase's two
synthetic scenes, seeded weights with every BN in its linear range
(``chip_smoke.linear_range_bn``). One forward, then the gradient of each
loss term alone (``torch.autograd.grad``), so that a gap is read per term:

* ``kernel``: every DCN through the kernels against every DCN plain;
* ``stems_kernel``: only the stems' two DCNs through the kernels;
* ``act <eps> <where> <draw>``: the plain step with the outputs of the DCNs
  named by ``where`` (``stems``, ``all``) multiplied by (1 + eps randn), at
  the size of the kernels' own rounding (the forward's heads read 4e-6 of
  scale);
* ``weights <eps>``: the plain step with every weight multiplied by
  (1 + eps randn), as phase 7d printed it;
* the same ``kernel`` and ``act`` rows for phase 7's model (no stems).

For each run and loss term it prints the largest gradient difference
relative to that parameter's total gradient's largest magnitude, the
parameter, and whether the edge-pair solve kept the same pairs (its top-k
mask) and clamped the same depths. Weights and biases are read alike, so
the biases that a train-mode BN removes read larger than chip_smoke holds
them. Needs a CUDA card:

    python tests/deeper_head_step_probe.py [--out chiprun_out/deeper_head_probe.json]
"""

import argparse
import copy
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from dcd_tpu_torch.engine import loss as loss_mod  # noqa: E402
from dcd_tpu_torch.engine.loss import compute_losses  # noqa: E402
from dcd_tpu_torch.engine.train import _step_mode, batch_to_device  # noqa: E402
from dcd_tpu_torch.models.layers import DCN  # noqa: E402


def term_grads(trainer, batch, impl="dense", stem_impl=None, act=None, weight_eps=0.0):
    """The loss terms and each term's gradients of one train-mode forward
    of a deep copy; ``act=(eps, where, draw)`` perturbs DCN outputs."""
    t = copy.deepcopy(trainer)
    model = t.model
    dev = next(model.parameters()).device
    for name, m in model.named_modules():
        if isinstance(m, DCN):
            m.impl = stem_impl if stem_impl and "_head_pre" in name else impl
    if weight_eps:
        gen = torch.Generator(device=dev).manual_seed(7)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + weight_eps * torch.randn(p.shape, generator=gen, device=p.device))
    hooks = []
    if act is not None:
        eps, where, draw = act
        gen = torch.Generator(device=dev).manual_seed(100 + draw)

        def perturb(_m, _i, out):
            return out * (1 + eps * torch.randn(out.shape, generator=gen, device=out.device))
        hooks = [m.register_forward_hook(perturb) for name, m in model.named_modules()
                 if isinstance(m, DCN) and (where == "all" or "_head_pre" in name)]
    pairs = []
    solve = loss_mod.codec.decode_pairs_kpts_depth

    def recording(*a, **k):
        out = solve(*a, **k)
        pairs.append([o.detach() for o in out])
        return out
    loss_mod.codec.decode_pairs_kpts_depth = recording
    try:
        mb = batch_to_device(batch, dev)
        model.train()
        model.zero_grad(set_to_none=True)
        params = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        with _step_mode(t):
            preds = model(mb["images"], mb["edge_indices"], mb["edge_len"])
            total, terms, _ = compute_losses(t.cfg, preds, mb)
            out = {}
            for k, v in {**terms, "total": total}.items():
                g = torch.autograd.grad(v, [p for _, p in params], retain_graph=True,
                                        allow_unused=True)
                out[k] = (float(v.detach()), {n: (gi if gi is not None else torch.zeros_like(p))
                                              .detach() for (n, p), gi in zip(params, g)})
            rest = [k for k in terms if k not in PAIR_DEPTH_TERMS]
            out["total_without_pair_depths"] = (
                sum(out[k][0] for k in rest),
                {n: sum(out[k][1][n] for k in rest) for n, _ in params})
    finally:
        loss_mod.codec.decode_pairs_kpts_depth = solve
        for h in hooks:
            h.remove()
    del t
    depths, mask = pairs[0]
    clamp = t_clamp(trainer.cfg)
    return out, dict(mask=mask, at_clamp=(depths <= clamp[0]) | (depths >= clamp[1]))


# the loss terms built on the edge-pair depths
PAIR_DEPTH_TERMS = ("pairs_kpts_depth_loss", "corner_loss")


def t_clamp(cfg):
    return cfg.model.head.pairs_depth_clamp


def gaps(a, b):
    """Per term: the loss's relative difference, the largest gradient
    difference of a weight relative to that weight's total gradient's
    largest magnitude in ``b`` (``grad``), and of a bias relative to the
    larger of its own and its layer's weight's (``bias``: a bias that a
    train-mode BN removes has an exact gradient of 0), with the parameter."""
    (ta, pa), (tb, pb) = a, b
    scale = {n: max(float(g.abs().max()), 1e-30) for n, g in tb["total"][1].items()}
    for n in scale:
        if n.endswith(".bias") and n[:-4] + "weight" in scale:
            scale[n] = max(scale[n], scale[n[:-4] + "weight"])
    rows = {}
    for k, (vb, gb) in tb.items():
        va, ga = ta[k]
        rel = {n: float((ga[n] - gb[n]).abs().max()) / scale[n] for n in gb}
        row = dict(loss_rel=abs(va - vb) / max(abs(vb), 1e-30))
        for kind, names in (("grad", [n for n in rel if not n.endswith(".bias")]),
                            ("bias", [n for n in rel if n.endswith(".bias")])):
            worst = max(names, key=rel.get)
            row[kind], row[f"{kind}_name"] = rel[worst], worst
        rows[k] = row
    rows["pairs"] = dict(same_mask=bool(torch.equal(pa["mask"], pb["mask"])),
                         mask_flips=int((pa["mask"] != pb["mask"]).sum()),
                         same_clamped=bool(torch.equal(pa["at_clamp"], pb["at_clamp"])),
                         clamp_flips=int((pa["at_clamp"] != pb["at_clamp"]).sum()),
                         kept=int(pb["mask"].sum()), clamped=int(pb["at_clamp"].sum()))
    return rows


def show(tag, rows):
    print(f"[{tag}] pairs {rows['pairs']}", flush=True)
    for k, r in rows.items():
        if k != "pairs":
            print(f"[{tag}]   {k:26s} loss {r['loss_rel']:.3g}  grad {r['grad']:.3g} "
                  f"({r['grad_name']})  bias {r['bias']:.3g} ({r['bias_name']})", flush=True)


def probe(cfg, batch, deeper, results):
    name = "deeper_head" if deeper else "phase7"
    trainer = cs.build_trainer(cfg, device="cuda", seed=0)
    cs.linear_range_bn(trainer.model)
    plain = term_grads(trainer, batch)
    runs = {"kernel": dict(impl="auto"),
            "plain_again": dict()}
    if deeper:
        runs["stems_kernel"] = dict(stem_impl="auto")
        runs["weights 1e-7"] = dict(weight_eps=1e-7)
        runs["weights 1e-6"] = dict(weight_eps=1e-6)
    for eps in (1e-6, 4e-6):
        for where in (("stems", "all") if deeper else ("all",)):
            for draw in range(2):
                runs[f"act {eps:g} {where} {draw}"] = dict(act=(eps, where, draw))
    for tag, kw in runs.items():
        t0 = time.perf_counter()
        rows = gaps(term_grads(trainer, batch, **kw), plain)
        results[f"{name} {tag}"] = rows
        show(f"{name} {tag} {time.perf_counter() - t0:.1f} s", rows)
    del trainer, plain
    torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/deeper_head_probe.json")
    args = ap.parse_args()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.cuda_build.library()
    base = cs.dgde_run_config()
    batch = cs.collate(cs.scenes(base))
    results = {}
    deeper = cs.with_model(base, head=cs.dataclasses.replace(base.model.head, deeper_head=True))
    probe(deeper, batch, True, results)
    probe(base, batch, False, results)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
