"""The step-0 loss terms of the JAX package's ``model.init`` against the port's
seeded initialisation (``build_trainer``), on the small configuration of
tests/torch_port_common.py and one batch of four synthetic scenes, for seeds
0-2 of each: a script, not collected by pytest.

    JAX_PLATFORMS=cpu python tests/init_probe.py
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]
from torch_port_common import small_configs, with_dcn  # noqa: E402

from dcd_tpu.data import synthetic as jsyn  # noqa: E402
from dcd_tpu.data.target_encoder import collate as jcollate, encode_targets as jencode  # noqa: E402
from dcd_tpu.engine.loss import compute_losses as jloss  # noqa: E402
from dcd_tpu.models.detector import KeypointDetector as JaxDetector  # noqa: E402
from dcd_tpu_torch.engine.loss import compute_losses  # noqa: E402
from dcd_tpu_torch.engine.train import batch_to_device, build_trainer  # noqa: E402

jcfg, tcfg = small_configs()
jcfg = with_dcn(jcfg, "plain")
tcfg = with_dcn(tcfg, "plain")
samples = [jencode(*jsyn.make_scene(seed=s, num_objs=4, image_size=(120, 60)), jcfg) for s in range(4)]
batch = jcollate(samples)
model = JaxDetector(jcfg)
for seed in range(3):
    variables = jax.jit(lambda r: model.init(r, jnp.asarray(batch["images"][:1]),
                                             batch["edge_indices"][:1], batch["edge_len"][:1],
                                             train=False))(jax.random.PRNGKey(seed))
    preds, _ = model.apply(variables, jnp.asarray(batch["images"]), batch["edge_indices"],
                           batch["edge_len"], train=True, mutable=["batch_stats"])
    t, ld, lg = jloss(jcfg, preds, batch)
    cls = np.asarray(preds["cls"])
    print("jax ", seed, float(t), {k: round(float(v), 3) for k, v in ld.items()},
          "cls mean", cls.mean(), "logit std", np.log(cls / (1 - cls)).std())
    tr = build_trainer(tcfg, "cpu", seed=seed)
    b = batch_to_device({k: v for k, v in batch.items() if k != "img_ids"}, torch.device("cpu"))
    with torch.no_grad():
        p = tr.model(b["images"], b["edge_indices"], b["edge_len"])
        tt, tld, _ = compute_losses(tcfg, p, b)
    c = p["cls"].numpy()
    print("port", seed, float(tt), {k: round(float(v), 3) for k, v in tld.items()},
          "cls mean", c.mean(), "logit std", np.log(c / (1 - c)).std())
