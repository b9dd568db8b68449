"""Shared inputs of the tests that hold the PyTorch port against the JAX
package: a small DGDE configuration in both packages, flax variables drawn
with numpy, and the boundary-ring inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from dcd_tpu.config import dgde_run_config as jax_dgde_run_config
from dcd_tpu.models.detector import KeypointDetector as JaxDetector
from dcd_tpu_torch.config import dgde_run_config as torch_dgde_run_config

# narrow widths and a 64x128 input, as tests/test_model.py and
# __graft_entry__._small_cfg cut the shipped configuration
CHANNELS = (8, 8, 16, 16, 32, 32)
HEAD_CHANNELS = 16
HEIGHT, WIDTH = 64, 128


def _small(cfg, dcn_impl):
    cfg = dataclasses.replace(
        cfg,
        input=dataclasses.replace(cfg.input, height_train=HEIGHT, width_train=WIDTH),
        model=dataclasses.replace(
            cfg.model,
            head=dataclasses.replace(cfg.model.head, num_channel=HEAD_CHANNELS),
            backbone=dataclasses.replace(cfg.model.backbone, channels=CHANNELS),
        ),
    )
    return with_dcn(cfg, dcn_impl)


def small_configs():
    """(JAX config, port config). The JAX side samples with the unbounded
    gather form: its clamped dense form costs minutes of tracing on the CPU
    at model scale, and test_torch_dcn.py holds the port's clamped form
    against it at the operator level. The port runs its clamped plain form
    ("dense"). The model tests check that no offset of their inputs reaches
    the clamp, so both sides compute one function."""
    return _small(jax_dgde_run_config(), "gather"), _small(torch_dgde_run_config(), "dense")


def edge_inputs(cfg, B, rng):
    """Random boundary-ring pixels (x, y) on the feature map, and lengths."""
    Ho, Wo = cfg.output_height, cfg.output_width
    L = cfg.max_edge_length
    ei = np.stack([rng.randint(0, Wo, (B, L)), rng.randint(0, Ho, (B, L))], -1).astype(np.int32)
    el = np.array([L - 5 - 3 * b for b in range(B)], np.int32)
    return ei, el


def numpy_variables(jcfg, seed=0):
    """Flax variables of the JAX detector, every leaf drawn with numpy:
    He-normal kernels, non-trivial BN statistics, and offset convs with the
    statistics of trained checkpoints (bias std 0.45 px, kernel noise
    0.3/sqrt(fan_in), as bench._realistic_offsets injects)."""
    # the parameter shapes do not depend on the DCN form; the offset-free
    # one traces in a fraction of the time
    shaper = JaxDetector(with_dcn(jcfg, "plain"))
    B = 1
    ei, el = edge_inputs(jcfg, B, np.random.RandomState(0))
    img = jnp.zeros((B, jcfg.input.height_train, jcfg.input.width_train, 3), jnp.float32)
    shapes = jax.eval_shape(
        lambda r: shaper.init(r, img, ei, el, train=False), jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def draw(path, s):
        names = [getattr(p, "key", str(p)) for p in path]
        leaf, shape = names[-1], s.shape
        if "conv_offset_mask" in names:
            fan_in = int(np.prod(shape[:-1])) if leaf == "kernel" else 1
            scale = 0.3 / np.sqrt(fan_in) if leaf == "kernel" else 0.45
            return (rng.randn(*shape) * scale).astype(np.float32)
        if leaf == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.randn(*shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if leaf in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if "class_out" in names:
            return (rng.randn(*shape) * 0.1 - 2.0).astype(np.float32)
        return (rng.randn(*shape) * 0.1).astype(np.float32)

    return JaxDetector(jcfg), jax.tree_util.tree_map_with_path(draw, shapes)


def with_dcn(cfg, dcn_impl):
    bb = dataclasses.replace(cfg.model.backbone, dcn_impl=dcn_impl)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, backbone=bb))


def calibrated_variables(jcfg, tcfg, images, ei, el, seed=0):
    """:func:`numpy_variables` with every BN's running statistics set to
    those of ``images`` (by the port's ``calibrate_batch_norm``; the
    reference importer ``import_torch_dgde`` carries them back). Random
    weights let activations grow layer by layer; calibrated, the offset
    convs emit the sub-pixel offsets of a trained model."""
    import torch

    from dcd_tpu.utils.checkpoint import import_torch_dgde
    from dcd_tpu_torch.models.detector import KeypointDetector
    from dcd_tpu_torch.utils.weights import calibrate_batch_norm, from_jax_variables, load_state

    jmodel, variables = numpy_variables(jcfg, seed)
    model = KeypointDetector(tcfg)
    load_state(model, from_jax_variables(variables, tcfg))
    calibrate_batch_norm(model, torch.from_numpy(images), torch.from_numpy(ei).long(),
                         torch.from_numpy(el).long())
    sd = {k: v.numpy() for k, v in model.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    params, stats = import_torch_dgde(sd, variables, jcfg)
    return jmodel, {"params": params, "batch_stats": stats}
