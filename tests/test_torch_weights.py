"""The weight carry from the JAX package to the port, and the port's rules:
it imports nothing of JAX or of ``dcd_tpu``, and its entry points refuse to
fall back to the CPU."""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from dcd_tpu import config as jax_config
from dcd_tpu.utils.checkpoint import _offset_conv_perm, import_torch_dgde
from dcd_tpu_torch import config as torch_config
from dcd_tpu_torch.engine.infer import build_detector
from dcd_tpu_torch.models.detector import KeypointDetector
from dcd_tpu_torch.utils.weights import from_jax_variables, load_state, offset_conv_perm
from torch_port_common import numpy_variables, small_configs
from torch_port_common import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "dcd_tpu"}


@pytest.fixture(scope="module")
def carried():
    jcfg, tcfg = small_configs()
    _, variables = numpy_variables(jcfg, seed=1)
    return jcfg, tcfg, variables, from_jax_variables(variables, tcfg)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_round_trip_through_reference_importer(carried):
    """JAX variables -> port state dict -> import_torch_dgde -> the same JAX
    variables. The importer starts from a zeroed tree, so every leaf it
    writes must come back exactly; the bilinear ``up_k`` kernels, which it
    does not import, are compared on the port side instead."""
    jcfg, _, variables, sd = carried
    zeros = {col: _zero_tree(variables[col]) for col in ("params", "batch_stats")}
    params, stats = import_torch_dgde(sd, zeros, jcfg)
    got = dict(_leaves({"params": params, "batch_stats": stats}))
    for path, want in _leaves(variables):
        if any(str(p).startswith("up_") for p in path):
            name = ".".join(p for p in path[1:-1]) + ".weight"
            np.testing.assert_array_equal(sd[name], np.transpose(want, (3, 2, 0, 1)))
            continue
        np.testing.assert_array_equal(got[path], want, err_msg=str(path))


def _zero_tree(tree):
    return {k: _zero_tree(v) if hasattr(v, "items") else np.zeros_like(np.asarray(v))
            for k, v in tree.items()}


def test_state_dict_keys_match_port_model(carried):
    _, tcfg, _, sd = carried
    model = KeypointDetector(tcfg)
    load_state(model, sd)
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    with pytest.raises(KeyError):
        load_state(model, {k: v for k, v in sd.items() if "class_head" not in k})


def test_offset_conv_is_interleaved(carried):
    """Channel 2t of the port's offset conv is flax channel t (dy), channel
    2t+1 is flax channel K+t (dx), the last K are the mask logits."""
    _, _, variables, sd = carried
    flax_b = np.asarray(variables["params"]["backbone"]["ida_up"]["proj_1"]["conv"]
                        ["conv_offset_mask"]["bias"])
    port_b = sd["backbone.ida_up.proj_1.conv.conv_offset_mask.bias"]
    K = 9
    np.testing.assert_array_equal(port_b[0:2 * K:2], flax_b[:K])
    np.testing.assert_array_equal(port_b[1:2 * K:2], flax_b[K:2 * K])
    np.testing.assert_array_equal(port_b[2 * K:], flax_b[2 * K:])
    np.testing.assert_array_equal(offset_conv_perm(K), _offset_conv_perm(K))


def test_config_copy_matches_jax_package():
    """The port's config tree is the JAX package's, knob for knob (``remat``
    too, since the port recomputes its forward with torch.utils.checkpoint),
    with the same defaults."""
    def fields(cfg):
        out = {}
        for f in dataclasses.fields(cfg):
            v = getattr(cfg, f.name)
            if dataclasses.is_dataclass(v):
                out.update({f"{f.name}.{k}": x for k, x in fields(v).items()})
            else:
                out[f.name] = v
        return out

    for make in ("default_config", "dgde_run_config"):
        j = fields(getattr(jax_config, make)())
        t = fields(getattr(torch_config, make)())
        assert set(j) == set(t)
        for k in t:  # dcn_impl too: the port takes JAX's values and meanings
            assert t[k] == j[k], k


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_dcd_tpu():
    files = sorted((ROOT / "dcd_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    names = {p.relative_to(ROOT).as_posix() for p in files}
    assert {f"dcd_tpu_torch/{m}.py" for m in (
        "tools/train_dgde", "evaluation/kitti_eval", "evaluation/rotate_iou", "evaluation/native",
        "data/kitti_dataset", "data/multiscale", "utils/checkpoint", "utils/logger",
        "utils/metrics", "utils/writer", "utils/timer", "tools/train_gmw", "tools/demo",
        "utils/visualize", "utils/profiling", "tools/oracle_inject", "tools/convergence_run",
        "tools/offset_stats", "tools/bf16_rows")} <= names
    for path in files:
        for mod in _imports(path):
            assert mod.split(".")[0] not in BANNED, f"{path.relative_to(ROOT)} imports {mod}"


def test_build_detector_refuses_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = small_configs()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_detector(tcfg, device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_detector(tcfg, device="cuda")
    model = build_detector(tcfg, device="cpu")
    assert next(model.parameters()).device.type == "cpu" and not model.training


def test_entry_builds_the_shipped_detector_on_request():
    from dcd_tpu_torch.entry import entry

    fn, (images, edge_idx, edge_len) = entry(device="cpu")
    assert images.shape == (1, 384, 1280, 3) and edge_idx.shape == (1, 832, 2)
    assert callable(fn) and edge_len.tolist() == [16]
