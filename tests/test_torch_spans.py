"""The port's profiler spans (``dcd_tpu_torch/utils/profiling.py::span``) on
the CPU, at the small configuration of ``torch_port_common``.

* ``infer`` under ``trace_session``: each ``dcd.*`` inference span nests in
  the one the layers' table of ``utils/profiling.py`` puts it in, one
  ``dcd.dcn`` per DCN module and one ``dcd.upsample`` per transposed conv,
  ``dcd.postprocess`` after ``dcd.model``;
* ``train_step``: ``dcd.train_step`` holds the batch's copy, the forward,
  the loss, the backward, the logs' norm and the optimizer, in that order,
  with the clip inside the optimizer;
* without a profiler ``span`` never enters ``record_function`` (patched to
  raise);
* the rows of ``infer`` and the parameters after a step are bitwise the same
  with the profiler on and off.
"""

import json

import pytest
import torch

from dcd_tpu_torch.data import synthetic
from dcd_tpu_torch.data.target_encoder import collate, encode_targets
from dcd_tpu_torch.engine.infer import build_detector, infer
from dcd_tpu_torch.engine.train import build_trainer, train_step
from dcd_tpu_torch.models.layers import DCN, ConvTranspose2d
from dcd_tpu_torch.utils import profiling
from torch_port_common import small_configs, with_dcn
from torch_port_common import one_torch_thread  # noqa: F401  (autouse)

# span -> the span it nests in directly (None: outermost)
INFER_PARENT = {"dcd.infer": None, "dcd.infer.h2d": "dcd.infer", "dcd.model": "dcd.infer",
                "dcd.trunk": "dcd.model", "dcd.decoder": "dcd.model",
                "dcd.upsample": "dcd.decoder", "dcd.dcn": "dcd.decoder",
                "dcd.heads": "dcd.model", "dcd.postprocess": "dcd.infer"}
TRAIN_ORDER = ["dcd.train.h2d", "dcd.train.forward", "dcd.train.loss", "dcd.train.backward",
               "dcd.train.grad_norm", "dcd.optimizer"]


def _raise(name):
    raise AssertionError(f"record_function entered for {name!r} with no profiler running")


def _spans(logdir):
    """The trace's ``dcd.*`` spans as (name, start, end), in start order."""
    with open(logdir / profiling.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    out = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
           if e.get("cat") == "user_annotation" and e["name"].startswith("dcd.")]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _parent(spans, s):
    """The innermost other span that holds ``s``, or None."""
    holders = [h for h in spans if h is not s and h[1] <= s[1] and s[2] <= h[2]]
    return min(holders, key=lambda h: h[2] - h[1], default=None)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``infer`` and one ``train_step`` of a fresh trainer, each once with
    ``record_function`` patched to raise and no profiler, once under
    ``trace_session``; the rows, the parameters and the traces' spans."""
    cfg = with_dcn(small_configs()[1], "auto")
    batch = collate([encode_targets(*synthetic.make_scene(seed=s, num_objs=3,
                                                          image_size=(120, 60)), cfg)
                     for s in range(2)])
    batch = {k: torch.as_tensor(v) for k, v in batch.items() if k != "img_ids"}
    model = build_detector(cfg, device="cpu", seed=0)
    args = (batch["images"], batch["edge_indices"], batch["edge_len"], batch["calib_P_full"],
            batch["pad_size"], batch["image_size"])

    def step():
        trainer = build_trainer(cfg, device="cpu", seed=0)
        train_step(trainer, batch)
        return [p.detach().clone() for p in trainer.model.parameters()]

    out = {"model": model}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(profiling, "record_function", _raise)
        out["off_rows"], out["off_params"] = infer(model, *args), step()
    for kind, run in (("infer", lambda: infer(model, *args)), ("train", step)):
        logdir = tmp_path_factory.mktemp(kind)
        with profiling.trace_session(str(logdir)):
            out[f"on_{kind}"] = run()
        out[f"{kind}_spans"] = _spans(logdir)
    return out


def test_span_without_a_profiler_is_one_shared_no_op(runs, monkeypatch):
    # the fixture ran infer and a train step with record_function raising
    assert runs["off_params"]
    assert profiling.span("dcd.a") is profiling.span("dcd.b")
    monkeypatch.setattr(profiling, "record_function", _raise)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="dcd.model"):
            profiling.span("dcd.model")


def test_infer_spans_nest_as_the_layers(runs):
    spans, model = runs["infer_spans"], runs["model"]
    names = [s[0] for s in spans]
    assert set(names) == set(INFER_PARENT)
    for s in spans:
        parent = _parent(spans, s)
        assert (parent and parent[0]) == INFER_PARENT[s[0]], s
    for name in ("dcd.infer", "dcd.infer.h2d", "dcd.model", "dcd.trunk", "dcd.decoder",
                 "dcd.heads", "dcd.postprocess"):
        assert names.count(name) == 1, name
    assert names.count("dcd.dcn") == sum(isinstance(m, DCN) for m in model.modules()) == 16
    assert names.count("dcd.upsample") == sum(isinstance(m, ConvTranspose2d)
                                              for m in model.modules()) == 8
    (model_span,) = [s for s in spans if s[0] == "dcd.model"]
    (post,) = [s for s in spans if s[0] == "dcd.postprocess"]
    assert post[1] >= model_span[2]


def test_train_step_spans_hold_the_step_in_order(runs):
    spans = runs["train_spans"]
    (step,) = [s for s in spans if s[0] == "dcd.train_step"]
    children = [s for s in spans if _parent(spans, s) is step]
    assert [s[0] for s in children] == TRAIN_ORDER
    assert all(a[2] <= b[1] for a, b in zip(children, children[1:]))
    (clip,) = [s for s in spans if s[0] == "dcd.optimizer.clip"]
    assert _parent(spans, clip)[0] == "dcd.optimizer"
    (forward,) = [s for s in spans if s[0] == "dcd.train.forward"]
    assert [s[0] for s in spans if _parent(spans, s) is forward] == ["dcd.model"]


@pytest.mark.parametrize("kind", ["infer", "train"])
def test_results_are_bitwise_equal_with_the_profiler_on_and_off(runs, kind):
    if kind == "infer":
        off, on = runs["off_rows"], runs["on_infer"]
        assert set(off) == set(on)
        pairs = [(off[k], on[k]) for k in off]
    else:
        pairs = list(zip(runs["off_params"], runs["on_train"]))
    assert pairs
    for a, b in pairs:  # bit for bit, NaN too
        assert a.dtype == b.dtype and a.numpy().tobytes() == b.numpy().tobytes()
