"""A run with the timed path broken underneath comes out not correct: the
rest of the run driven on the CPU at a tiny size (the look for a card
skipped), once for each fault the cell can have. On one card there is no
exchange between cards to leave out."""

import dcd_tpu_torch.engine.infer as program_infer
import dcd_tpu_torch.engine.train as program_train
import pytest
import torch

from portbench.tests.test_pb_result import run_tiny


def half_batch_infer(real):
    def infer(model, images, *args, **kw):
        h = images.shape[0] // 2
        return real(model, torch.cat([images[:h], images[:h]]), *args, **kw)
    return infer


def altered_rows(real):
    def postprocess(*args, **kw):
        out = real(*args, **kw)
        out["dets"] = out["dets"].clone()
        out["dets"][..., 11] += 0.5 * out["dets"][..., 11].abs()  # depth half again as far
        return out
    return postprocess


def one_frame_altered(real):
    def postprocess(*args, **kw):
        out = real(*args, **kw)
        out["dets"] = out["dets"].clone()
        out["dets"][0, :, 11] += 0.5 * out["dets"][0, :, 11].abs()  # one image slot only
        return out
    return postprocess


def validity_set(mark):
    def fault(real):
        def postprocess(*args, **kw):
            out = real(*args, **kw)
            return dict(out, valid=torch.full_like(out["valid"], mark))
        return postprocess
    return fault


def half_batch_step(real):
    def train_step(trainer, batch):
        return real(trainer, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
    return train_step


def altered_gradient(real):
    def compute_gradients(trainer, batch):
        logs = real(trainer, batch)
        with torch.no_grad():  # one leaf's gradient half again where it is produced
            next(p for p in trainer.model.parameters() if p.grad is not None).grad.mul_(1.5)
        return logs
    return compute_gradients


def unchanged_state(real):
    def train_step(trainer, batch):
        with torch.no_grad():
            before = [p.detach().clone() for p in trainer.model.parameters()]
        logs = real(trainer, batch)
        with torch.no_grad():
            for p, b in zip(trainer.model.parameters(), before):
                p.copy_(b)
            trainer.optimizer.adamw.state.clear()
        return logs
    return train_step


@pytest.mark.parametrize("loop, module, attr, fault", [
    ("infer", program_infer, "infer", half_batch_infer),
    ("infer", program_infer, "postprocess", altered_rows),
    ("infer", program_infer, "postprocess", one_frame_altered),
    ("infer", program_infer, "postprocess", validity_set(True)),
    ("infer", program_infer, "postprocess", validity_set(False)),
    ("train", program_train, "train_step", half_batch_step),
    ("train", program_train, "compute_gradients", altered_gradient),
    ("train", program_train, "train_step", unchanged_state),
], ids=["infer-half-batch", "infer-altered-rows", "infer-one-frame-altered",
        "infer-all-valid", "infer-none-valid", "train-half-batch", "train-altered-gradient",
        "train-unchanged-state"])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, one_thread, loop, module,
                                            attr, fault):
    monkeypatch.setattr(module, attr, fault(getattr(module, attr)))
    _, line, _ = run_tiny(tmp_path, loop, False)
    failed = [k for k, c in line["checks"].items() if not c["value"] <= c["limit"]]
    assert line["correct"] is False and failed, line["checks"]
