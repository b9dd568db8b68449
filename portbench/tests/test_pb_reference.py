"""The plain reference against the program at a tiny configuration on the
CPU, on the same weights and inputs: the detector's outputs on the lazy and
the dense path, the rows, and one training step's losses and gradients."""

import pytest
import torch

from portbench.harness import inputs, weights
from portbench.harness.program import program_config
from portbench.reference import config as ref_config
from portbench.reference import post as ref_post
from portbench.reference.loss import compute_losses
from portbench.tests.tiny import TINY_IMAGE, tiny_tree


def _state_and_frames(tree, seed=2 ** 31 + 3, batch=2):
    rcfg = ref_config.load(tree)
    traffic = {"batch": batch, "image": TINY_IMAGE, "pool": 1}
    frames = inputs.frame_batches(rcfg, traffic, seed, torch.device("cpu"), pin=False)[0]
    ref = weights.reference_model(dict(tree, model=dict(tree["model"], fp16=False)), "cpu")
    weights.draw(ref, seed)
    weights.calibrate(ref, frames.images, frames.edge_indices, frames.edge_len)
    return weights.state_dict(ref), frames


@pytest.mark.parametrize("fp16", [False, True])
@pytest.mark.parametrize("deeper_head", [False, True])
def test_inference_matches_the_program(one_thread, fp16, deeper_head):
    from dcd_tpu_torch.engine.infer import build_detector, infer

    tree = tiny_tree(deeper_head)
    tree["model"]["fp16"] = fp16
    state, f = _state_and_frames(tree)
    prog = build_detector(program_config(tree), device="cpu", seed=0)
    prog.load_state_dict(state, strict=True)
    ref = weights.reference_model(tree, "cpu")
    ref.load_state_dict(state)
    ref.eval()
    args = (f.images, f.edge_indices, f.edge_len)
    with torch.no_grad():
        for lazy in (True, False):
            a, b = prog(*args, lazy_topk=lazy), ref(*args, lazy_topk=lazy)
            assert a.keys() == b.keys()
            for k in a:
                torch.testing.assert_close(a[k], b[k], rtol=1e-6, atol=1e-6)
        got = infer(prog, *args, f.calib_P, f.pad_size, f.img_size)
        want = ref_post.infer(ref, *args, f.calib_P, f.pad_size, f.img_size)
    for k in ("dets", "valid"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-6)


def test_a_training_step_matches_the_program(one_thread):
    from dcd_tpu_torch.engine.train import build_trainer, compute_gradients

    tree = tiny_tree()
    rcfg = ref_config.load(tree)
    traffic = {"batch": 2, "pool": 1, "objects": 3, "image": TINY_IMAGE}
    batch = inputs.scene_batches(rcfg, traffic, 5, pin=False)[0]
    state, _ = _state_and_frames(tree)
    trainer = build_trainer(program_config(tree), device="cpu", seed=0)
    trainer.model.load_state_dict(state, strict=True)
    logs = compute_gradients(trainer, batch)
    ref = weights.reference_model(tree, "cpu").train()
    ref.load_state_dict(state)
    b = dict(batch, edge_indices=batch["edge_indices"].long(), edge_len=batch["edge_len"].long())
    total, _, ref_logs = compute_losses(rcfg, ref(b["images"], b["edge_indices"], b["edge_len"]), b)
    total.backward()
    torch.testing.assert_close(logs["total_loss"], total.detach(), rtol=1e-6, atol=0)
    grads = dict(ref.named_parameters())
    for name, p in trainer.model.named_parameters():
        if p.grad is None:
            assert grads[name].grad is None, name
            continue
        scale = float(grads[name].grad.abs().max()) + 1e-12
        assert float((p.grad - grads[name].grad).abs().max()) <= 1e-5 * scale, name
