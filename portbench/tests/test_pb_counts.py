"""The counters of operations and bytes against hand counts, and the frozen
bounds against the values the program's smoke script recorded."""

import pytest
import torch
from torch import nn

from portbench.harness import counts
from portbench.reference.layers import DCN, Conv2d, ConvTranspose2d


def test_conv_and_dcn_operations_match_hand_counts():
    model = nn.Sequential(Conv2d(3, 8, 3, padding=1), DCN(8, 16),
                          ConvTranspose2d(16, 16, 4, stride=2, padding=1, groups=16, bias=False))
    x = torch.empty((2, 3, 10, 12), device="meta")
    with torch.device("meta"):
        model = model.to("meta")
    c = counts.count_modules(model, lambda: model(x), batch=2)
    p = 2 * 10 * 12
    assert c.flops["conv"] == 2 * p * 8 * 3 * 9 + 2 * p * 27 * 8 * 9  # conv + the offset conv
    assert c.flops["dcn_contraction"] == 2 * p * 9 * 8 * 16
    assert c.flops["dcn_sampling"] == 8 * p * 9 * 8
    assert c.flops["conv_transpose"] == 2 * (p * 16) * 16  # each input element times 4x4 taps
    assert c.dcn_shapes == [(2, 10, 12, 8, 16)]
    assert c.flops_per_image == sum(c.flops.values()) / 2


def test_k1_bytes_match_a_hand_count():
    # batch 1, 2x3 pixels, Cin 8, Cout 16: x 6*8, offsets 6*18 (fp32), mask
    # 6*9, weight 9*8*16, bias 16, output 6*16
    nbytes, contraction, sampling = counts.k1_work(1, 2, 3, 8, 16, bf16=True)
    assert nbytes == 4 * 6 * 18 + 2 * (6 * 8 + 6 * 9 + 9 * 8 * 16 + 16 + 6 * 16)
    assert contraction == 2 * 6 * 9 * 8 * 16 and sampling == 8 * 6 * 9 * 8
    assert counts.k1_work(1, 2, 3, 8, 16, bf16=False)[0] == 4 * (6 * (18 + 8 + 9 + 16) + 9 * 8 * 16 + 16)


# the program's smoke script's recorded bounds (PERF.md, the TPU kernels'
# table): K1 over a forward's 16 launches at batch 64 in bf16 and at batch 2
# in fp32, and K2 + K3 over a step's 16 at batch 8 in fp32
@pytest.mark.parametrize("batch, bf16, kernel, recorded", [
    (64, True, "k1", 2.043), (2, False, "k1", 0.361), (2, True, "k1", 0.0639),
    (8, False, "k2_k3", 3.006 + 1.420),
])
def test_frozen_bounds_match_the_recorded_values(dgde_tree, batch, bf16, kernel, recorded):
    shapes = counts.count_forward(dgde_tree, batch, lazy=(kernel == "k1")).dcn_shapes
    assert len(shapes) == 16
    fn = counts.k1_bound_ms if kernel == "k1" else counts.k2_k3_bound_ms
    total = sum(fn(*s, bf16) for s in shapes)
    assert total == pytest.approx(recorded, abs=6e-4)


def test_the_deeper_head_adds_two_256_channel_stems(dgde_tree):
    dgde_tree["model"]["head"]["deeper_head"] = True
    shapes = counts.count_forward(dgde_tree, 2, lazy=True).dcn_shapes
    assert len(shapes) == 18 and shapes[-2:] == [(2, 96, 320, 256, 256)] * 2
    assert sum(counts.k1_bound_ms(*s, True) for s in shapes) == pytest.approx(0.213, abs=6e-4)
