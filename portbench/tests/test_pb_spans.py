"""The readers of the program's own spans (``harness/spans.py`` and the
metrics that use it) on hand-built readings: device work by launch time,
idle by the host's innermost span, launch calls by the host's clock; and
nothing read, nothing raised, where the program opens no such span."""

import pytest

from portbench.harness import spans
from portbench.harness.spec import metric_reader
from portbench.harness.trace import STEP, DeviceEvent, Reading

NEW = ("upsample_ms.infer", "dcn_ms.infer", "forward_ms.train", "loss_ms.train",
       "backward_ms.train", "update_ms.train", "update_idle_ms.train", "launches_per_step.train")


def us(ms):
    return 1e3 * ms


def kernel(name, start, dur, launch, cat="kernel"):
    """A device event, its times in ms."""
    return DeviceEvent(name, cat, us(start), us(dur), None if launch is None else us(launch))


def reading(kind, steps, span_ms, device, host=()):
    r = Reading(kind=kind, steps=steps, batch=8, bf16=False, count=None, images_per_s=1.0)
    for name, ivs in span_ms.items():
        r.spans[name] = [(us(a), us(b)) for a, b in ivs]
    r.device = list(device)
    r.host = [(name, us(ts), 0.0) for name, ts in host]
    r.window = (min(a for a, _ in r.spans[STEP]), max(b for _, b in r.spans[STEP]))
    return r


# one training step (ms): the spans nest as the program opens them
TRAIN_SPANS = {STEP: [(0, 100)], "dcd.train_step": [(1, 95)], "dcd.train.h2d": [(1, 5)],
               "dcd.train.forward": [(5, 30)], "dcd.model": [(6, 29)],
               "dcd.train.loss": [(30, 40)], "dcd.train.backward": [(40, 60)],
               "dcd.train.grad_norm": [(60, 70)], "dcd.optimizer": [(70, 90)],
               "dcd.optimizer.clip": [(71, 80)]}
TRAIN_DEVICE = [kernel("Memcpy HtoD", 2, 2, 1.5, "gpu_memcpy"),
                kernel("conv", 10, 15, 6),
                kernel("loss", 31, 5, 30.5),
                kernel("bwd_x_kernel", 41, 15, 45),  # launched from autograd's thread
                kernel("norm", 62, 2, 61),
                kernel("clip", 72, 3, 71.5),
                kernel("adamw", 82, 4, 81),
                kernel("fill", 91, 1, 90.01),  # launched just after the optimizer's span
                kernel("orphan", 96, 1, None)]  # no launch record
TRAIN_HOST = [("cudaMemcpyAsync", 1.5), ("cudaLaunchKernel", 6), ("cudaLaunchKernel", 30.5),
              ("cudaLaunchKernel", 45), ("cuLaunchKernel", 50), ("cudaLaunchKernel", 61),
              ("cudaLaunchKernel", 71.5), ("cudaLaunchKernelExC", 81),
              ("cudaLaunchKernel", 90.01), ("cudaLaunchKernel", 97)]


def train_reading():
    return reading("train", 1, TRAIN_SPANS, TRAIN_DEVICE, TRAIN_HOST)


def test_training_layers_take_the_kernels_launched_in_their_spans():
    r = train_reading()
    got = {name: metric_reader(name)(r) for name in
           ("forward_ms.train", "loss_ms.train", "backward_ms.train", "update_ms.train")}
    assert got == pytest.approx({"forward_ms.train": 15.0, "loss_ms.train": 5.0,
                                 "backward_ms.train": 15.0, "update_ms.train": 2.0 + 3.0 + 4.0})
    # the step holds the copy and the fill launched between spans besides
    assert r.device_ms(within="dcd.train_step") == pytest.approx(sum(got.values()) + 2 + 1)
    assert r.device_ms(within="dcd.optimizer") == pytest.approx(7.0)


def test_update_idle_counts_the_gaps_inside_the_update_spans_only():
    # idle in [60, 90]: 60-62 (of 56-62), 64-72, 75-82, 86-90 (of 86-91)
    assert metric_reader("update_idle_ms.train")(train_reading()) == pytest.approx(2 + 8 + 7 + 4)
    two = reading("train", 2, {k: v + [(a + 100, b + 100) for a, b in v]
                               for k, v in TRAIN_SPANS.items()},
                  TRAIN_DEVICE + [kernel(e.name, e.ts / 1e3 + 100, e.dur / 1e3,
                                         e.launch and e.launch / 1e3 + 100, e.cat)
                                  for e in TRAIN_DEVICE])
    assert metric_reader("update_idle_ms.train")(two) == pytest.approx(2 + 8 + 7 + 4)


def test_launches_count_the_host_calls_inside_the_step_span():
    # 8 launch calls from 1 to 95 ms; the copy is no launch, the call at 97 is outside
    assert metric_reader("launches_per_step.train")(train_reading()) == 8


def test_idle_splits_by_the_innermost_program_span_and_sums_to_the_whole():
    r = train_reading()
    split = spans.idle_by_span(r)
    assert split == pytest.approx({k: 1e-3 * v for k, v in {
        spans.OUTSIDE: 1 + 4, "dcd.train.h2d": 1 + 1, "dcd.train.forward": 1 + 1,
        "dcd.model": 4 + 4, "dcd.train.loss": 1 + 4, "dcd.train.backward": 1 + 4,
        "dcd.train.grad_norm": 2 + 6, "dcd.optimizer": 1 + 2 + 4, "dcd.optimizer.clip": 1 + 5,
        "dcd.train_step": 1 + 3}.items()})
    assert sum(split.values()) == pytest.approx(r.window_s - r.busy_s)


def test_inference_layers_take_each_span_of_every_step():
    span_ms = {STEP: [(0, 50), (50, 100)], "dcd.dcn": [(10, 20), (30, 35), (60, 70), (80, 85)],
               "dcd.upsample": [(22, 25), (72, 75)]}
    device = [kernel("dcn_fwd_kernel", 11, 4, 10.5), kernel("offset conv", 16, 2, 19.9),
              kernel("dcn_fwd_kernel", 31, 3, 34), kernel("dcn_fwd_kernel", 61, 4, 60.5),
              kernel("dcn_fwd_kernel", 81, 3, 84),
              kernel("relu", 36, 1, 35.01),  # launched just after a DCN's span
              kernel("dgrad2d_c1_k1_nhwc", 23, 5, 22.5), kernel("dgrad2d_c1_k1_nhwc", 73, 5, 72.5)]
    r = reading("infer", 2, span_ms, device)
    assert metric_reader("dcn_ms.infer")(r) == pytest.approx((4 + 2 + 3 + 4 + 3) / 2)
    assert metric_reader("upsample_ms.infer")(r) == pytest.approx(5.0)
    split = spans.idle_by_span(r)
    assert sum(split.values()) == pytest.approx(r.window_s - r.busy_s)
    # idle in the DCNs' spans: 10-11, 15-16, 18-20, 30-31, 34-35, 60-61, 65-70, 80-81, 84-85
    assert spans.idle_ms_under(r, ("dcd.dcn",)) == pytest.approx(14.0)
    assert split["dcd.dcn"] == pytest.approx(14e-3)
    assert split["dcd.upsample"] == pytest.approx(2e-3)  # 22-23, 72-73


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_spans_gives_nothing(name):
    other = "infer" if name.endswith(".infer") else "train"
    parent = reading(other, 1, {STEP: [(0, 10)], "portbench.model": [(1, 9)]},
                     [kernel("k", 2, 1, 1.5)], [("cudaLaunchKernel", 1.5)])
    assert metric_reader(name)(parent) is None
    no_card = train_reading() if other == "train" else parent
    no_card.device = []
    assert metric_reader(name)(no_card) is None
    wrong_loop = train_reading()
    wrong_loop.kind = "infer" if other == "train" else "train"
    assert metric_reader(name)(wrong_loop) is None


def test_the_report_splits_the_step_and_names_what_no_part_holds():
    from portbench.tools.spans_report import by_span, checks

    r = train_reading()
    got = checks(r)
    assert got["train_step_device_ms"] == pytest.approx(47.0)
    assert got["parts_device_ms"] == pytest.approx(15 + 5 + 15 + 2 + 7)
    assert set(got["outside_parts_ms"]) == {"dcd.train.h2d: Memcpy HtoD", "between spans: fill"}
    assert got["launch_calls"] == {"cudaLaunchKernel": 6, "cuLaunchKernel": 1,
                                   "cudaLaunchKernelExC": 1}
    assert got["idle_parts_s"] == pytest.approx(got["idle_whole_s"])
    assert by_span(r)["dcd.train.backward"] == pytest.approx(
        {"count": 1, "host_ms": 20.0, "device_ms": 15.0})
