"""The readers of the program's own spans (``spans.py`` and the
``metrics/`` files that use it) on synthetic records with known
answers, the attribution of device work to program ranges, and the
sink on a tiny engine on the CPU."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench import core, spans

NAMES = ["tick_host_ms.serve", "step_launch_ms.serve", "sync_wait_ms.serve",
         "lane_wait_p95_ms.serve", "decode_device_ms.serve",
         "prefill_device_ms.serve", "forward_device_ms.train",
         "backward_device_ms.train", "update_device_ms.train"]


class _Span:
    def __init__(self, name, start, end, attrs=None):
        self.name, self.start, self.end = name, start, end
        self.attrs = attrs or {}


def _record():
    """Two ticks of 50 ms: steps 30 ms and syncs 4 ms in all; three
    requests seeded; a profile of 2 decode calls and 2 train steps."""
    sink = spans.Sink()
    sink.record_span(_Span("serve.tick", 0.0, 1.0))   # set-up: dropped
    sink.bucket = "window"
    for name, took in [("serve.decode.step", 0.012), ("serve.sync", 0.001),
                       ("serve.tick", 0.050), ("serve.prefill.step", 0.010),
                       ("serve.decode.step", 0.008), ("serve.sync", 0.003),
                       ("serve.tick", 0.050)]:
        sink.record_span(_Span(name, 1.0, 1.0 + took))
    for wait in (0.1, 0.3, 0.2):
        sink.record_span(_Span("serve.request.prefill", 0.0, 1.0,
                               {"lane_wait_s": wait, "chunks": 2}))
    programs = spans.attribute(
        [(0, 100, "serve.decode.step"), (10, 20, "serve.decode.inputs"),
         (200, 300, "serve.decode.step"), (400, 500, "serve.prefill.step"),
         (1000, 2000, "train.forward"), (2000, 5000, "train.backward"),
         (5000, 6000, "train.update"), (7000, 8000, "train.forward"),
         (8000, 9000, "train.backward"), (9000, 9500, "train.update")],
        [(15, 0.002), (50, 0.006), (250, 0.004), (450, 0.009),
         (1500, 0.010), (3000, 0.030), (8500, 0.050), (5500, 0.003),
         (9100, 0.005)])
    return {"program": sink.buckets, "profile": {"programs": programs}}


WANT = {"tick_host_ms.serve": (100 - 30 - 4) / 2,
        "step_launch_ms.serve": 15.0, "sync_wait_ms.serve": 2.0,
        "lane_wait_p95_ms.serve": 1e3 * float(np.percentile(
            [0.1, 0.3, 0.2], 95)),
        "decode_device_ms.serve": 6.0, "prefill_device_ms.serve": 9.0,
        "forward_device_ms.train": 5.0, "backward_device_ms.train": 40.0,
        "update_device_ms.train": 4.0}


@pytest.mark.parametrize("name", NAMES)
def test_each_reader_on_a_synthetic_record(name):
    assert core.read_metric(name, _record()) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", NAMES)
def test_each_reader_finds_nothing_without_its_keys(name):
    assert core.read_metric(name, {"window": {}, "model": {}}) is None
    assert core.read_metric(name, {"program": {}, "profile": {
        "programs": {}}}) is None


def test_host_split_adds_up_to_the_tick():
    split = spans.tick_split(_record())
    assert sum(split.values()) == pytest.approx(50.0)


def test_sink_buckets_and_request_attrs():
    got = _record()["program"]
    assert list(got) == ["window"]
    assert got["window"]["spans"]["serve.tick"] == {
        "count": 2, "s": pytest.approx(0.1)}
    assert [r["lane_wait_s"] for r in got["window"]["requests"]] == \
        [0.1, 0.3, 0.2]


def test_work_counts_under_the_innermost_range_on_any_thread():
    """A launch inside a nested range counts for the inner one only;
    one inside a range's interval from another thread (the autograd
    engine's, say) counts for that range; one outside every range
    counts nowhere; every range counts its host time."""
    got = spans.attribute(
        [(0, 100, "train.backward"), (10, 20, "serve.inner"),
         (200, 210, "train.update")],
        [(5, 1.0), (15, 2.0), (20, 4.0), (150, 8.0), (205, 1.0)])
    assert got == {
        "train.backward": {"count": 1, "host_s": 100, "device_s": 5.0},
        "serve.inner": {"count": 1, "host_s": 10, "device_s": 2.0},
        "train.update": {"count": 1, "host_s": 10, "device_s": 1.0}}


class _Event:
    """What the reduction reads of a profiler event (times in ns)."""

    def __init__(self, name, start, end, corr=0, link=0, device="CPU",
                 annotation=False):
        self.nm, self.s, self.e = name, start, end
        self.corr, self.link, self.dev = corr, link, device
        self.annotation = annotation

    def name(self):
        return self.nm

    def start_ns(self):
        return self.s

    def end_ns(self):
        return self.e

    def duration_ns(self):
        return self.e - self.s

    def device_type(self):
        return f"DeviceType.{self.dev}"

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return self.link

    def is_user_annotation(self):
        return self.annotation


def test_device_work_goes_to_the_range_holding_its_launch_call():
    """Work counts once, under the program range holding the runtime
    call that launched it (same correlation id), from any thread and
    whether or not an op encloses the call; an op whose own id equals
    a launch's, the device shadow of a range, work whose launch was not
    recorded and work launched outside every program range count
    nowhere."""
    events = [
        _Event("serve.decode.step", 0, 100_000, corr=1),
        _Event("serve.decode.step", 0, 900_000, corr=1, device="CUDA",
               annotation=True),
        _Event("perfbench.decode_step", 0, 900_000, device="CUDA"),
        _Event("aten::mm", 10_000, 20_000, corr=2),
        _Event("cudaLaunchKernel", 12_000, 13_000, corr=3, link=2),
        _Event("aten::sum", 14_000, 15_000, corr=3),  # same id, no work
        _Event("gemm", 500_000, 800_000, corr=3, link=2, device="CUDA"),
        _Event("cuLaunchKernel", 30_000, 31_000, corr=4),  # via ctypes
        _Event("paged_decode_kernel", 800_000, 850_000, corr=4,
               device="CUDA"),
        _Event("cudaLaunchKernel", 40_000, 41_000, corr=5, link=9),
        _Event("mul", 850_000, 857_000, corr=5, link=9, device="CUDA"),
        _Event("cudaMemcpyAsync", 150_000, 160_000, corr=6),
        _Event("Memcpy HtoD", 860_000, 870_000, corr=6, device="CUDA"),
        _Event("orphan", 0, 5_000, corr=99, device="CUDA")]
    want = {"count": 1, "host_s": 100e-6, "device_s": 357e-6}
    assert spans.program_ranges(events) == {
        "serve.decode.step": pytest.approx(want)}


def test_ranges_of_a_cpu_profile_of_the_program():
    """The program's live spans under the profiler (CPU: no device
    work) come out by name with their counts and host time."""
    from tpu_autoscaler_torch.obs.trace import Tracer, maybe_span

    tracer = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with maybe_span(tracer, "train.step"):
                with maybe_span(tracer, "train.forward"):
                    torch.ones(4).sum()
    got = spans.program_ranges(prof.profiler.kineto_results.events())
    assert sorted(got) == ["train.forward", "train.step"]
    assert got["train.step"]["count"] == got["train.forward"]["count"] == 3
    assert got["train.step"]["host_s"] > got["train.forward"]["host_s"] > 0
    assert got["train.step"]["device_s"] == 0


def test_the_sink_on_a_tiny_engine():
    """A tiny paged engine traced into the sink: the three host readers
    add up to the mean ``serve.tick``, and every request seeded in the
    window has a lane wait."""
    from tpu_autoscaler_torch.obs.trace import Tracer
    from tpu_autoscaler_torch.workloads import model, paged, serving

    cfg = model.ModelConfig(vocab=32, d_model=16, n_layers=2, n_heads=2,
                            d_ff=32, seq_len=32, dtype=torch.float32)
    params = model.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    sink = spans.Sink()
    eng = paged.PagedBatcher(params, cfg, slots=4, max_len=64,
                             block_size=8, chunk=8, prefill_lanes=1,
                             device="cpu", tracer=Tracer(recorder=sink))
    rng = np.random.default_rng(3)
    for n in (20, 17, 30, 9, 25):
        eng.submit(serving.Request(prompt=rng.integers(0, 32, (n,)),
                                   max_new_tokens=5))
    eng.tick()
    sink.bucket = "window"
    while not eng.idle:
        eng.tick()
    record = {"program": sink.buckets}
    window = sink.buckets["window"]["spans"]
    parts = [core.read_metric(n, record) for n in NAMES[:3]]
    assert all(p >= 0 for p in parts)
    assert sum(parts) == pytest.approx(
        1e3 * window["serve.tick"]["s"] / window["serve.tick"]["count"])
    assert window["serve.tick"]["count"] == eng.ticks - 1
    assert len(sink.buckets["window"]["requests"]) == 5
    assert core.read_metric("lane_wait_p95_ms.serve", record) > 0
