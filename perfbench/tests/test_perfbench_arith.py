"""The yardstick on synthetic traces with known answers: the device's
busy time as a union (two overlapping kernels count once), idle gaps
put down to the host, kernel bounds, model flops and the readers."""

import numpy as np
import pytest

from perfbench import core, trace
from perfbench.metrics import _arith


def test_overlapping_kernels_count_once():
    # Two kernels overlap over [20, 30); a third stands alone.
    intervals = [(10, 30), (20, 40), (60, 70)]
    assert _arith.union(intervals, 0, 100) == [(10, 40), (60, 70)]
    assert _arith.busy(intervals, 0, 100) == 40
    assert _arith.busy(intervals, 15, 65) == 30
    assert _arith.gaps(intervals, 0, 100) == [(0, 10), (40, 60), (70, 100)]
    assert _arith.busy([], 0, 1) == 0 and _arith.gaps([], 0, 1) == [(0, 1)]


def test_idle_gaps_go_to_what_the_host_was_doing():
    host = [(0, 100, "perfbench.tick"), (5, 30, "aten::index_put_"),
            (50, 90, "perfbench.decode_step"), (55, 60, "cudaLaunchKernel")]
    idle = [(10, 20), (56, 58), (95, 99)]
    got = dict(trace._idle_by_host(idle, host))
    assert got == pytest.approx({
        "perfbench.tick / aten::index_put_": 10e-6,
        "perfbench.decode_step / cudaLaunchKernel": 2e-6,
        "perfbench.tick": 4e-6})


def test_kernel_classes():
    assert _arith.kernel_class("void paged_decode_kernel<bf16>") == "attention"
    assert _arith.kernel_class("sm90_xmma_gemm_bf16bf16") == "gemm"
    assert _arith.kernel_class("Memcpy HtoD") == "copy"
    assert _arith.kernel_class("at::vectorized_elementwise") == "other"
    assert trace.device_class("void fwd_tc_kernel<128>") == "K1 fwd_tc_kernel"
    assert trace.device_class("at::vectorized_elementwise_kernel") \
        == "elementwise"


def test_bounds():
    # One row of 1000 live keys, 1 KV head of 128, 8 query heads, bf16:
    # bytes 1000*128*2*2 + 2*8*128*2 + 4 = 516,100 at 3.35e12.
    ms, by = _arith.bound_ms(1, 8, 1, 128, 2, [1000], "torch.bfloat16")
    assert by == "bytes" and ms == pytest.approx(516100 / 3.35e12 * 1e3)
    assert _arith.live_keys([0, 5, 5000], 4096, 3000, False) == [0, 5, 3000]
    assert _arith.visible_pairs(4, True, None) == 10
    assert _arith.visible_pairs(4, True, 2) == 3 + 2 * 2
    assert _arith.visible_pairs(4, False, None) == 16
    f = _arith.bwd_flops(1, 1, 128, 10)
    assert f == {"all": 5 * 256 * 10, "dq": 3 * 256 * 10, "dkv": 4 * 256 * 10}
    ms, by = _arith.fwd_bound_ms(1, 36, 4, 4096, 128, 2,
                                 _arith.visible_pairs(4096, True, 4096),
                                 "torch.bfloat16")
    assert by == "operations"
    assert ms == pytest.approx(4 * 128 * 36 * 4096 * 4097 / 2 / 989e12 * 1e3)
    assert _arith.mfu(989e12, 2.0) == pytest.approx(50.0)


def _serve_record():
    model = {"layers": 2, "heads": 4, "kv_heads": 2, "head_dim": 8,
             "window": 100, "block_params": 1000, "unembed_params": 50,
             "slots": 2, "max_len": 32, "block_size": 8, "chunk": 4,
             "lanes": 1}
    decode = [(np.array([3, 0]), np.array([True, False]))]
    prefill = [(np.array([2]), np.array([2]))]
    device = [("void paged_decode_kernel<bf16>", 0.0, 10.0),
              ("void paged_decode_kernel<bf16>", 5.0, 15.0),
              ("gemm", 100.0, 130.0)]
    profile = {"window_s": 200e-6, "busy_s": 45e-6, "device": device,
               "decode_calls": decode, "prefill_calls": prefill}
    window = {"seconds": 1.0, "decode_steps": 4, "decode_tokens": 6,
              "decode_ms": [1.0, 3.0], "prefill_ms": [2.0],
              "prefill_valid": 3, "prefill_capacity": 8,
              "ttft_p95_ms": 250.0, "tpot_p95_ms": float("nan")}
    return {"model": model, "profile": profile, "window": window}


def test_serve_readers():
    rec = _serve_record()
    read = lambda name: core.read_metric(name, rec)  # noqa: E731
    assert read("rows_per_decode.serve") == 1.5
    assert read("prefill_fill.serve") == pytest.approx(37.5)
    assert read("decode_step_ms.serve") == 2.0
    assert read("prefill_call_ms.serve") == 2.0
    assert read("idle_share.serve") == pytest.approx(77.5)
    assert read("ttft_p95_ms.serve") == 250.0
    assert read("tpot_p95_ms.serve") is None  # no request finished
    # Decode: 1 active row of 4 keys; prefill: 2 tokens at 2, 3 -> 3 + 4
    # keys; the unembedding for the decode row and the lane.
    flops = 2 * 1050 * 1 + 2 * 1000 * 2 + 2 * 50 + 4 * 8 * 4 * 2 * (4 + 7)
    assert read("mfu.serve") == pytest.approx(
        100 * flops / (200e-6 * 989e12))
    # K4: 20 us of device time over two launches a call (two layers).
    live = [4, 0]
    ms, _ = _arith.bound_ms(2, 4, 2, 8, 2, live, "torch.bfloat16",
                            extra_bytes=2 * 4 * 4)
    assert read("k4_roofline.serve") == pytest.approx(100 * 2 * ms / 0.02)


def test_readers_find_nothing_without_a_trace():
    rec = _serve_record()
    del rec["profile"]
    for name in ("k4_roofline.serve", "idle_share.serve", "mfu.serve"):
        assert core.read_metric(name, rec) is None


def test_train_readers():
    model = {"layers": 2, "heads": 4, "kv_heads": 2, "head_dim": 8,
             "window": 16, "seq": 16, "batch": 2, "block_params": 1000,
             "unembed_params": 50}
    device = [("void fwd_tc_kernel<8>", 0, 4),
              ("void fwd_tc_kernel<8>", 10, 14),
              ("void bwd_dq_tc_kernel<8>", 20, 23),
              ("void bwd_dkv_tc_kernel<8>", 30, 35)]
    profile = {"window_s": 1e-4, "busy_s": 0.5e-4, "device": device,
               "regions": {"optimizer_update": {"count": 2,
                                                "device_s": 0.004}},
               "steps": 2}
    rec = {"model": model, "profile": profile}
    pairs = _arith.visible_pairs(16, True, 16)
    k1, _ = _arith.fwd_bound_ms(2, 4, 2, 16, 8, 2, pairs, "torch.bfloat16")
    assert core.read_metric("k1_roofline.train", rec) == pytest.approx(
        100 * 2 * k1 / 0.008)
    b = _arith.bwd_bounds(2, 4, 2, 16, 8, 2, pairs, "torch.bfloat16")
    assert core.read_metric("k2_roofline.train", rec) == pytest.approx(
        100 * (b["dq"][0] + b["dkv"][0]) / 0.008)
    assert core.read_metric("optimizer_ms.train", rec) == pytest.approx(2.0)
    assert core.read_metric("idle_share.train", rec) == pytest.approx(50.0)
    step = 6 * 1050 * 32 + 3 * 4 * 8 * 4 * 2 * pairs * 2
    assert core.read_metric("mfu.train", rec) == pytest.approx(
        100 * 2 * step / (1e-4 * 989e12))
