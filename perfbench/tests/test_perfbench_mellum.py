"""The Mellum2 serving cell and the short-sequence training cell: the
``serve_moe`` driver end to end on the CPU at a tiny size, its
reference's imports, the expert layer's readers on known records, and
the two new mixes' stated sizes."""

import copy
import json
import math
import statistics
import subprocess
import sys
import time

import pytest
import torch

from perfbench import core, workload
from perfbench.metrics import _arith, _moe_arith

#: Mellum2's published keys at a tiny size (the real file's other keys
#: and its limits kept): 4 layers s, s, s, f with a window of 8, head_dim
#: 32 against d / heads = 16, 16 experts top 4, YaRN over 16 positions.
TINY_MELLUM = {"vocab_size": 512, "hidden_size": 64, "num_hidden_layers": 4,
               "num_attention_heads": 4, "num_key_value_heads": 2,
               "head_dim": 32, "num_experts": 16, "num_experts_per_tok": 4,
               "moe_intermediate_size": 32, "sliding_window": 8,
               "layer_types": ["sliding_attention"] * 3 + ["full_attention"],
               "mlp_layer_types": ["sparse"] * 4}


def tiny_mellum_cell() -> core.Cell:
    c = core.load_cell("mellum2-12b.complete.8k")
    c.config = copy.deepcopy(c.config)
    # The same weight scale per unit of width as the real config's.
    c.config["initializer_range"] *= (
        c.config["hidden_size"] / TINY_MELLUM["hidden_size"]) ** 0.5
    c.config.update(TINY_MELLUM)
    c.config["rope_parameters"]["full_attention"].update(
        original_max_position_embeddings=16, factor=4)
    c.mix = copy.deepcopy(c.mix)
    c.mix.update(clients=4, block=8,
                 prompt={"median": 20, "sigma": 0.5, "lo": 8, "hi": 40},
                 output={"median": 12, "sigma": 0.5, "lo": 4, "hi": 24},
                 engine={"slots": 4, "max_len": 64, "block_size": 8,
                         "num_blocks": 32, "chunk": 16, "prefill_lanes": 2},
                 check={"requests": 8})
    return c


def test_the_moe_driver_serves_a_tiny_cell_correctly():
    from perfbench.run import measure

    cell = tiny_mellum_cell()
    assert [m["name"] for m in cell.end_to_end] == [
        "serve_tokens_per_s", "tpot_p95_ms", "setup_s"]
    r = measure(cell, seed=2**31 + 77, seconds=6.0, trace=False,
                device=torch.device("cpu"), started=time.perf_counter())
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 4
    assert r["notes"]["served_tokens_checked"] > 0
    assert set(r["metrics"]) == {"serve_tokens_per_s", "tpot_p95_ms",
                                 "setup_s"}


def test_a_parent_without_the_block_fails_before_any_weight():
    """The cell on a program whose config lacks the published reader
    fails at once (the driver reads the config first)."""
    from perfbench.drivers import serve_moe
    from tpu_autoscaler_torch.workloads import model

    cell = tiny_mellum_cell()
    saved = model.ModelConfig.from_published
    del model.ModelConfig.from_published
    try:
        with pytest.raises(AttributeError):
            serve_moe.run(cell, seed=1, seconds=1.0, trace=False,
                          device="cpu", started=time.perf_counter())
    finally:
        model.ModelConfig.from_published = saved


def test_the_mellum_reference_loads_neither_jax_nor_the_program():
    out = subprocess.run(
        [sys.executable, "-c", "import perfbench.reference.mellum, sys\n"
         "print(sorted({m.split('.')[0] for m in sys.modules}))"],
        cwd=core.REPO, capture_output=True, text=True, timeout=600,
        check=True)
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "torch" in tops
    assert not tops & {*core.FORBIDDEN_MODULES, "tpu_autoscaler_torch"}


def _model_record():
    return {"d_model": 2304, "expert_ff": 896, "heads": 32, "head_dim": 128,
            "active_layer_params": 1000, "unembed_params": 100,
            "kinds": [{"kind": "sliding_attention", "window": 4,
                       "layers": 3},
                      {"kind": "full_attention", "window": None,
                       "layers": 1}]}


def _read(name, record):
    return core.read_metric(name, record)


def test_expert_gemm_ms_reads_the_grouped_kernels_per_tick():
    record = {"model": _model_record(), "profile": {"ticks": 2, "device": [
        ("_ZN7cutlass13device_kernelI...GroupProblemShape...", 0.0, 1000.0),
        ("void at::cuda::detail::prepare_grouped_gemm_data<...>", 1000.0,
         1100.0),
        ("sm90_xmma_gemm_bf16bf16", 0.0, 5000.0)]}}
    assert _read("expert_gemm_ms.serve", record) == pytest.approx(0.55)
    record["profile"]["device"] = record["profile"]["device"][2:]
    assert _read("expert_gemm_ms.serve", record) is None
    assert _read("expert_gemm_ms.serve", {"model": {}}) is None


def test_expert_gemm_roofline_is_the_counted_least_time_over_device_time():
    d, f = 2304, 896
    calls = [[192, 57], [16384, 61]]
    record = {"model": _model_record(), "profile": {
        "ticks": 1, "moe_calls": calls,
        "device": [("GroupProblemShape", 0.0, 900.0)]}}
    # Each call: the weights of the experts that took a token and the
    # activations in and out (d, 2 f; f, d), or 2 flops a weight
    # element an assignment, whichever takes longer.
    def least_ms(n, hit):
        moved = (hit * (d * 2 * f + f * d) + n * (2 * d + 3 * f)) * 2
        flops = 2 * n * (d * 2 * f + f * d)
        return 1e3 * max(moved / _arith.HBM_BYTES_PER_S,
                         flops / _arith.BF16_OPS_PER_S)

    want = least_ms(192, 57) + least_ms(16384, 61)
    # Decode's call is bound by its bytes (the weights of 57 experts).
    assert _moe_arith.expert_bound_ms(192, 57, d, f) == pytest.approx(
        1e3 * (57 * 6193152 + 192 * 7296) * 2 / _arith.HBM_BYTES_PER_S)
    assert _read("expert_gemm_roofline.serve", record) == pytest.approx(
        100 * want / 0.9)
    record["profile"]["moe_calls"] = []
    assert _read("expert_gemm_roofline.serve", record) is None


def test_mfu_moe_counts_active_params_and_each_kinds_pairs():
    record = {"model": _model_record(), "profile": {
        "window_s": 1.0,
        # One active decode row at position 5 (the other row idle), one
        # lane of 3 prompt tokens from position 0.
        "decode_calls": [([5, 2000], [True, False])],
        "prefill_calls": [([0, 0], [3, 0])]}}
    # Pairs: decode 3 window layers * min(6, 4) + 6 = 18; prefill
    # 3 * (1 + 2 + 3) + 6 = 24.
    flops = 2 * 1000 * 4 + 2 * 100 * 2 + 4 * 128 * 32 * 42
    assert _read("mfu.moe.serve", record) == pytest.approx(
        100 * flops / _arith.BF16_OPS_PER_S)
    assert _read("mfu.moe.serve", {"model": {"kinds": []}}) is None


def test_k4_roofline_moe_bounds_each_kinds_launches_by_its_window():
    record = {"model": {**_model_record(), "kv_heads": 4, "slots": 2,
                        "max_len": 64, "block_size": 16},
              "profile": {"device": [("paged_decode_kernel<128>", 0.0,
                                      400.0),
                                     ("sm90_xmma_gemm_bf16bf16", 0.0,
                                      9000.0)],
                          # Row 0 at length 9 sees 10 keys, row 1 idle.
                          "decode_calls": [([9, 0], [True, False])]}}

    def least_ms(live):
        # Each live K/V row once, q and out, the lengths and the table.
        moved = live * 4 * 128 * 2 * 2 + 2 * 2 * 32 * 128 * 2 + 4 * 2 \
            + 2 * 4 * 4
        return 1e3 * max(moved / _arith.HBM_BYTES_PER_S,
                         4 * 128 * 32 * live / _arith.BF16_OPS_PER_S)

    # 3 window layers see min(10, 4) keys, the full layer all 10.
    want = 3 * least_ms(4) + least_ms(10)
    assert _read("k4_roofline.moe.serve", record) == pytest.approx(
        100 * want / 0.4)
    record["profile"]["device"] = record["profile"]["device"][1:]
    assert _read("k4_roofline.moe.serve", record) is None
    assert _read("k4_roofline.moe.serve", {"model": {}}) is None


def test_the_counter_rows_read_as_assignments_and_experts_hit():
    from perfbench.drivers.serve_moe import moe_call

    assert moe_call([0, 3, 3, 7, 7, 8]) == [8, 3]
    assert moe_call([4, 4, 4]) == [4, 1]
    assert moe_call([0, 0]) == [0, 0]


def _mix(name):
    return json.loads(core.traffic_path(name).read_text())


def test_complete_8k_keeps_its_medians_and_clips():
    mix = _mix("complete.8k")
    assert mix["driver"] == "serve_moe"
    assert mix["prompt"] == {"median": 6144, "sigma": 0.4, "lo": 2048,
                             "hi": 16256}
    assert mix["output"] == {"median": 32, "sigma": 0.75, "lo": 8, "hi": 128}
    eng = mix["engine"]
    assert eng["slots"] == mix["clients"]
    assert eng["num_blocks"] == mix["clients"] * eng["max_len"] \
        // eng["block_size"]
    stream = workload.Stream(mix, 2**33 + 5, 98304)
    sizes = [stream.sizes(k) for k in range(4 * mix["block"])]
    for i, law in ((0, mix["prompt"]), (1, mix["output"])):
        values = [s[i] for s in sizes]
        assert min(values) >= law["lo"] and max(values) <= law["hi"]
        assert abs(statistics.median(values) / law["median"] - 1) < 0.02
    # Every request fits its slot, padded to whole chunks.
    hi = mix["prompt"]["hi"]
    assert math.ceil(hi / eng["chunk"]) * eng["chunk"] <= eng["max_len"]
    assert hi + mix["output"]["hi"] <= eng["max_len"]


def test_train_s1024_is_s4096s_step_at_a_quarter_of_the_length():
    short, long = _mix("train.s1024"), _mix("train.s4096")
    assert (short["batch"], short["seq"]) == (16, 1024)
    assert short["batch"] * short["seq"] == long["batch"] * long["seq"]
    for key in ("driver", "remat", "ce_chunk", "optimizer", "profile_steps"):
        assert short[key] == long[key]
