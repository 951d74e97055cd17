"""Serving cells of a published mixture-of-experts config with mixed
layer kinds (Mellum2): the program's paged engine
(``paged.PagedBatcher``, built from ``ModelConfig.from_published``)
under the closed loop of :mod:`perfbench.drivers.serve`, whose loop,
call timing, tails and sampling this driver shares.

Set-up: the program's config is read from the configuration file's
published keys first, so a program that cannot run it fails before any
weight is made.  The weights are made on the device from the seed, a
leaf at a time, in bfloat16 (the stacked layout the file's ``as_run``
states: packed q|k|v, each expert's gate|up in ``w1``).  Warm-up, the
window, the end-to-end metrics and ``correct`` are :mod:`serve`'s, with
the plain reference of this block (:mod:`perfbench.reference.mellum`).

With ``trace`` the engine is handed the program's tracer
(``Tracer(recorder=spans.Sink())``): its spans land in the record under
``program``, and the MoE layers' device counter (a row per call of the
expert half: its group ends over the experts), reset before the
profiled ticks and read once after them, under ``profile.moe_calls``
as [assignments, experts that took a token] a call (:func:`moe_call`).
Untraced runs hand it none.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from perfbench import core, spans, trace as tracing
from perfbench.drivers.serve import (
    Calls,
    ClosedLoop,
    _by_fifth,
    _calls_summary,
    _sample,
    _tails,
)
from perfbench.workload import Stream

#: Keys of a configuration file that annotate the published config
#: (its provenance, the cut, the limits); the rest are published keys.
NOTES = ("name", "source", "reduced", "assumed", "as_run", "departures",
         "parameters", "kv_cache_bytes_per_token", "deployment", "limits")


def published(config: dict) -> dict:
    return {k: v for k, v in config.items() if k not in NOTES}


def param_shapes(config: dict) -> dict:
    """The program's layout for the config's published keys ('/'-joined
    paths): stacked layers, q|k|v columns, experts' gate|up packed."""
    L, d = config["num_hidden_layers"], config["hidden_size"]
    hd, V = config["head_dim"], config["vocab_size"]
    q = config["num_attention_heads"] * hd
    kv = config["num_key_value_heads"] * hd
    E, f = config["num_experts"], config["moe_intermediate_size"]
    return {"embed": (V, d), "blocks/qkv": (L, d, q + 2 * kv),
            "blocks/attn_out": (L, q, d), "blocks/router": (L, d, E),
            "blocks/w1": (L, E, d, 2 * f), "blocks/w2": (L, E, f, d),
            "blocks/ln1": (L, d), "blocks/ln2": (L, d), "ln_f": (d,),
            "unembed": (d, V)}


def make_weights(config: dict, seed: int, dtype, device) -> dict:
    """Every weight, each leaf from a stream of its own: normal with the
    config's ``initializer_range`` as deviation, gains of one."""
    import torch

    out = {}
    for path, shape in param_shapes(config).items():
        if core.is_gain(path):
            out[path] = torch.ones(shape, dtype=dtype, device=device)
            continue
        gen = core.torch_generator(seed, device, "weights", path)
        out[path] = torch.randn(shape, generator=gen, dtype=dtype,
                                device=device).mul_(
                                    config["initializer_range"])
    return core.nest(out)


def active_params(config: dict) -> dict:
    """Matrix parameters a token goes through in one layer (attention,
    the router and its k experts) and in the unembedding."""
    d, hd = config["hidden_size"], config["head_dim"]
    q = config["num_attention_heads"] * hd
    kv = config["num_key_value_heads"] * hd
    f, k = config["moe_intermediate_size"], config["num_experts_per_tok"]
    return {"layer": d * (q + 2 * kv) + q * d + d * config["num_experts"]
            + k * (d * 2 * f + f * d),
            "unembed": d * config["vocab_size"]}


def _model(config: dict, eng: dict) -> dict:
    kinds = config["layer_types"]
    windows = {"sliding_attention": config["sliding_window"],
               "full_attention": None}
    act = active_params(config)
    return {"layers": config["num_hidden_layers"],
            "heads": config["num_attention_heads"],
            "kv_heads": config["num_key_value_heads"],
            "head_dim": config["head_dim"], "d_model": config["hidden_size"],
            "kinds": [{"kind": kind, "window": windows[kind],
                       "layers": kinds.count(kind)}
                      for kind in dict.fromkeys(kinds)],
            "experts": config["num_experts"],
            "top_k": config["num_experts_per_tok"],
            "expert_ff": config["moe_intermediate_size"],
            "active_layer_params": act["layer"] * config["num_hidden_layers"],
            "unembed_params": act["unembed"],
            "slots": eng["slots"], "max_len": eng["max_len"],
            "block_size": eng["block_size"], "chunk": eng["chunk"],
            "lanes": eng["prefill_lanes"]}


def moe_call(ends) -> list[int]:
    """[assignments, experts that took a token] of one call of the
    expert half, from its group ends over the experts (the program's
    ``serve.moe`` counter row)."""
    starts = [0, *ends[:-1]]
    return [int(ends[-1]), sum(e > s for s, e in zip(starts, ends))]


def _kv_bytes(config: dict, eng: dict, blocks: list) -> dict:
    block = (2 * config["num_hidden_layers"] * config["num_key_value_heads"]
             * config["head_dim"] * 2 * eng["block_size"])
    return {"kv_pool_bytes": block * eng["num_blocks"],
            "kv_live_bytes_mean": block * float(np.mean(blocks))
            if blocks else 0.0,
            "kv_live_bytes_peak": block * max(blocks, default=0)}


def run(cell: core.Cell, *, seed: int, seconds: float, trace: bool, device,
        started: float, control: bool = False) -> core.Outcome:
    import torch

    from tpu_autoscaler_torch.obs.trace import Tracer
    from tpu_autoscaler_torch.workloads.model import ModelConfig
    from tpu_autoscaler_torch.workloads.paged import PagedBatcher
    from tpu_autoscaler_torch.workloads.serving import Request

    config, mix = cell.config, cell.mix
    eng = mix["engine"]
    cfg = ModelConfig.from_published(published(config),
                                     seq_len=eng["max_len"],
                                     dtype=torch.bfloat16)
    sink = spans.Sink() if trace else None
    weights = make_weights(config, seed, torch.bfloat16, device)
    engine = PagedBatcher(
        weights, cfg, slots=eng["slots"], max_len=eng["max_len"],
        block_size=eng["block_size"], num_blocks=eng["num_blocks"],
        chunk=eng["chunk"], prefill_lanes=eng["prefill_lanes"],
        device=device,
        tracer=None if sink is None else Tracer(recorder=sink))
    del weights
    calls = Calls(torch, engine) if trace else None
    loop = ClosedLoop(engine, Stream(mix, seed, config["vocab_size"]),
                      mix["clients"], mix["warmup"]["cohort"], Request)
    warm = mix["warmup"]
    for _ in range(warm["max_ticks"]):
        if not loop.pending(warm["until"]):
            break
        loop.tick()
    else:
        raise RuntimeError(f"warm-up did not reach {warm['until']!r} in "
                           f"{warm['max_ticks']} ticks")
    for _ in range(warm["settle_ticks"]):
        loop.tick()
    core.sync(device)
    setup_s = time.perf_counter() - started

    steps0, tokens0 = engine.decode_steps, engine.decode_tokens
    if calls is not None:
        calls.bucket = sink.bucket = "window"
    loop.window = True
    t0 = time.perf_counter()
    marks, blocks = [], []
    while time.perf_counter() - t0 < seconds:
        loop.tick()
        marks.append((time.perf_counter() - t0, loop.emitted))
        blocks.append(engine.allocator.used_blocks)
    window_s = time.perf_counter() - t0
    loop.window = False

    record = {"model": _model(config, eng),
              "window": {"seconds": window_s,
                         "decode_steps": engine.decode_steps - steps0,
                         "decode_tokens": engine.decode_tokens - tokens0}}
    profiled = None
    if calls is not None:
        record["window"].update(_calls_summary(calls, "window", eng))
        calls.bucket = sink.bucket = "profile"
        counter = engine._tracer.counter("serve.moe")
        core.sync(device)
        counter.reset()

        def ticks():
            for _ in range(mix["profile_ticks"]):
                with tracing.region("tick"):
                    loop.tick()

        profiled = tracing.profile(torch, ticks)
        calls.bucket = sink.bucket = None
        profiled["ticks"] = mix["profile_ticks"]
        profiled["decode_calls"] = calls.meta("profile", "decode_step")
        profiled["prefill_calls"] = calls.meta("profile", "prefill_call")
        profiled["moe_calls"] = [moe_call(ends) for ends in counter.read()]
        profiled["moe_calls_dropped"] = counter.dropped
        record["profile"] = profiled
        record["program"] = sink.buckets

    done = loop.finished
    e2e = {"setup_s": setup_s, "serve_tokens_per_s": loop.emitted / window_s,
           **_tails(loop.ttft, done)}
    record["window"].update(e2e)
    short = sum(len(f.req.generated) != f.req.max_new_tokens for f in done)
    attempted, failed = len(done) + loop.refused, loop.refused
    sample = _sample(done, seed, mix["check"]["requests"])
    device_rec = core.device_info(torch, cell.chips, profiled, device)
    finished_per_s = len(done) / window_s
    del engine, loop, calls, done
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    gap, control_gap, served = check(config, seed, sample, device, control)
    limit = config["limits"]["serve"]["served_logit_gap"]
    return core.Outcome(
        e2e=e2e, record=record, attempted=attempted, failed=failed,
        checks=[core.Check("served_logit_gap", gap, limit),
                core.Check("short_answers", float(short), 0.0)],
        device=device_rec, traced=profiled,
        control={"served_logit_gap": control_gap} if control else None,
        notes={"check_s": time.perf_counter() - t_check,
               "served_tokens_checked": served,
               "finished_requests_per_s": finished_per_s,
               "tokens_per_s_by_fifth": _by_fifth(marks, window_s),
               **_kv_bytes(config, eng, blocks)})


def check(config: dict, seed: int, sample: list, device, control: bool):
    """(widest gap of a served token below the reference's best, the
    control's widest gap or None, tokens checked), as
    :func:`perfbench.drivers.serve.check` reads them, against this
    block's reference."""
    import torch

    from perfbench.reference import control as ctl, mellum as ref

    ref.strict_f32()
    if not sample:
        return float("inf"), None, 0
    weights = make_weights(config, seed, torch.bfloat16, device)
    widest, widest_control, served = 0.0, 0.0, 0
    for prompt, gen in sample:
        ids = torch.from_numpy(np.concatenate([prompt, gen[:-1]])).to(device)
        rows = torch.arange(len(prompt) - 1, len(prompt) - 1 + len(gen),
                            device=device)
        logits = ref.logits_at(weights, ids, config, rows)
        best = logits.max(dim=-1).values
        want = torch.from_numpy(gen).to(device)
        gaps = best - logits.gather(1, want[:, None])[:, 0]
        widest = max(widest, float(gaps.max()))
        served += len(gen)
        if control:
            low = ref.logits_at(weights, ids, config, rows,
                                quant=ctl.fp8_linear)
            pick = low.argmax(dim=-1)
            gaps = best - logits.gather(1, pick[:, None])[:, 0]
            widest_control = max(widest_control, float(gaps.max()))
        del logits
    return widest, (widest_control if control else None), served
