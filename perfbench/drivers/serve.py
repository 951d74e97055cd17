"""Serving cells: the program's paged engine (``paged.PagedBatcher``,
driven by ``submit`` and ``tick`` as ``serve --paged`` drives it) under
a closed loop of clients with no think time.

Set-up: the weights are made on the device from the seed in bfloat16,
the type they are served in; the engine is built with the mix's
settings; the cohort (one request per client, :mod:`perfbench.workload`)
is submitted and the engine ticks until the mix's warm-up condition
holds and ``settle_ticks`` more have run.  Every shape the window uses
(the one decode step, the one prefill call) has then run.  The window
ticks until ``seconds`` have passed; each tick ends with the sampled
tokens on the host, so the host clock after a tick is when its tokens
exist.  A finished request's client submits its next at once.

End-to-end metrics, over the window: generated tokens over its seconds;
the 95th percentile of time to first token of every request whose first
token came in it, from its submission; the 95th percentile of the time
per output token, (last - first) / (n - 1), of every request finished
in it.

``correct``: a sample of the requests finished in the window, drawn
from the seed with the longest among them, is run through the plain
reference (f32, a layer at a time) over its prompt and served tokens;
the widest gap by which a served (greedy) token's reference logit lies
below the reference's best must stay within the config's limit, and
every finished request must have all the tokens it asked for.

With ``trace``, CUDA events time every call of the engine's decode step
and prefill in the window, and ``profile_ticks`` further ticks run
under the profiler (after the window, so the window is not slowed).
"""

from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np

from perfbench import core, trace as tracing
from perfbench.workload import Stream


@dataclasses.dataclass
class Flight:
    req: object
    client: int
    submitted: float
    cohort: bool
    first: float | None = None
    last: float | None = None
    seen: int = 0


class ClosedLoop:
    """Clients that each send their next request as the last one
    finishes; host-clock bookkeeping of every token's arrival."""

    def __init__(self, engine, stream: Stream, clients: int, cohort: str,
                 make_request, clock=time.perf_counter):
        self.engine, self.stream, self.make = engine, stream, make_request
        self.clock = clock
        self.flights: list[Flight] = []
        self.window = False
        self.emitted = 0
        self.ttft: list[float] = []
        self.finished: list[Flight] = []
        self.refused = 0
        for c, (ids, budget) in enumerate(stream.cohort(clients, cohort)):
            self._submit(c, ids, budget, cohort=True)
        self.next_k = clients if cohort == "fresh" else 0

    def _submit(self, client: int, ids, budget: int, cohort: bool = False):
        req = self.make(prompt=ids, max_new_tokens=budget)
        now = self.clock()
        try:
            self.engine.submit(req)
        except ValueError:
            if self.window:
                self.refused += 1
            return
        self.flights.append(Flight(req, client, now, cohort))

    def pending(self, until: str) -> bool:
        """Whether the cohort has not yet reached ``until``: every
        cohort request ``seeded`` (its first token out) or
        ``finished``."""
        if until == "seeded":
            return any(f.cohort and f.seen == 0 for f in self.flights)
        if until == "finished":
            return any(f.cohort for f in self.flights)
        raise ValueError(f"unknown warm-up condition {until!r}")

    def tick(self) -> None:
        self.engine.tick()
        now = self.clock()
        keep, done = [], []
        for f in self.flights:
            n = len(f.req.generated)
            if n > f.seen:
                if f.seen == 0:
                    f.first = now
                    if self.window:
                        self.ttft.append(now - f.submitted)
                if self.window:
                    self.emitted += n - f.seen
                f.seen, f.last = n, now
            (done if f.req.done else keep).append(f)
        self.flights = keep
        for f in done:
            if self.window:
                self.finished.append(f)
            ids, budget = self.stream.request(self.next_k)
            self.next_k += 1
            self._submit(f.client, ids, budget)


class Calls:
    """CUDA events and arguments of every call of the engine's decode
    step and prefill while ``bucket`` is set (the harness's wrapper
    around the engine's step functions; the program is not edited)."""

    def __init__(self, torch, engine):
        self.torch = torch
        self._decode, self._prefill = engine._decode, engine._prefill
        engine._decode, engine._prefill = self.decode, self.prefill
        self.bucket = None
        self.log: dict[str, dict[str, list]] = {}

    def _timed(self, kind, fn, meta, *args):
        if self.bucket is None:
            return fn(*args)
        ev = [self.torch.cuda.Event(enable_timing=True) for _ in range(2)]
        with tracing.region(kind):
            ev[0].record()
            out = fn(*args)
            ev[1].record()
        self.log.setdefault(self.bucket, {}).setdefault(kind, []).append(
            (ev, meta))
        return out

    def decode(self, params, cache, tables, tokens, active):
        meta = (cache.lengths.numpy().copy(), active.numpy().copy())
        return self._timed("decode_step", self._decode, meta, params, cache,
                           tables, tokens, active)

    def prefill(self, params, cache, tables, tokens, offsets, n_valid):
        meta = (offsets.numpy().copy(), n_valid.numpy().copy())
        return self._timed("prefill_call", self._prefill, meta, params,
                           cache, tables, tokens, offsets, n_valid)

    def ms(self, bucket: str, kind: str) -> list[float]:
        self.torch.cuda.synchronize()
        return [a.elapsed_time(b) for (a, b), _ in
                self.log.get(bucket, {}).get(kind, [])]

    def meta(self, bucket: str, kind: str) -> list:
        return [m for _, m in self.log.get(bucket, {}).get(kind, [])]


def run(cell: core.Cell, *, seed: int, seconds: float, trace: bool, device,
        started: float, control: bool = False) -> core.Outcome:
    import torch

    from tpu_autoscaler_torch.workloads.paged import PagedBatcher
    from tpu_autoscaler_torch.workloads.serving import Request

    config, mix = cell.config, cell.mix
    eng = mix["engine"]
    cfg = core.port_config(config, seq_len=eng["max_len"])
    weights = core.make_weights(config, seed, torch.bfloat16, device)
    engine = PagedBatcher(
        weights, cfg, slots=eng["slots"], max_len=eng["max_len"],
        block_size=eng["block_size"], num_blocks=eng["num_blocks"],
        chunk=eng["chunk"], prefill_lanes=eng["prefill_lanes"],
        device=device)
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
        calls.bucket = "window"
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
        calls.bucket = "profile"

        def ticks():
            for _ in range(mix["profile_ticks"]):
                with tracing.region("tick"):
                    loop.tick()

        profiled = tracing.profile(torch, ticks)
        calls.bucket = None
        profiled["decode_calls"] = calls.meta("profile", "decode_step")
        profiled["prefill_calls"] = calls.meta("profile", "prefill_call")
        record["profile"] = profiled

    done = loop.finished
    e2e = {"setup_s": setup_s, "serve_tokens_per_s": loop.emitted / window_s,
           **_tails(loop.ttft, done)}
    record["window"].update(e2e)
    short = sum(len(f.req.generated) != f.req.max_new_tokens for f in done)
    attempted, failed = len(done) + loop.refused, loop.refused
    sample = _sample(done, seed, mix["check"]["requests"])
    device_rec = core.device_info(torch, cell.chips, profiled, device)
    del engine, loop, calls, done
    gc.collect()
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
               "tokens_per_s_by_fifth": _by_fifth(marks, window_s),
               **_kv_bytes(config, eng, blocks)})


def _tails(ttft: list, done: list) -> dict:
    """The 95th percentiles, in ms, of time to first token and of time
    per output token (NaN without a sample)."""
    tpot = [(f.last - f.first) / (f.seen - 1) for f in done if f.seen > 1]
    return {name: core.percentile(v, 95) * 1e3 if v else float("nan")
            for name, v in (("ttft_p95_ms", ttft), ("tpot_p95_ms", tpot))}


def _by_fifth(marks: list, window_s: float) -> list[float]:
    """Tokens a second in each fifth of the window, from (seconds since
    its start, tokens emitted so far) after every tick: a drift across
    the window shows as a trend."""
    out, done, at = [], 0, 0
    for i in range(1, 6):
        edge = window_s * i / 5
        while at < len(marks) and marks[at][0] <= edge:
            at += 1
        upto = marks[at - 1][1] if at else 0
        out.append((upto - done) / (window_s / 5))
        done = upto
    return out


def _kv_bytes(config: dict, eng: dict, blocks: list) -> dict:
    """The pool's size and the KV it held over the window (the
    allocator's blocks in use after each tick, times a block's bytes)."""
    heads = config["num_attention_heads"]
    block = (2 * config["num_hidden_layers"] * config["num_key_value_heads"]
             * (config["hidden_size"] // heads) * 2 * eng["block_size"])
    return {"kv_pool_bytes": block * eng["num_blocks"],
            "kv_live_bytes_mean": block * float(np.mean(blocks))
            if blocks else 0.0,
            "kv_live_bytes_peak": block * max(blocks, default=0)}


def _model(config: dict, eng: dict) -> dict:
    heads = config["num_attention_heads"]
    return {"layers": config["num_hidden_layers"], "heads": heads,
            "kv_heads": config["num_key_value_heads"],
            "head_dim": config["hidden_size"] // heads,
            "window": config["sliding_window"],
            "block_params": core.matmul_params(config),
            "unembed_params": core.unembed_params(config),
            "slots": eng["slots"], "max_len": eng["max_len"],
            "block_size": eng["block_size"], "chunk": eng["chunk"],
            "lanes": eng["prefill_lanes"]}


def _calls_summary(calls: Calls, bucket: str, eng: dict) -> dict:
    valid = sum(int(n.sum()) for _, n in calls.meta(bucket, "prefill_call"))
    n_calls = len(calls.meta(bucket, "prefill_call"))
    return {"decode_ms": calls.ms(bucket, "decode_step"),
            "prefill_ms": calls.ms(bucket, "prefill_call"),
            "prefill_valid": valid,
            "prefill_capacity": n_calls * eng["prefill_lanes"] * eng["chunk"]}


def _sample(done: list, seed: int, n: int) -> list:
    """The requests to check: the one with the most served tokens and
    n - 1 others drawn from the seed; (prompt, served) each."""
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: len(done[i].req.generated))
    rest = [i for i in range(len(done)) if i != longest]
    pick = core.rng(seed, "check").permutation(len(rest))[:n - 1]
    chosen = [longest] + [rest[i] for i in sorted(pick)]
    return [(np.asarray(done[i].req.prompt, np.int64),
             np.asarray(done[i].req.generated, np.int64)) for i in chosen]


def check(config: dict, seed: int, sample: list, device, control: bool):
    """(widest gap of a served token below the reference's best, the
    control's widest gap or None, tokens checked): the reference over
    each sampled prompt and its served tokens, teacher-forced."""
    import torch

    from perfbench.reference import control as ctl, model as ref

    ref.strict_f32()
    if not sample:
        return float("inf"), None, 0
    weights = core.make_weights(config, seed, torch.bfloat16, device)
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
