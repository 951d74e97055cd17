"""Runnable continuous-batching server CLI, on PyTorch.

``python -m tpu_autoscaler_torch.workloads.serve --checkpoint-dir ...
--requests reqs.jsonl`` loads the latest parameter checkpoint
(``step_N/params.npz``, written by ``model.save_params``) and drives
the ContinuousBatcher (workloads/serving.py) over a batch of
mixed-length requests.  Requests are JSON lines:

    {"prompt": [3, 17, 4], "max_new_tokens": 16}
    {"prompt": [9], "max_new_tokens": 8, "temperature": 0.8,
     "top_k": 40, "eos_id": 0}

(or ``--random N`` synthesizes N random requests).  Output is one JSON
line per request, in submission order:

    {"id": 0, "prompt_len": 3, "tokens": [..generated..], "done": true}

followed by ONE machine-readable final-stats line — the drain
contract's receipt, typed as ``serving.drain.DrainReceipt``:

    {"event": "final_stats", "served": N, "unserved": M,
     "drained": bool, "request_latency_ticks": [...], "stats": {...}}

``--final-stats PATH`` additionally writes the same object to a file.
The server runs on CUDA unless ``--platform cpu`` is given; without a
GPU it refuses to start rather than run on the CPU.

Model flags must match the checkpoint (shared block in _cli.py);
``--ring`` turns on the O(window) ring cache for windowed models, and
``--paged`` the paged cache (workloads/paged.py): a block pool shared by
all slots, per-slot block tables, preemption under pool pressure.
``--spec-k K`` (with ``--paged``) serves speculatively
(workloads/spec_serving.py): the target's first ``--draft-layers``
layers propose K tokens a round and the target verifies them in one
pass.  ``--trace-sample RATE`` samples per-request span trees
(serving/reqtrace.py) and also hands the engine a tracer
(``obs/trace.py``) that opens the tick's spans (``serve.tick``,
``serve.prefill.step``, ``serve.sync``, ... and each request's
``serve.request.prefill``: ``serving.ContinuousBatcher``); the receipt
then carries a ``trace`` field, the sampler's counters and, under
``spans``, each span name's ``count``, ``total_s`` and ``p95_ms``:

    "trace": {"sample_rate": 0.1, ..., "spans": {"serve.tick":
              {"count": 212, "total_s": 9.87, "p95_ms": 61.2}, ...}}
``--tp N`` (> 1) serves under a (data, model) mesh of the visible
devices (``model.make_mesh``; when N exceeds them the ranks repeat them
round-robin): the params placed once per rank, the slots cut over the
data rows and the KV heads over 'model' (``--paged``: one pool cut over
KV heads, on TP-only meshes).
"""

from __future__ import annotations

import json
import logging
import sys
import time

import click
import numpy as np

from tpu_autoscaler_torch.workloads._cli import (
    device_count,
    model_arch_options,
    model_config,
    serving_mesh,
)

log = logging.getLogger(__name__)


def final_stats_receipt(reqs, engine, elapsed_s: float,
                        replica_id: str = ""):
    """The drain contract's machine-readable receipt, built as the
    typed :class:`~tpu_autoscaler_torch.serving.drain.DrainReceipt`:
    what was served, what was not, per-request latencies split into
    queue-wait vs execute, and the engine's final stats snapshot."""
    from tpu_autoscaler_torch.serving.drain import DrainReceipt

    latencies = [
        (r.finished_tick - r.submitted_tick
         if r.done and r.finished_tick is not None
         and r.submitted_tick is not None else None)
        for r in reqs]
    waits = [
        (r.first_scheduled_tick - r.submitted_tick
         if r.first_scheduled_tick is not None
         and r.submitted_tick is not None else None)
        for r in reqs]
    execs = [
        (lat - w if lat is not None and w is not None else None)
        for lat, w in zip(latencies, waits)]
    return DrainReceipt(
        served=sum(1 for r in reqs if r.done),
        unserved=sum(1 for r in reqs if not r.done),
        drained=bool(engine.draining),
        elapsed_s=round(elapsed_s, 3),
        ticks=int(engine.ticks),
        decode_tokens=int(engine.decode_tokens),
        request_latency_ticks=tuple(latencies),
        request_wait_ticks=tuple(waits),
        request_exec_ticks=tuple(execs),
        stats=engine.stats().as_dict(),
        replica=replica_id)


def final_stats_payload(reqs, engine, elapsed_s: float,
                        replica_id: str = "") -> dict:
    """Wire-dict form of :func:`final_stats_receipt` (the historical
    key set; older consumers parse it unchanged)."""
    return final_stats_receipt(reqs, engine, elapsed_s,
                               replica_id).to_payload()


def _read_requests(requests_file, random_n, max_new_tokens, seed, cfg):
    from tpu_autoscaler_torch.workloads.serving import Request

    reqs: list[Request] = []
    if random_n is not None:
        rng = np.random.default_rng(seed)
        for _ in range(random_n):
            plen = int(rng.integers(1, max(2, cfg.seq_len // 2)))
            reqs.append(Request(
                prompt=rng.integers(0, cfg.vocab, (plen,)).astype(
                    np.int32),
                max_new_tokens=int(rng.integers(1, max_new_tokens + 1))))
        return reqs
    src = sys.stdin if requests_file == "-" else open(requests_file)
    try:
        for n, line in enumerate(src):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
                reqs.append(Request(
                    prompt=np.asarray(obj["prompt"], np.int32),
                    max_new_tokens=int(
                        obj.get("max_new_tokens", max_new_tokens)),
                    temperature=float(obj.get("temperature", 0.0)),
                    top_k=obj.get("top_k"),
                    top_p=obj.get("top_p"),
                    eos_id=obj.get("eos_id")))
            except (KeyError, ValueError, TypeError) as e:
                raise click.UsageError(
                    f"bad request on line {n + 1}: {e}") from e
    finally:
        if src is not sys.stdin:
            src.close()
    return reqs


@click.command()
@click.option("--checkpoint-dir", default="/tmp/tpu-train-ckpt",
              show_default=True,
              help="Directory of step_N/params.npz parameter "
                   "checkpoints; the largest N is served.")
@click.option("--requests", "requests_file", default=None,
              help="JSONL file of requests (see module docstring); "
                   "'-' reads stdin.")
@click.option("--random", "random_n", default=None, type=int,
              help="Synthesize N random requests instead of --requests.")
@click.option("--max-new-tokens", default=16, show_default=True,
              help="Default/maximum for --random requests.")
@click.option("--slots", default=4, show_default=True,
              help="Concurrent sequences resident in the cache.")
@click.option("--max-len", default=256, show_default=True,
              help="Per-slot cache capacity (prompt + generation).")
@click.option("--chunk", default=32, show_default=True,
              help="Prefill chunk size (one chunk per engine tick).")
@click.option("--ring", is_flag=True,
              help="Ring cache: O(--attention-window) per-slot memory, "
                   "unbounded sequence length (needs a window).")
@click.option("--paged", is_flag=True,
              help="Paged KV cache (workloads/paged.py): block pool + "
                   "per-slot block tables, on-demand growth, batched "
                   "prefill; memory scales with LIVE tokens, not "
                   "slots x max-len.  Mutually exclusive with --ring.")
@click.option("--block-size", default=16, show_default=True,
              help="Paged cache block size (tokens per pool block).")
@click.option("--num-blocks", default=None, type=int,
              help="Paged pool size in blocks (default: worst case "
                   "slots * max-len / block-size; smaller pools "
                   "oversubscribe memory and preempt under pressure).")
@click.option("--spec-k", default=0, show_default=True,
              help="Speculative decoding inside the paged engine "
                   "(needs --paged): a draft proposes K tokens per "
                   "round, the target verifies them in one pass per "
                   "round.  0 = off.")
@click.option("--draft-layers", default=1, show_default=True,
              help="Draft model = the target's first N layers "
                   "(with --spec-k).")
@click.option("--tp", "tp_degree", default=None, type=int,
              help="Serve under a (data, model) mesh: slots shard over "
                   "data, KV heads + cache over 'model' (the trainer's "
                   "TP layout).  Default: single-device.  Above the "
                   "device count the ranks repeat the devices.")
@click.option("--seed", default=0, show_default=True)
@click.option("--final-stats", "final_stats_file", default=None,
              help="Also write the final-stats JSON (the drain "
                   "contract's receipt) to this path; it is always "
                   "printed as the last stdout line.")
@click.option("--replica-id", default="",
              help="This replica's fleet id, stamped into the drain "
                   "receipt.")
@click.option("--annotations-file", default=None,
              help="Downward-API annotations path for the drain "
                   "contract (default: the standard "
                   "/etc/podinfo/annotations).  When the autoscaler "
                   "requests the slice back, the server stops "
                   "admitting, finishes in-flight sequences, and "
                   "exits 0 inside the drain window.")
@click.option("--trace-sample", default=0.0, show_default=True,
              type=click.FloatRange(0.0, 1.0),
              help="Request-trace head-sampling rate: sampled requests "
                   "(plus the always-captured tail: SLO misses, "
                   "preemptions, drain losses) emit span trees, and the "
                   "engine's tick spans are totalled by name; both ride "
                   "the final-stats receipt.  0 disables the sampler "
                   "and the tracer entirely.")
@click.option("--slo-ticks", default=None, type=int,
              help="Engine-tick latency target: completions within "
                   "this many ticks count as SLO-attained in the "
                   "stats, and slower ones are tail-captured when "
                   "--trace-sample is on.")
@model_arch_options
@click.option("--platform", default="cuda", show_default=True,
              type=click.Choice(["cuda", "cpu"]),
              help="Device to serve on.")
def main(checkpoint_dir, requests_file, random_n, max_new_tokens, slots,
         max_len, chunk, ring, paged, block_size, num_blocks, spec_k,
         draft_layers, tp_degree, seed, final_stats_file, replica_id,
         annotations_file, trace_sample, slo_ticks, vocab, seq_len,
         d_model, n_layers,
         n_kv_heads, attention_window, no_rope, moe_experts, moe_top_k,
         platform):
    """Serve mixed-length requests from the latest checkpoint."""
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(levelname)s: %(message)s")
    import torch

    from tpu_autoscaler_torch.workloads.checkpoint import (
        DEFAULT_ANNOTATIONS_PATH,
        DrainWatcher,
        latest_step,
    )
    from tpu_autoscaler_torch.workloads.model import (
        load_params,
        resolve_device,
    )
    from tpu_autoscaler_torch.workloads.paged import PagedBatcher
    from tpu_autoscaler_torch.workloads.serving import ContinuousBatcher

    cfg = model_config(vocab, seq_len, d_model, n_layers, n_kv_heads,
                       attention_window, no_rope, moe_experts, moe_top_k)
    if (requests_file is None) == (random_n is None):
        raise click.UsageError("pass exactly one of --requests/--random")
    if ring and attention_window is None:
        raise click.UsageError("--ring needs --attention-window")
    # Flag checks come before the checkpoint load: a bad combination
    # errors at once.
    if paged and ring:
        raise click.UsageError(
            "--paged and --ring are different cache layouts; pick one")
    if spec_k:
        if not paged:
            raise click.UsageError(
                "--spec-k runs inside the paged engine: add --paged")
        if not 1 <= draft_layers < n_layers:
            raise click.UsageError(
                f"--draft-layers must be in [1, {n_layers - 1}] "
                f"(a {n_layers}-layer target), got {draft_layers}")
        if spec_k >= chunk:
            raise click.UsageError(
                f"--spec-k {spec_k} must be < --chunk {chunk}")
        if moe_experts is not None:
            raise click.UsageError(
                "--spec-k with MoE targets is not wired (the layer-"
                "prefix draft would need its own router scaling)")
    if paged:
        if block_size < 1:
            raise click.UsageError(
                f"--block-size must be >= 1, got {block_size}")
        if max_len % block_size:
            raise click.UsageError(
                f"--max-len {max_len} must be a multiple of "
                f"--block-size {block_size}")
        min_blocks = -(-chunk // block_size)  # one prefill chunk
        if num_blocks is not None and num_blocks < min_blocks:
            raise click.UsageError(
                f"--num-blocks {num_blocks} cannot hold even one "
                f"prefill chunk (--chunk {chunk} needs >= {min_blocks} "
                f"blocks of {block_size}); admission would livelock")
    try:
        device = resolve_device(platform)
    except RuntimeError as e:
        raise click.UsageError(str(e)) from e

    step = latest_step(checkpoint_dir)
    if step is None:
        raise click.UsageError(
            f"no checkpoint found in {checkpoint_dir!r} (write one with "
            f"tpu_autoscaler_torch.workloads.model.save_params)")
    params = load_params(checkpoint_dir, step, device)
    log.info("loaded step %d from %s onto %s", step, checkpoint_dir,
             device)

    reqs = _read_requests(requests_file, random_n, max_new_tokens, seed,
                          cfg)
    if not reqs:
        raise click.UsageError("no requests to serve")
    mesh = serving_mesh(tp_degree, device_count(platform), platform)
    if mesh is not None:
        dp = mesh.size // mesh.shape["model"]
        if slots % dp:
            raise click.UsageError(
                f"--slots {slots} must divide over the {dp} "
                f"data-parallel devices (devices / tp) — the slot "
                f"batch shards over them")
        log.info("serving under mesh %s", dict(mesh.shape))
        device = mesh.ranks[0]
    generator = torch.Generator(device=device).manual_seed(seed)
    sampler = tracer = None
    if trace_sample > 0.0:
        from tpu_autoscaler_torch.obs.recorder import SpanTotals
        from tpu_autoscaler_torch.obs.trace import Tracer
        from tpu_autoscaler_torch.serving.reqtrace import (
            RequestTraceSampler,
        )

        sampler = RequestTraceSampler("serve", sample_rate=trace_sample,
                                      slo_ticks=slo_ticks)
        tracer = Tracer(recorder=SpanTotals())
    if paged and mesh is not None and dp > 1:
        raise click.UsageError(
            "--paged serves TP-only meshes (all slots share ONE block pool, "
            "which data sharding cannot cut); for data parallelism run one "
            "server per replica, or use devices == --tp")
    if paged and spec_k:
        import dataclasses

        from tpu_autoscaler_torch.workloads.spec_serving import (
            SpeculativePagedBatcher,
        )

        # The draft: the target's first N layers (the blocks hold
        # stacked [n_layers, ...] tensors).
        dparams = {**params, "blocks": {
            name: w[:draft_layers] for name, w in params["blocks"].items()}}
        dcfg = dataclasses.replace(cfg, n_layers=draft_layers)
        engine = SpeculativePagedBatcher(
            params, cfg, dparams, dcfg, k=spec_k, slots=slots,
            max_len=max_len, block_size=block_size, num_blocks=num_blocks,
            chunk=chunk, device=device, generator=generator, seed=seed,
            slo_ticks=slo_ticks, reqtrace=sampler, mesh=mesh, tracer=tracer)
    elif paged:
        engine = PagedBatcher(
            params, cfg, slots=slots, max_len=max_len,
            block_size=block_size, num_blocks=num_blocks, chunk=chunk,
            device=device, generator=generator, slo_ticks=slo_ticks,
            reqtrace=sampler, mesh=mesh, tracer=tracer)
    else:
        engine = ContinuousBatcher(
            params, cfg, slots=slots, max_len=max_len, chunk=chunk,
            ring=ring, device=device, generator=generator,
            slo_ticks=slo_ticks, reqtrace=sampler, mesh=mesh, tracer=tracer)

    watcher = DrainWatcher(annotations_file or DEFAULT_ANNOTATIONS_PATH)
    t0 = time.perf_counter()
    try:
        for r in reqs:
            engine.submit(r)
    except ValueError as e:
        raise click.UsageError(str(e)) from e
    engine.run(watcher=watcher)
    dt = time.perf_counter() - t0
    for i, r in enumerate(reqs):
        print(json.dumps({"id": i, "prompt_len": len(r.prompt),
                          "tokens": [int(t) for t in r.generated],
                          "done": r.done}))
    decoded = sum(len(r.generated) for r in reqs)
    log.info("%d requests, %d tokens in %.2fs (%.0f tok/s, %d ticks)",
             len(reqs), decoded, dt, decoded / max(dt, 1e-9),
             engine.ticks)
    if spec_k:
        log.info("speculative: accept_rate %.3f, target_pass_ratio "
                 "%.3f (plain decode = 1.0)", engine.accept_rate,
                 engine.target_pass_ratio)
    # The drain contract's receipt: always the LAST stdout line.
    final = final_stats_payload(reqs, engine, dt, replica_id=replica_id)
    if sampler is not None:
        final["trace"] = {**sampler.debug_state(),
                          "spans": tracer.recorder.summary()}
    print(json.dumps(final))
    if final_stats_file:
        with open(final_stats_file, "w", encoding="utf-8") as f:
            json.dump(final, f, indent=2)
            f.write("\n")
    if engine.draining:
        log.info("drain requested: in-flight sequences completed, %d "
                 "queued requests unserved; exiting cleanly",
                 final["unserved"])


if __name__ == "__main__":
    main()
