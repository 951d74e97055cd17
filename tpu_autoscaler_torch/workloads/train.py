"""Runnable trainer, on PyTorch.

``python -m tpu_autoscaler_torch.workloads.train`` is the counterpart of
the JAX package's ``workloads/train.py``: it builds the model and the
optimizer recipe (``TrainConfig``), resumes from the latest
``step_N`` checkpoint, trains on synthetic tokens (the JAX trainer's
stream, token for token) or on a ``--data-file`` token shard,
checkpoints every ``--checkpoint-every`` steps, and honors the
checkpoint-aware drain contract: when the pod's
``autoscaler.tpu.dev/checkpoint-requested`` annotation appears, a final
checkpoint is saved and the process exits 0.

Checkpoints are ``step_N/params.npz`` (the layout ``serve`` and
``generate`` read) plus ``step_N/opt.npz``, in the one-device layout
whatever the mesh (gathered on save, cut again on restore, so a run
resumes on any mesh).  The JAX trainer's orbax checkpoints are not
read here (orbax needs JAX): ``tools/convert_checkpoint.py`` converts
them to this layout and back, where JAX is installed.  A
``--data-file`` is read by ``dataio.open_token_loader`` (the native
loader, numpy without a compiler).  When training ends, the log's last
line but one counts the kernel launches of the run
(``attention.LAUNCHES``).  Training runs on CUDA unless
``--platform cpu`` is given; without a GPU it refuses to start rather
than run on the CPU.

Without ``--sp``, ``--ep`` or ``--pp-stages`` the step is
``model.make_sharded_train_step`` over the (data, model) mesh of
``model.make_mesh(tp=--tp)`` with ``--shard`` none, zero1 or fsdp (a
multi-slice topology in one process takes the (dcn, data, model) mesh
of ``distributed.make_multislice_mesh``); a one-rank mesh takes
``model.make_train_step``.  ``--moe-experts E`` trains a
mixture-of-experts model.  ``--sp N [--tp M] [--shard zero1]`` trains
with the sequence cut over N ranks (``sp.py``: the ring, or
``--sp-impl ulysses``; with ``--moe-experts`` the ranks are also the
expert group, sp×ep), ``--ep N [--tp M]`` with the batch cut over
every rank and the experts over N (``moe.make_ep_train_step``), and
``--pp-stages N`` with the layers cut over N pipeline stages
(``pipeline.make_pipeline_train_step``: GPipe over
``--pp-microbatches`` microbatches, with remat; with ``--tp M`` the
dp×pp×tp step over ``pipeline.make_pipeline_mesh``); the rest of the
devices are data-parallel, data = devices // (N·M).  All ranks of a
process live in it, rank r on card r mod the number of cards, so ranks
share a card when there are fewer cards than ranks (the JAX trainer
refuses ``--pp-stages`` above its device count instead).  The MoE steps
log the router's balance and z losses.

Multi-host jobs: the trainer first calls
``distributed.initialize_from_env`` (the GKE env contract:
``TPU_WORKER_HOSTNAMES``, ``TPU_WORKER_ID``, ``MEGASCALE_SLICE_ID`` or
``JOB_COMPLETION_INDEX``, ``MEGASCALE_NUM_SLICES``; NCCL between CUDA
processes, gloo with ``--platform cpu``).  With more than one process
each one trains a replica of the dp+tp step over its own cards on its
``--batch / processes`` rows (synthetic rows from the seed ``(step <<
16) | process``, the ``--data-file`` loader seeded with the process
id), and the gradients and the loss are averaged over the processes
before the optimizer: the JAX trainer's data parallelism over (dcn,
data).  Process 0 writes the checkpoints while the others wait at a
barrier; every process restores from the same files.  ``--sp``, ``--ep``
and ``--pp-stages`` are single-process only, as in the JAX trainer.
"""

from __future__ import annotations

import functools
import json
import logging
import os
import sys
import time

import click
import numpy as np

from tpu_autoscaler_torch.workloads._cli import (
    model_arch_options,
    model_config,
)

log = logging.getLogger(__name__)


def _usage_errors(ep_degree, pp_stages, sp_degree, zero1, shard_mode,
                  sp_impl, platform, moe_experts) -> None:
    """The JAX trainer's usage errors that need no devices, then the
    port's own: the CUDA ring on the CPU."""
    shard = shard_mode or ("zero1" if zero1 else "none")
    if pp_stages > 1 and sp_degree > 1:
        raise click.UsageError(
            "--pp-stages and --sp are separate strategies; pick one "
            "(pp x sp composition is not wired in the CLI)")
    if ep_degree > 1:
        if pp_stages > 1 or sp_degree > 1:
            raise click.UsageError(
                "--ep composes with data parallelism (dp×ep); pick it OR "
                "--pp-stages/--sp")
        if moe_experts is None:
            raise click.UsageError("--ep needs --moe-experts")
        if shard != "none":
            raise click.UsageError(
                "--shard composes with the dp+tp step, not --ep "
                "(expert state is already partitioned)")
    if sp_degree > 1:
        if shard == "fsdp":
            raise click.UsageError(
                "--shard fsdp composes with the dp+tp step, not --sp "
                "(params replicate under sp; --shard zero1 composes)")
        if sp_impl == "pallas" and platform == "cpu":
            raise click.UsageError(
                "--sp-impl pallas runs the ring's CUDA kernels: it needs "
                "--platform cuda (auto or einsum run on the CPU)")


def _pp_usage_errors(shard, batch, pp_microbatches) -> None:
    """The JAX trainer's refusals of a --pp-stages run's state sharding
    and microbatch count, in its order (before the multi-process one)."""
    if shard != "none":
        raise click.UsageError(
            "--shard composes with the dp+tp step, not --pp-stages "
            "(stage-sharded state is already partitioned)")
    if batch % pp_microbatches:
        raise click.UsageError(
            f"--pp-microbatches {pp_microbatches} must divide "
            f"--batch {batch}")


def _single_process_only(topo, ep_degree, sp_degree, pp_stages) -> None:
    """The JAX trainer's refusals of --ep, --sp and --pp-stages in a
    multi-process job."""
    if topo.num_processes > 1:
        if ep_degree > 1:
            raise click.UsageError(
                "--ep is single-process only for now; multi-host jobs "
                "should use the dp+tp step")
        if sp_degree > 1:
            raise click.UsageError(
                "--sp is single-process only for now; multi-host jobs "
                "should use the dp+tp step")
        if pp_stages > 1:
            raise click.UsageError(
                "--pp-stages is single-process only for now; multi-host "
                "jobs should use the dp+tp step (--shard)")


def _cards(device, ranks: int) -> list:
    """The devices the ranks go on: every visible card (the one CPU
    device on the CPU), repeated round-robin up to ``ranks`` when there
    are fewer."""
    import torch

    cards = ([device] if device.type == "cpu" else
             [torch.device("cuda", i)
              for i in range(torch.cuda.device_count())])
    return [cards[r % len(cards)] for r in range(max(ranks, len(cards)))]


def synthetic_rows(step: int, process_id: int, rows: int, vocab: int,
                   seq_len: int) -> np.ndarray:
    """Process ``process_id``'s synthetic tokens at ``step``: [rows,
    seq_len + 1] int32, the JAX trainer's stream row for row."""
    rng = np.random.default_rng((step << 16) | process_id)
    return rng.integers(0, vocab, (rows, seq_len + 1), dtype=np.int32)


def _unchanged(state):
    return state


def _shard_state(mesh, cfg, shard, state):
    """A one-device trainer state (a checkpoint) cut over ``mesh``."""
    from tpu_autoscaler_torch.workloads.model import (
        shard_opt_state,
        shard_params,
    )

    return {"params": shard_params(mesh, cfg, state["params"], shard),
            "opt": shard_opt_state(mesh, cfg, state["opt"], shard)}


@click.command()
@click.option("--steps", default=100, show_default=True)
@click.option("--batch", default=8, show_default=True)
@model_arch_options
@click.option("--remat", is_flag=True,
              help="Rematerialize activations (long-context memory lever).")
@click.option("--ce-chunk", default=None, type=int,
              help="Chunked cross-entropy: unembed+softmax over sequence "
                   "chunks of this size (large-vocab memory lever).")
@click.option("--zero1", is_flag=True,
              help="Deprecated alias for --shard zero1.")
@click.option("--shard", "shard_mode",
              type=click.Choice(["none", "zero1", "fsdp"]), default=None,
              help="Data-axis state sharding: zero1 = AdamW moments "
                   "(cuts fp32 optimizer memory by the DP degree); fsdp = "
                   "params+grads+moments (ZeRO-3, fits ~DPx larger "
                   "models).  Default: none.")
@click.option("--lr", default=1e-3, show_default=True,
              help="Peak learning rate.")
@click.option("--warmup-steps", default=0, show_default=True,
              help="Linear LR warmup from 0 to --lr.")
@click.option("--lr-schedule", type=click.Choice(["constant", "cosine"]),
              default="constant", show_default=True,
              help="cosine: decay to --min-lr-ratio * --lr over --steps.")
@click.option("--min-lr-ratio", default=0.1, show_default=True)
@click.option("--grad-clip", default=None, type=float,
              help="Global-norm gradient clipping threshold.")
@click.option("--accum-steps", default=1, show_default=True,
              help="Gradient accumulation: apply the optimizer every k "
                   "microbatch steps (k-times the effective batch).")
@click.option("--weight-decay", default=1e-4, show_default=True)
@click.option("--tp", "tp_degree", default=None, type=int,
              help="Tensor parallelism degree.  Composes with every "
                   "mode: alone it sets the dp+tp mesh's 'model' axis "
                   "(default: 2 when the device count is even); with "
                   "--pp-stages it builds the 3-axis dp×pp×tp GPipe "
                   "step; with --sp or --ep it Megatron-cuts heads and "
                   "d_ff inside their step.  Ranks repeat cards "
                   "round-robin when they exceed them, so --tp 2 on one "
                   "card trains dp 1 x tp 2.")
@click.option("--ep", "ep_degree", default=1, show_default=True,
              help="Expert parallelism (needs --moe-experts): cut the "
                   "experts over this many ranks with all_to_all "
                   "dispatch; the rest are data-parallel.  1 = off "
                   "(MoE runs replicated under the dp+tp step).")
@click.option("--pp-stages", default=1, show_default=True,
              help="Pipeline parallelism: split layers over this many "
                   "stages (GPipe with microbatch remat).  1 = off "
                   "(dp+tp mesh).  Stages repeat cards round-robin when "
                   "they exceed them.")
@click.option("--pp-microbatches", default=4, show_default=True,
              help="Microbatches streamed through the pipeline per step "
                   "(bubble fraction = (P-1)/(m+P-1)).")
@click.option("--sp", "sp_degree", default=1, show_default=True,
              help="Context parallelism: shard the SEQUENCE over this "
                   "many ranks (ring attention); the remaining devices "
                   "are data-parallel.  Rank r on card r mod the card "
                   "count, so ranks share a card when there are fewer "
                   "cards.  1 = off.")
@click.option("--sp-impl",
              type=click.Choice(["auto", "einsum", "pallas", "ulysses"]),
              default="auto", show_default=True,
              help="Sequence-parallel attention strategy: einsum/pallas "
                   "= ring (pallas: the hand-written CUDA hop kernels, "
                   "CUDA only); ulysses = all-to-all to head sharding + "
                   "local flash attention (needs heads divisible by "
                   "--sp).  auto = the kernel ring on CUDA, einsum on "
                   "the CPU.")
@click.option("--data-file", default=None,
              help="Binary uint32 token shard to train on (native mmap "
                   "loader with prefetch; numpy fallback).  The repo "
                   "ships data/corpus.bin (byte-BPE vocab 8192, "
                   "data/tokenizer.json; rebuild or retokenize with "
                   "`python -m tpu_autoscaler_torch.workloads.tokenizer`) "
                   "— pair it with --vocab 8192.  Default: synthetic "
                   "random tokens.")
@click.option("--profile-dir", default=None,
              help="Capture a torch.profiler trace of steps start+3.."
                   "start+5 into this directory (trace.json, Chrome "
                   "trace format).")
@click.option("--checkpoint-dir", default="/tmp/tpu-train-ckpt",
              show_default=True)
@click.option("--checkpoint-every", default=50, show_default=True)
@click.option("--annotations-file", default=None,
              help="Downward-API annotations path (default: the standard "
                   "/etc/podinfo/annotations).")
@click.option("--platform", default="cuda", show_default=True,
              type=click.Choice(["cuda", "cpu"]),
              help="Device to train on.")
def main(steps, batch, vocab, seq_len, d_model, n_layers, n_kv_heads,
         attention_window, no_rope, moe_experts, moe_top_k, remat,
         ce_chunk, zero1, shard_mode, lr, warmup_steps, lr_schedule,
         min_lr_ratio, grad_clip, accum_steps, weight_decay, tp_degree,
         ep_degree, pp_stages, pp_microbatches, sp_degree, sp_impl,
         data_file, profile_dir, checkpoint_dir, checkpoint_every,
         annotations_file, platform):
    """Train the in-tree model over a dp+tp mesh (one device by
    default), with the sequence cut over --sp ranks, expert-parallel
    over --ep ranks, or pipelined over --pp-stages stages."""
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(levelname)s: %(message)s")
    import torch

    from tpu_autoscaler_torch.dataio import open_token_loader
    from tpu_autoscaler_torch.workloads import attention
    from tpu_autoscaler_torch.workloads.checkpoint import (
        DEFAULT_ANNOTATIONS_PATH,
        AsyncCheckpointWriter,
        DrainWatcher,
        latest_step,
        restore_checkpoint,
        train_until_drained,
    )
    from tpu_autoscaler_torch.workloads.model import (
        TrainConfig,
        gather_params,
        make_mesh,
        make_sharded_train_step,
        make_train_step,
        resolve_device,
    )
    from tpu_autoscaler_torch.workloads.distributed import (
        initialize_from_env,
        make_multislice_mesh,
        make_process_mesh,
    )

    _usage_errors(ep_degree, pp_stages, sp_degree, zero1, shard_mode,
                  sp_impl, platform, moe_experts)
    try:
        cfg = model_config(vocab, seq_len, d_model, n_layers, n_kv_heads,
                           attention_window, no_rope, moe_experts,
                           moe_top_k, remat=remat, ce_chunk=ce_chunk)
        train_cfg = TrainConfig(
            learning_rate=lr, warmup_steps=warmup_steps,
            decay_steps=steps if lr_schedule == "cosine" else None,
            min_lr_ratio=min_lr_ratio, weight_decay=weight_decay,
            grad_clip=grad_clip, accum_steps=accum_steps)
        device = resolve_device(platform)
    except (ValueError, RuntimeError) as e:
        raise click.UsageError(str(e)) from e
    topo = initialize_from_env(
        backend="nccl" if device.type == "cuda" else "gloo")
    log.info("topology: process %d/%d (slice %d/%d); devices: %d",
             topo.process_id, topo.num_processes, topo.slice_id,
             topo.num_slices, len(_cards(device, 1)))
    shard = shard_mode or ("zero1" if zero1 else "none")
    if pp_stages > 1:
        _pp_usage_errors(shard, batch, pp_microbatches)
    _single_process_only(topo, ep_degree, sp_degree, pp_stages)
    n_proc = max(1, topo.num_processes)
    local_batch = max(1, batch // n_proc)

    last_moe_metrics: dict = {}
    # Checkpoints hold the one-device layout: a mesh step's state is
    # gathered to save and cut again on restore.
    save_layout = mesh_layout = _unchanged

    def wrap_moe_step(step4):
        """Adapt a 4-tuple MoE step (params, opt, loss, metrics) to the
        training loop's 3-tuple, keeping the router losses for the log."""
        def raw_step_fn(params, opt_state, tokens):
            params, opt_state, loss, metrics = step4(params, opt_state,
                                                     tokens)
            last_moe_metrics.update(balance=float(metrics["balance_loss"]),
                                    z=float(metrics["z_loss"]))
            return params, opt_state, loss
        return raw_step_fn

    if ep_degree > 1:
        from tpu_autoscaler_torch.workloads.moe import (
            make_ep_mesh,
            make_ep_train_step,
            shard_ep_opt_state,
            shard_ep_params,
        )

        ep_tp = tp_degree or 1
        cards = _cards(device, ep_degree * ep_tp)
        if len(cards) % (ep_degree * ep_tp):
            raise click.UsageError(
                f"--ep {ep_degree} x --tp {ep_tp} must divide the "
                f"{len(cards)} available devices")
        if batch % (len(cards) // ep_tp):
            raise click.UsageError(
                f"--batch {batch} must divide over the "
                f"{len(cards) // ep_tp} data×ep devices")
        mesh = make_ep_mesh(cards, ep=ep_degree, tp=ep_tp)
        try:
            init_fn, step4 = make_ep_train_step(mesh, cfg, train=train_cfg)
        except ValueError as e:
            raise click.UsageError(str(e)) from e
        raw_step_fn = wrap_moe_step(step4)
        save_layout = functools.partial(gather_params, mesh)

        def mesh_layout(state):
            return {"params": shard_ep_params(mesh, cfg, state["params"]),
                    "opt": shard_ep_opt_state(mesh, cfg, state["opt"])}
        device = mesh.ranks[0]
        log.info("ep %d ranks on %s; mesh %s", ep_degree,
                 ", ".join(map(str, mesh.ranks)), dict(mesh.shape))
    elif sp_degree > 1:
        from tpu_autoscaler_torch.workloads.sp import (
            make_sp_mesh,
            make_sp_train_step,
            shard_sp_opt_state,
        )

        sp_tp = tp_degree or 1
        cards = _cards(device, sp_degree * sp_tp)
        if len(cards) % (sp_degree * sp_tp):
            raise click.UsageError(
                f"--sp {sp_degree} x --tp {sp_tp} must divide the "
                f"{len(cards)} available devices")
        if seq_len % sp_degree:
            raise click.UsageError(
                f"--sp {sp_degree} must divide --seq-len {seq_len}")
        dp_n = len(cards) // (sp_degree * sp_tp)
        if batch % dp_n:
            raise click.UsageError(
                f"--batch {batch} must divide over the {dp_n} "
                f"data-parallel devices (devices / (sp*tp))")
        mesh = make_sp_mesh(cards, sp=sp_degree, tp=sp_tp)
        try:  # e.g. ulysses head or sp×ep expert divisibility
            init_fn, step = make_sp_train_step(
                mesh, cfg, train=train_cfg,
                impl=None if sp_impl == "auto" else sp_impl, shard=shard)
        except ValueError as e:
            raise click.UsageError(str(e)) from e
        # --sp with --moe-experts is sp×ep: its step returns the router
        # metrics, as the ep step does.
        raw_step_fn = (wrap_moe_step(step) if moe_experts is not None
                       else step)
        if shard == "zero1":
            save_layout = functools.partial(gather_params, mesh)

            def mesh_layout(state):
                return {"params": state["params"],
                        "opt": shard_sp_opt_state(mesh, cfg, state["opt"])}
        device = mesh.ranks[0]
        log.info("sp %d ranks (%s) on %s; mesh %s, shard %s", sp_degree,
                 sp_impl, ", ".join(map(str, mesh.ranks)), dict(mesh.shape),
                 shard)
    elif pp_stages > 1:
        from tpu_autoscaler_torch.workloads.model import Mesh
        from tpu_autoscaler_torch.workloads.pipeline import (
            gather_pipeline_state,
            make_pipeline_mesh,
            make_pipeline_train_step,
            shard_pipeline_state,
        )

        # Tokens replicate over the stages; the dp×pp×tp mesh cuts the
        # batch over 'data' inside its loss.
        if tp_degree is not None:
            pp_tp = tp_degree
            cards = _cards(device, pp_stages * pp_tp)
            if len(cards) % (pp_stages * pp_tp):
                raise click.UsageError(
                    f"--pp-stages {pp_stages} x --tp {pp_tp} must "
                    f"divide the {len(cards)} available devices")
            dp_n = len(cards) // (pp_stages * pp_tp)
            if batch % (dp_n * pp_microbatches):
                raise click.UsageError(
                    f"--batch {batch} must divide over {dp_n} data "
                    f"shards x {pp_microbatches} microbatches")
            mesh = make_pipeline_mesh(cards, pp=pp_stages, tp=pp_tp)
        else:
            mesh = Mesh(np.array(_cards(device, pp_stages)[:pp_stages],
                                 dtype=object), ("pp",))
        try:
            init_fn, raw_step_fn = make_pipeline_train_step(
                mesh, cfg, num_microbatches=pp_microbatches,
                train=train_cfg)
        except ValueError as e:
            raise click.UsageError(str(e)) from e
        # Checkpoints hold the one-device layout with qkv packed, so
        # serve and generate read a pipeline checkpoint.
        save_layout = functools.partial(gather_pipeline_state, mesh, cfg)
        mesh_layout = functools.partial(shard_pipeline_state, mesh, cfg)
        device = mesh.ranks[0]
        log.info("pp %d stages on %s; mesh %s, %d microbatches", pp_stages,
                 ", ".join(map(str, mesh.ranks)), dict(mesh.shape),
                 pp_microbatches)
    else:
        cards = _cards(device, tp_degree or 1)
        try:
            if n_proc > 1:
                mesh = make_process_mesh(cards, tp=tp_degree,
                                         num_slices=topo.num_slices)
            elif topo.num_slices > 1:
                mesh = make_multislice_mesh(topo.num_slices, devices=cards)
            else:
                mesh = make_mesh(cards, tp=tp_degree)
        except ValueError as e:
            raise click.UsageError(str(e)) from e
        dp = len(mesh.local) // mesh.shape["model"]
        if local_batch % dp:
            raise click.UsageError(
                f"--batch {batch} must divide over the {dp} data-parallel "
                f"ranks (devices / tp)")
        if mesh.size > 1:
            # Several processes share one mesh: each steps on its own
            # rows, the gradients and the loss averaged over the
            # processes, the state cut over every process's data rows.
            init_fn, raw_step_fn = make_sharded_train_step(
                mesh, cfg, train=train_cfg, shard=shard)
            save_layout = functools.partial(gather_params, mesh)
            mesh_layout = functools.partial(_shard_state, mesh, cfg, shard)
        else:
            init_fn, raw_step_fn = make_train_step(
                cfg, train=train_cfg, device=device, shard=shard)
        log.info("mesh %s, shard %s on %s", dict(mesh.shape), shard,
                 ", ".join(str(mesh.ranks[r]) for r in mesh.local))
    try:  # e.g. a width the model ranks do not divide
        # A CPU generator: the same initial params on every device.
        params, opt_state = init_fn(torch.Generator().manual_seed(0))
    except ValueError as e:
        raise click.UsageError(str(e)) from e
    log.info("device %s; params initialized", device)

    start = latest_step(checkpoint_dir) or 0
    state = {"params": params, "opt": opt_state}
    if start:
        state = mesh_layout(restore_checkpoint(checkpoint_dir, start,
                                               device))
        log.info("resumed from checkpoint step %d", start)

    watcher = DrainWatcher(annotations_file or DEFAULT_ANNOTATIONS_PATH)

    loader = None
    if data_file:
        # The stream is a pure function of (seed, step), so resume
        # replays it exactly.
        try:
            # Seeded per process: each samples its own crops of the
            # shared shard.
            loader = open_token_loader(data_file, batch=local_batch,
                                       window=cfg.seq_len + 1,
                                       seed=topo.process_id)
        except (ValueError, OSError) as e:
            raise click.UsageError(str(e)) from e
        log.info("token shard %s: %d tokens (%s loader)", data_file,
                 loader.n_tokens, type(loader).__name__)

    vocab_warned = [False]

    def batch_for(step):
        if loader is not None:
            # Clip to the model's vocab: shards may be tokenized with a
            # larger vocabulary than this run trains.
            raw = loader.next(step)
            if not vocab_warned[0] and int(raw.max()) >= cfg.vocab:
                vocab_warned[0] = True
                log.warning(
                    "token shard contains ids >= model vocab %d; they "
                    "are aliased with modulo — retokenize or raise "
                    "--vocab if this is unintended", cfg.vocab)
            local = (raw % np.uint32(cfg.vocab)).astype(np.int32)
        else:
            local = synthetic_rows(step, topo.process_id, local_batch,
                                   cfg.vocab, cfg.seq_len)
        return torch.from_numpy(local).to(device)

    last_loss = [float("nan")]

    def step_fn(state, tokens):
        params, opt_state, loss = raw_step_fn(state["params"],
                                              state["opt"], tokens)
        last_loss[0] = float(loss)
        return {"params": params, "opt": opt_state}

    # Throughput between log lines (wall time includes host data prep),
    # over the global batch.
    tokens_per_step = local_batch * n_proc * cfg.seq_len
    tp_state = {"t": time.perf_counter(), "step": start}
    profiler = [None]

    def stop_profiler():
        prof, profiler[0] = profiler[0], None
        prof.stop()
        path = os.path.join(profile_dir, "trace.json")
        prof.export_chrome_trace(path)
        log.info("profiler trace written to %s", path)

    def on_step(step, _state):
        if profile_dir and step == start + 2 and profiler[0] is None:
            from torch.profiler import ProfilerActivity, profile

            os.makedirs(profile_dir, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            profiler[0] = profile(activities=activities)
            profiler[0].start()
        if profiler[0] is not None and step >= start + 5:
            stop_profiler()
        if step % 10 == 0:
            now = time.perf_counter()
            dsteps = step - tp_state["step"]
            tok_s = (tokens_per_step * dsteps
                     / max(now - tp_state["t"], 1e-9)) if dsteps else 0.0
            tp_state.update(t=now, step=step)
            moe_note = ""
            if last_moe_metrics:
                moe_note = (f" balance {last_moe_metrics['balance']:.3f}"
                            f" z {last_moe_metrics['z']:.3f}")
            log.info("step %d loss %.4f (%.0f tok/s)%s", step, last_loss[0],
                     tok_s, moe_note)

    writer = AsyncCheckpointWriter()

    def save(directory, step, state):
        # Process 0 writes; the others wait for it to take the state.
        state = save_layout(state)
        if topo.process_id == 0:
            writer.save(directory, step, state)
        if n_proc > 1:
            torch.distributed.barrier()

    try:
        state, step, drained = train_until_drained(
            step_fn, state, num_steps=steps, watcher=watcher,
            checkpoint_dir=checkpoint_dir, make_batch=batch_for,
            start_step=start, checkpoint_every=checkpoint_every,
            on_step=on_step, save_fn=save)
    finally:
        # Always drain the writer: makes the final/drain checkpoint
        # durable AND surfaces any deferred background write error even
        # when the training loop itself raised.
        writer.wait()
        if profiler[0] is not None:  # steps ended inside the trace window
            stop_profiler()
        if n_proc > 1:
            torch.distributed.destroy_process_group()
    # What the run launched of each hand-written kernel: zero on the CPU.
    log.info("kernel launches %s", json.dumps(attention.LAUNCHES))
    if drained:
        log.info("drain requested: checkpointed at step %d, exiting "
                 "cleanly", step)
    else:
        log.info("training complete at step %d", step)


if __name__ == "__main__":
    main()
