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
resumes on any mesh); the JAX trainer's orbax checkpoints cannot be
read here (orbax needs JAX).  Training runs on CUDA unless
``--platform cpu`` is given; without a GPU it refuses to start rather
than run on the CPU.

Without ``--sp``, ``--ep`` or ``--pp-stages`` the step is
``model.make_sharded_train_step`` over the (data, model) mesh of
``model.make_mesh(tp=--tp)`` with ``--shard`` none, zero1 or fsdp; a
one-rank mesh takes ``model.make_train_step``.  ``--moe-experts E``
trains a mixture-of-experts model.  ``--sp N`` trains with the sequence
cut over N ranks (``sp.py``: the ring, or ``--sp-impl ulysses``; with
``--moe-experts`` the ranks are also the expert group, sp×ep), and
``--ep N`` with the batch cut over N ranks that split the experts
(``moe.make_ep_train_step``).  All ranks live in one process, rank r on
card r mod the number of cards, so ranks share a card when there are
fewer cards than ranks.  The MoE steps log the router's balance and z
losses.  ``--pp-stages``, and ``--tp`` or ZeRO-1 beside the sp or ep
ranks, wait for items of ROADMAP.md's Queue 1: asking for one is a
usage error.
"""

from __future__ import annotations

import functools
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


def _refuse_unported(tp_degree, ep_degree, pp_stages, sp_degree, zero1,
                     shard_mode, sp_impl, platform, moe_experts,
                     batch) -> None:
    """The JAX trainer's usage errors for --sp and --ep, then usage
    errors for what this trainer does not run yet, each naming the
    ROADMAP.md Queue 1 item that brings it."""
    if sp_degree > 1 and shard_mode == "fsdp":
        raise click.UsageError(
            "--shard fsdp composes with the dp+tp step, not --sp "
            "(params replicate under sp; --shard zero1 composes)")
    if ep_degree > 1:
        if pp_stages > 1 or sp_degree > 1:
            raise click.UsageError(
                "--ep composes with data parallelism (dp×ep); pick it OR "
                "--pp-stages/--sp")
        if moe_experts is None:
            raise click.UsageError("--ep needs --moe-experts")
        if (shard_mode or ("zero1" if zero1 else "none")) != "none":
            raise click.UsageError(
                "--shard composes with the dp+tp step, not --ep "
                "(expert state is already partitioned)")
    beside = sp_degree > 1 or ep_degree > 1
    refused = [
        (beside and tp_degree is not None and tp_degree > 1,
         "--tp with --sp or --ep", "EP and the SP compositions"),
        (sp_degree > 1 and (zero1 or shard_mode == "zero1"),
         "--shard zero1 with --sp", "EP and the SP compositions"),
        (pp_stages > 1, "--pp-stages", "pipeline parallelism"),
    ]
    for asked, flag, item in refused:
        if asked:
            raise click.UsageError(
                f"{flag} is not ported yet (ROADMAP.md, Queue 1: {item})")
    if sp_degree > 1 and sp_impl == "pallas" and platform == "cpu":
        raise click.UsageError(
            "--sp-impl pallas runs the ring's CUDA kernels: it needs "
            "--platform cuda (auto or einsum run on the CPU)")
    if ep_degree > 1 and batch % ep_degree:
        # The ep ranks are the data×ep devices: one data row of them.
        raise click.UsageError(
            f"--batch {batch} must divide over the {ep_degree} data×ep "
            f"devices")


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
              help="Tensor parallelism degree: the dp+tp mesh's 'model' "
                   "axis (default: 2 when the device count is even); "
                   "ranks repeat cards round-robin when it exceeds them, "
                   "so --tp 2 on one card trains dp 1 x tp 2.  With --sp "
                   "or --ep not ported yet (ROADMAP.md, Queue 1: EP and "
                   "the SP compositions).")
@click.option("--ep", "ep_degree", default=1, show_default=True,
              help="Expert parallelism (dp×ep, needs --moe-experts): the "
                   "batch over this many ranks of one process that split "
                   "the experts, rank r on card r mod the card count.  "
                   "Data-parallel replicas beside them and --tp wait for "
                   "ROADMAP.md, Queue 1: EP and the SP compositions.  "
                   "1 = off.")
@click.option("--pp-stages", default=1, show_default=True,
              help="Pipeline stages (> 1 not ported: ROADMAP.md, Queue "
                   "1: pipeline parallelism).")
@click.option("--pp-microbatches", default=4, show_default=True,
              help="Microbatches per pipelined step (with --pp-stages).")
@click.option("--sp", "sp_degree", default=1, show_default=True,
              help="Context parallelism: shard the SEQUENCE over this "
                   "many ranks of one process (ring attention), rank r "
                   "on card r mod the card count, so ranks share a card "
                   "when there are fewer cards.  Data-parallel replicas "
                   "beside the sp ranks wait for ROADMAP.md, Queue 1: EP "
                   "and the SP compositions.  1 = off.")
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
              help="Binary uint32 token shard to train on (numpy loader). "
                   "Default: synthetic random tokens.")
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
    default), with the sequence cut over --sp ranks, or expert-parallel
    over --ep ranks."""
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(levelname)s: %(message)s")
    import torch

    from tpu_autoscaler_torch.dataio import open_token_loader
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

    _refuse_unported(tp_degree, ep_degree, pp_stages, sp_degree, zero1,
                     shard_mode, sp_impl, platform, moe_experts, batch)
    if sp_degree > 1 and seq_len % sp_degree:
        raise click.UsageError(
            f"--sp {sp_degree} must divide --seq-len {seq_len}")
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

    if sp_degree > 1 or ep_degree > 1:
        from tpu_autoscaler_torch.workloads.moe import (
            make_ep_mesh,
            make_ep_train_step,
        )
        from tpu_autoscaler_torch.workloads.sp import (
            make_sp_mesh,
            make_sp_train_step,
        )

        # Rank r on card r mod the card count (all on the CPU there).
        devices = make_sp_mesh(None if device.type == "cuda" else [device],
                               sp=max(sp_degree, ep_degree))
        try:  # e.g. ulysses head or sp×ep expert divisibility
            if ep_degree > 1:
                init_fn, step4 = make_ep_train_step(
                    make_ep_mesh(devices, ep=ep_degree), cfg,
                    train=train_cfg)
            else:
                init_fn, step4 = make_sp_train_step(
                    devices, cfg, train=train_cfg,
                    impl=None if sp_impl == "auto" else sp_impl)
        except ValueError as e:
            raise click.UsageError(str(e)) from e
        # --sp with --moe-experts is sp×ep: its step returns the router
        # metrics, as the ep step does.
        raw_step_fn = (wrap_moe_step(step4) if moe_experts is not None
                       else step4)
        device = devices[0]
        if ep_degree > 1:
            log.info("ep %d ranks on %s", ep_degree,
                     ", ".join(map(str, devices)))
        else:
            log.info("sp %d ranks (%s) on %s", sp_degree, sp_impl,
                     ", ".join(map(str, devices)))
    else:
        shard = shard_mode or ("zero1" if zero1 else "none")
        cards = ([device] if device.type == "cpu" else
                 [torch.device("cuda", i)
                  for i in range(torch.cuda.device_count())])
        if tp_degree is not None and tp_degree > len(cards):
            # Ranks repeat the cards round-robin, as --sp/--ep do.
            cards = [cards[r % len(cards)] for r in range(tp_degree)]
        try:
            mesh = make_mesh(cards, tp=tp_degree)
        except ValueError as e:
            raise click.UsageError(str(e)) from e
        dp = mesh.shape["data"]
        if batch % dp:
            raise click.UsageError(
                f"--batch {batch} must divide over the {dp} data-parallel "
                f"ranks (devices / tp)")
        if mesh.size > 1:
            init_fn, raw_step_fn = make_sharded_train_step(
                mesh, cfg, train=train_cfg, shard=shard)
            save_layout = functools.partial(gather_params, mesh)
            mesh_layout = functools.partial(_shard_state, mesh, cfg, shard)
        else:
            init_fn, raw_step_fn = make_train_step(
                cfg, train=train_cfg, device=device, shard=shard)
        log.info("mesh %s, shard %s on %s", dict(mesh.shape), shard,
                 ", ".join(map(str, mesh.ranks)))
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
            loader = open_token_loader(data_file, batch=batch,
                                       window=cfg.seq_len + 1, seed=0)
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
            rng = np.random.default_rng((step << 16) | 0)
            local = rng.integers(0, cfg.vocab, (batch, cfg.seq_len + 1),
                                 dtype=np.int32)
        return torch.from_numpy(local).to(device)

    last_loss = [float("nan")]

    def step_fn(state, tokens):
        params, opt_state, loss = raw_step_fn(state["params"],
                                              state["opt"], tokens)
        last_loss[0] = float(loss)
        return {"params": params, "opt": opt_state}

    # Throughput between log lines (wall time includes host data prep).
    tokens_per_step = batch * cfg.seq_len
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
        return writer.save(directory, step, save_layout(state))

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
    if drained:
        log.info("drain requested: checkpointed at step %d, exiting "
                 "cleanly", step)
    else:
        log.info("training complete at step %d", step)


if __name__ == "__main__":
    main()
