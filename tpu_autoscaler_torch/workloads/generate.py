"""Runnable generation CLI, on PyTorch.

``python -m tpu_autoscaler_torch.workloads.generate --checkpoint-dir ...``
loads the latest parameter checkpoint (``step_N/params.npz``, written by
``model.save_params``) and runs the KV-cache decode path
(workloads/decode.py): the prompt through ``prefill``, then one
``decode_step`` per generated token.  Each row prints as ``prompt |
generated`` token ids.

The model flags must match the checkpoint (shared block in _cli.py); the
prompt is token ids (comma-separated) or random with ``--prompt-len``
(drawn with numpy from ``--seed``).  Generation runs on CUDA unless
``--platform cpu`` is given; without a GPU it refuses to start rather
than run on the CPU.  ``--tp N`` (> 1) generates under a (data, model)
mesh through ``decode.make_sharded_generate`` (the prompt rows over the
data rows, params and KV cache over 'model'; above the device count the
ranks repeat the devices round-robin).
"""

from __future__ import annotations

import logging
import sys

import click
import numpy as np

from tpu_autoscaler_torch.workloads._cli import (
    device_count,
    model_arch_options,
    model_config,
    serving_mesh,
)

log = logging.getLogger(__name__)


def _check_tree(params: dict, cfg) -> None:
    """Raise a usage error unless the checkpoint's params tree has the
    paths and shapes the model flags describe."""
    from tpu_autoscaler_torch.workloads.model import _flatten, param_shapes

    got = dict(_flatten(params))
    want = dict(_flatten(param_shapes(cfg)))
    if sorted(got) != sorted(want):
        raise click.UsageError(
            "checkpoint params tree does not match the model flags "
            "(the writer and generate must agree on --d-model/--n-layers/"
            "...)")
    mismatches = [
        f"{path}: checkpoint {tuple(got[path].shape)} vs flags "
        f"{tuple(want[path])}"
        for path in sorted(got) if tuple(got[path].shape) != want[path]]
    if mismatches:
        raise click.UsageError(
            "checkpoint does not match the model flags: "
            + "; ".join(mismatches[:4]))


@click.command()
@click.option("--checkpoint-dir", default="/tmp/tpu-train-ckpt",
              show_default=True,
              help="Directory of step_N/params.npz parameter "
                   "checkpoints; the largest N is served.")
@click.option("--steps", default=32, show_default=True,
              help="Tokens to generate.")
@click.option("--prompt", default=None,
              help="Comma-separated token ids (default: random).")
@click.option("--prompt-len", default=8, show_default=True,
              help="Random prompt length when --prompt is not given.")
@click.option("--batch", default=1, show_default=True)
@click.option("--temperature", default=0.0, show_default=True,
              help="0 = greedy; > 0 samples.")
@click.option("--top-k", default=None, type=click.IntRange(min=1))
@click.option("--top-p", default=None, type=click.FloatRange(min=0.0,
                                                             max=1.0,
                                                             min_open=True),
              help="Nucleus sampling: keep the smallest token set with "
                   "cumulative probability >= this.")
@click.option("--seed", default=0, show_default=True)
@click.option("--tp", "tp_degree", default=None, type=int,
              help="Serve under a (data, model) mesh via "
                   "make_sharded_generate: prompts shard over data, "
                   "params + KV cache over 'model' (the trainer's TP "
                   "layout).  Default: single-device.  Above the device "
                   "count the ranks repeat the devices.")
@model_arch_options
@click.option("--platform", default="cuda", show_default=True,
              type=click.Choice(["cuda", "cpu"]),
              help="Device to generate on.")
def main(checkpoint_dir, steps, prompt, prompt_len, batch, temperature,
         top_k, top_p, seed, tp_degree, vocab, seq_len, d_model, n_layers,
         n_kv_heads, attention_window, no_rope, moe_experts, moe_top_k,
         platform):
    """Generate tokens from the latest checkpoint in --checkpoint-dir."""
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(levelname)s: %(message)s")
    import torch

    from tpu_autoscaler_torch.workloads.checkpoint import latest_step
    from tpu_autoscaler_torch.workloads.decode import (
        generate,
        make_sharded_generate,
    )
    from tpu_autoscaler_torch.workloads.model import (
        load_params,
        resolve_device,
    )

    cfg = model_config(vocab, seq_len, d_model, n_layers, n_kv_heads,
                       attention_window, no_rope, moe_experts, moe_top_k)
    if top_k is not None and top_k > cfg.vocab:
        raise click.UsageError(
            f"--top-k {top_k} exceeds the vocab size {cfg.vocab}")
    if temperature == 0.0 and (top_k is not None or top_p is not None):
        raise click.UsageError(
            "--top-k/--top-p need --temperature > 0 (the default 0 is "
            "greedy decoding, which ignores truncation)")
    try:
        device = resolve_device(platform)
    except RuntimeError as e:
        raise click.UsageError(str(e)) from e

    step = latest_step(checkpoint_dir)
    if step is None:
        raise click.UsageError(
            f"no checkpoint found in {checkpoint_dir!r} (write one with "
            f"tpu_autoscaler_torch.workloads.model.save_params)")
    params = load_params(checkpoint_dir, step, "cpu")
    _check_tree(params, cfg)
    log.info("loaded step %d from %s", step, checkpoint_dir)

    if prompt is not None:
        try:
            ids = [int(t) for t in prompt.split(",") if t.strip()]
        except ValueError as e:
            raise click.UsageError(
                f"--prompt must be comma-separated ints: {e}") from e
        if not ids:
            raise click.UsageError("--prompt is empty")
        if any(t < 0 or t >= cfg.vocab for t in ids):
            raise click.UsageError(
                f"--prompt ids must be in [0, {cfg.vocab})")
        tokens = np.asarray([ids] * batch, np.int32)
    else:
        tokens = np.random.default_rng(seed).integers(
            0, cfg.vocab, (batch, prompt_len)).astype(np.int32)

    mesh = serving_mesh(tp_degree, device_count(platform), platform)
    if mesh is not None:
        dp = mesh.size // mesh.shape["model"]
        if batch % dp:
            raise click.UsageError(
                f"--batch {batch} must divide over the {dp} "
                f"data-parallel devices (devices / tp)")
        log.info("serving under mesh %s", dict(mesh.shape))
        device = mesh.ranks[0]
    generator = (torch.Generator(device=device).manual_seed(seed)
                 if temperature > 0 else None)
    if mesh is not None:
        run = make_sharded_generate(mesh, cfg, steps,
                                    temperature=temperature, top_k=top_k,
                                    top_p=top_p)
        out = run(params, torch.from_numpy(tokens), generator)
    else:
        out = generate(params, torch.from_numpy(tokens), cfg, steps,
                       generator=generator, temperature=temperature,
                       top_k=top_k, top_p=top_p, device=device)
    prompt_n = tokens.shape[1]
    for row in out.cpu().tolist():
        print(f"{','.join(map(str, row[:prompt_n]))} | "
              f"{','.join(map(str, row[prompt_n:]))}")


if __name__ == "__main__":
    main()
