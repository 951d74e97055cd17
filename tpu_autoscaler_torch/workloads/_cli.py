"""Shared CLI plumbing for the workload commands.

The same architecture flags as the JAX package's ``workloads/_cli.py``:
a checkpoint is only consumable when the writer and the server build
the same ModelConfig, so the flag block exists exactly once, here.
"""

from __future__ import annotations

import click

_MODEL_ARCH_OPTIONS = [
    click.option("--vocab", default=256, show_default=True,
                 help="Vocabulary size (must match the tokenizer of any "
                      "--data-file shard)."),
    click.option("--seq-len", default=64, show_default=True),
    click.option("--d-model", default=128, show_default=True),
    click.option("--n-layers", default=2, show_default=True),
    click.option("--n-kv-heads", default=None, type=int,
                 help="GQA: shared KV heads (default: n_heads, i.e. "
                      "MHA)."),
    click.option("--attention-window", default=None, type=int,
                 help="Sliding-window attention width (default: full "
                      "causal)."),
    click.option("--no-rope", is_flag=True,
                 help="Disable rotary position embeddings."),
    click.option("--moe-experts", default=None, type=int,
                 help="Mixture-of-experts FFN: replace every block's "
                      "dense MLP with this many expert MLPs (top-k "
                      "routed).  Changes the checkpoint tree, so every "
                      "command reading it needs the same value."),
    click.option("--moe-top-k", default=2, show_default=True,
                 help="Experts each token visits (with --moe-experts)."),
]


def model_arch_options(f):
    """The architecture flags every checkpoint-sharing command takes."""
    for opt in reversed(_MODEL_ARCH_OPTIONS):
        f = opt(f)
    return f


def model_config(vocab, seq_len, d_model, n_layers, n_kv_heads,
                 attention_window, no_rope, moe_experts=None,
                 moe_top_k=2, **extra):
    """Build the ModelConfig these flags describe (extra kwargs pass
    through to other fields such as dtype or attention)."""
    from tpu_autoscaler_torch.workloads.model import ModelConfig

    return ModelConfig(vocab=vocab, seq_len=seq_len, d_model=d_model,
                       n_layers=n_layers, n_kv_heads=n_kv_heads,
                       attention_window=attention_window,
                       rope=not no_rope, moe_experts=moe_experts,
                       moe_top_k=moe_top_k, **extra)


def device_count(platform: str) -> int:
    """The devices a serving command could spread over: the visible CUDA
    cards, or the one CPU."""
    if platform == "cpu":
        return 1
    import torch

    return torch.cuda.device_count()


def refuse_tp(tp_degree, n_devices: int) -> None:
    """``--tp`` of serve and generate, checked in the JAX CLIs' order:
    None or 1 serves on one device; a degree that does not divide the
    devices is refused in the JAX CLIs' words; any other degree > 1
    needs serving under a mesh, which waits for ROADMAP.md, Queue 1:
    the mesh."""
    if tp_degree is None or tp_degree <= 1:
        return
    if n_devices % tp_degree:
        raise click.UsageError(
            f"--tp {tp_degree} must divide the {n_devices} available "
            f"devices")
    raise click.UsageError(
        f"--tp {tp_degree} serves under a (data, model) mesh, which is not "
        f"ported yet (ROADMAP.md, Queue 1: the mesh)")
