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


def serving_mesh(tp_degree, n_devices: int, platform: str):
    """The mesh ``--tp`` asks serve and generate for, or None: None or
    1 serves on one device; a degree the devices do not divide is
    refused in the JAX CLIs' words; a degree above the device count
    repeats the devices round-robin, as the trainer's ``--tp`` does
    (NCCL will not put two ranks on one card, so the ranks live in one
    process); otherwise ``make_mesh`` over every device, the devices
    the degree leaves over the data rows."""
    if tp_degree is None or tp_degree <= 1:
        return None
    if tp_degree <= n_devices and n_devices % tp_degree:
        raise click.UsageError(
            f"--tp {tp_degree} must divide the {n_devices} available "
            f"devices")
    from tpu_autoscaler_torch.workloads.model import make_mesh

    cards = (["cpu"] * n_devices if platform == "cpu"
             else [f"cuda:{i}" for i in range(n_devices)])
    if tp_degree > len(cards):
        cards = [cards[r % len(cards)] for r in range(tp_degree)]
    return make_mesh(cards, tp=tp_degree)
