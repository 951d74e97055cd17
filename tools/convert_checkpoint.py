"""Convert trainer checkpoints between the JAX package and its PyTorch port.

    python tools/convert_checkpoint.py --from SRC --to DST \\
        --direction jax-to-torch|torch-to-jax [--step N] [trainer flags]

The JAX trainer (``python -m tpu_autoscaler.workloads.train``) saves
``SRC/step_N`` as an orbax tree ``{"params": ..., "opt": optax state}``;
the port's trainer (``python -m tpu_autoscaler_torch.workloads.train``)
saves ``step_N/params.npz`` (the layout of ``model.save_params``, which
the port's ``serve`` and ``generate`` read) and ``step_N/opt.npz`` (the
state of the port's ``model.Optimizer``: ``count``, the ``mu/...`` and
``nu/...`` trees and, with ``--accum-steps`` > 1, ``mini_step``,
``gradient_step`` and ``acc/...``).  This tool moves a checkpoint from
one layout to the other, leaf for leaf and bit for bit, so a job drained
on one side resumes on the other, and the port serves what the JAX
trainer trained.

The optax state's shape follows the trainer's flags, so the tool takes
the ones that change it: the model flags (the leaves' shapes),
``--lr-schedule``/``--warmup-steps``/``--steps`` (a schedule adds its
own step count), ``--grad-clip`` (a clip state in front of the chain),
``--accum-steps`` (``optax.MultiSteps`` around it) and ``--pp-stages``
with ``--tp`` (the JAX dp×pp×tp trainer saves ``blocks.qkv`` split into
``wq``/``wk``/``wv``, in the params and in every moment; the port saves
it merged).  The orbax tree is restored against the target the JAX
package's own init builds for those flags.  ``--step`` defaults to the
source's latest.  ``DST/step_N`` appears atomically (a step already
there is replaced); ``SRC`` is only read.

The tool imports both packages, so it runs where JAX and orbax are
installed, on the host's CPU.
"""

from __future__ import annotations

import os
import sys

import click
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tpu_autoscaler.workloads._cli import (  # noqa: E402
    model_arch_options,
    model_config,
)

# optax state fields that hold a tree shaped like the params, by the
# name the port's Optimizer state gives them.
_TREES = {"mu": "mu", "nu": "nu", "acc_grads": "acc"}
_COUNTERS = ("count", "mini_step", "gradient_step")


def jax_target(cfg, train_cfg, split: bool):
    """The abstract ``{"params", "opt"}`` the JAX trainer saves for these
    flags, from the JAX package's own init (shapes and dtypes only)."""
    import jax

    from tpu_autoscaler.workloads.model import init_params, make_optimizer
    from tpu_autoscaler.workloads.pipeline import split_qkv_weights

    def init():
        params = init_params(jax.random.PRNGKey(0), cfg)
        if split:
            params = split_qkv_weights(params, cfg)
        return {"params": params,
                "opt": make_optimizer(train_cfg).init(params)}

    device = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])
    return jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=device),
        jax.eval_shape(init))


def _is_state(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def opt_fields(opt) -> dict:
    """The port Optimizer's fields from an optax state of numpy leaves:
    the counters as ints (adam's and the schedule's counts must agree),
    the moment and accumulator trees as they are."""
    out: dict = {}

    def walk(node):
        if _is_state(node):
            for name in node._fields:
                value = getattr(node, name)
                if name in _TREES:
                    out[_TREES[name]] = value
                elif name in _COUNTERS:
                    value = int(value)
                    if out.setdefault(name, value) != value:
                        raise ValueError(f"optax state holds two {name}s: "
                                         f"{out[name]} and {value}")
                else:
                    walk(value)
        elif isinstance(node, tuple):
            for child in node:
                walk(child)
        else:
            raise ValueError(f"unexpected optax state node {node!r}")

    walk(opt)
    return out


def fill_opt(target, fields: dict):
    """The optax state of ``target``'s structure holding ``fields`` (the
    inverse of :func:`opt_fields`), counters in the target's dtype."""
    import jax.numpy as jnp

    def fill(node):
        if _is_state(node):
            values = {}
            for name in node._fields:
                value = getattr(node, name)
                if name in _TREES:
                    values[name] = fields[_TREES[name]]
                elif name in _COUNTERS:
                    values[name] = jnp.asarray(fields[name], value.dtype)
                else:
                    values[name] = fill(value)
            return type(node)(**values)
        return tuple(fill(child) for child in node)

    return fill(target)


def _trees(state: dict) -> list[str]:
    return ["params"] + [k for k in ("mu", "nu", "acc") if k in state]


def _check_like(tree, target, what: str) -> None:
    """Every leaf of ``tree`` has the shape and dtype of ``target``'s."""
    import jax

    paths = jax.tree_util.tree_flatten_with_path(target)[0]
    got = jax.tree_util.tree_flatten_with_path(tree)[0]
    if [p for p, _ in got] != [p for p, _ in paths]:
        raise ValueError(
            f"{what}: the checkpoint's tree does not match the flags' "
            f"(got {[jax.tree_util.keystr(p) for p, _ in got]})")
    for (path, leaf), (_, want) in zip(got, paths):
        if leaf.shape != want.shape or leaf.dtype != want.dtype:
            raise ValueError(
                f"{what}{jax.tree_util.keystr(path)}: {leaf.dtype}"
                f"{list(leaf.shape)} where the flags give {want.dtype}"
                f"{list(want.shape)}")


def jax_to_torch(src: str, dst: str, step: int, cfg, train_cfg,
                 split: bool) -> str:
    """Read the JAX trainer's orbax ``src/step_<step>`` and write the
    port trainer's ``dst/step_<step>``; returns its path."""
    import jax

    from tpu_autoscaler.workloads.checkpoint import restore_checkpoint
    from tpu_autoscaler.workloads.pipeline import merge_qkv_weights
    from tpu_autoscaler_torch.workloads import checkpoint, model

    restored = jax.tree.map(np.asarray, restore_checkpoint(
        src, step, jax_target(cfg, train_cfg, split)))
    state = {"params": restored["params"], **opt_fields(restored["opt"])}
    for name in _trees(state):
        tree = merge_qkv_weights(state[name], cfg) if split else state[name]
        state[name] = model.params_from_jax(tree, "cpu")
    params = state.pop("params")
    return checkpoint.save_checkpoint(dst, step, {"params": params,
                                                  "opt": state})


def torch_to_jax(src: str, dst: str, step: int, cfg, train_cfg,
                 split: bool) -> str:
    """Read the port trainer's ``src/step_<step>`` and write an orbax
    ``dst/step_<step>`` that the JAX trainer restores for the same
    flags; returns its path."""
    import jax.numpy as jnp

    from tpu_autoscaler.workloads.checkpoint import save_checkpoint
    from tpu_autoscaler.workloads.pipeline import split_qkv_weights
    from tpu_autoscaler_torch.workloads import checkpoint, model

    restored = checkpoint.restore_checkpoint(src, step, "cpu")
    state = dict(restored["opt"], params=restored["params"])
    for name in _trees(state):
        tree = model._map_tree(lambda t: jnp.asarray(t.numpy()),
                               state[name])
        state[name] = split_qkv_weights(tree, cfg) if split else tree
    target = jax_target(cfg, train_cfg, split)
    out = {"params": state.pop("params"),
           "opt": fill_opt(target["opt"], state)}
    _check_like(out, target, f"{src}/step_{step}")
    return save_checkpoint(dst, step, out)


@click.command()
@click.option("--from", "src", required=True,
              help="Checkpoint directory to read (its step_N dirs).")
@click.option("--to", "dst", required=True,
              help="Checkpoint directory to write step_N into.")
@click.option("--direction", required=True,
              type=click.Choice(["jax-to-torch", "torch-to-jax"]))
@click.option("--step", default=None, type=int,
              help="Step to convert (default: the source's latest).")
@model_arch_options
@click.option("--steps", default=100, show_default=True,
              help="The trainer's --steps (cosine's decay horizon).")
@click.option("--warmup-steps", default=0, show_default=True)
@click.option("--lr-schedule", type=click.Choice(["constant", "cosine"]),
              default="constant", show_default=True)
@click.option("--grad-clip", default=None, type=float)
@click.option("--accum-steps", default=1, show_default=True)
@click.option("--pp-stages", default=1, show_default=True)
@click.option("--tp", "tp_degree", default=None, type=int,
              help="With --pp-stages > 1: the JAX checkpoint holds the "
                   "split wq/wk/wv tree.")
def main(src, dst, direction, step, vocab, seq_len, d_model, n_layers,
         n_kv_heads, attention_window, no_rope, moe_experts, moe_top_k,
         steps, warmup_steps, lr_schedule, grad_clip, accum_steps,
         pp_stages, tp_degree):
    """Convert one trainer checkpoint between the JAX package's orbax
    layout and the port's step_N/*.npz."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from tpu_autoscaler.workloads import checkpoint as jax_checkpoint
    from tpu_autoscaler.workloads.model import TrainConfig
    from tpu_autoscaler_torch.workloads import checkpoint

    if os.path.abspath(src) == os.path.abspath(dst):
        raise click.UsageError("--to must differ from --from")
    latest = (jax_checkpoint.latest_step if direction == "jax-to-torch"
              else checkpoint.latest_step)
    if step is None:
        step = latest(src)
        if step is None:
            raise click.UsageError(f"no step_N checkpoint in {src}")
    elif not os.path.isdir(os.path.join(src, f"step_{step}")):
        raise click.UsageError(f"no step_{step} in {src}")
    try:
        cfg = model_config(vocab, seq_len, d_model, n_layers, n_kv_heads,
                           attention_window, no_rope, moe_experts,
                           moe_top_k)
        train_cfg = TrainConfig(
            warmup_steps=warmup_steps,
            decay_steps=steps if lr_schedule == "cosine" else None,
            grad_clip=grad_clip, accum_steps=accum_steps)
    except ValueError as e:
        raise click.UsageError(str(e)) from e
    convert = jax_to_torch if direction == "jax-to-torch" else torch_to_jax
    # The JAX trainer's dp×pp×tp step (--pp-stages > 1 with --tp given)
    # saves the split wq/wk/wv tree.
    path = convert(src, dst, step, cfg, train_cfg,
                   pp_stages > 1 and tp_degree is not None)
    click.echo(f"converted step {step} ({direction}): "
               f"{os.path.join(src, f'step_{step}')} -> {path}")


if __name__ == "__main__":
    main()
