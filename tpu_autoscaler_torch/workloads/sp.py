"""Context-parallel (sequence-parallel) TRAINING on PyTorch.

The counterpart of the JAX package's ``workloads/sp.py``: the whole
train step (embed, blocks, loss, grads, AdamW) with the SEQUENCE cut
over the mesh's ``sp`` axis and the batch over ``data``.  The JAX step
runs under ``shard_map``; here one process holds the ranks as a
``model.Mesh`` (``make_sp_mesh``: (data, sp), or (data, sp, model) for
sp×tp), and ranks share a card when there are fewer cards than ranks:

- every pointwise op and product (norms, the qkv/out/MLP projections,
  the unembedding and the cross-entropy) touches only its (data, sp)
  row's [b_loc, s_loc] token block, on the row's first model rank;
- RoPE rotates at GLOBAL positions (sp rank * s_loc + i), so the
  sharded model computes what the unsharded one does;
- attention is the ring (``ring_attention.py``: the einsum merge, or
  the kernel merge K5 with its K6 backward ring) or Ulysses, once per
  (data row, model rank) over that row's sp ranks;
- under sp×tp each model rank projects whole heads (q heads
  [t·h/tp, (t+1)·h/tp) and their KV groups), its ring carries only
  those heads, attn_out and w2 are row-parallel (summed over the model
  ranks) and w1 column-parallel: ``model._tp_attention`` /
  ``model._tp_ffn``, the rows being the sequence shards;
- the loss is the global mean over data × sp, the local sums added on
  the first rank's device; the params are one f32 master copy that
  every rank reads through ``.to()``, so autograd sums the replicated
  params' gradients (JAX's "broadcast transposes to psum").

With MoE blocks (sp×ep) the sp ranks of a data row double as the
expert group: each rank routes its shard's tokens over every expert and
the exchange of ``moe._ep_moe_ffn`` moves them to the rank that owns
their expert and back; under sp×ep×tp each expert's d_ff is cut over
the model ranks as well.  ``shard="zero1"`` cuts the AdamW moments over
every non-model axis (``model._zero1_spec``) as ``model.Sharded``
leaves; the params stay one copy.  With ``cfg.remat`` each layer, over
all ranks at once, runs under ``torch.utils.checkpoint``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from tpu_autoscaler_torch.workloads.model import (
    _PRODUCTS,
    Mesh,
    ModelConfig,
    P,
    TrainConfig,
    _chunked_ce,
    _device,
    _make_step,
    _map_tree,
    _replica_cut,
    _rmsnorm,
    _rope,
    _shard_state,
    _state_specs,
    _tp_attention,
    _tp_ffn,
    make_optimizer,
    mesh_rows,
    param_shapes,
)
from tpu_autoscaler_torch.workloads.moe import _ep_rows_ffn, _ranks_loss
from tpu_autoscaler_torch.workloads.ring_attention import (
    _ring_attn_local,
    make_local_ring_attention,
)
from tpu_autoscaler_torch.workloads.ulysses import _ulysses_local


def make_sp_mesh(devices=None, sp: int | None = None, tp: int = 1) -> Mesh:
    """(data, sp) mesh: batch over ``data``, sequence over ``sp``, as a
    ``model.Mesh`` over ``devices`` (default: every visible CUDA card; a
    device may repeat, so ranks share a card).

    sp defaults to all devices (pure context parallelism); pass a
    divisor for hybrid data x context parallelism.  ``tp > 1`` appends
    a ``model`` axis — (data, sp, model) — for the sp×tp composition:
    attention heads and d_ff Megatron-cut over ``model`` inside the sp
    train step (see make_sp_train_step)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass devices=['cpu'] "
                               "(--platform cpu) to run on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_device(dev) for dev in devices]
    n = len(devices)
    if sp is None:
        sp = n // tp
    if n % (sp * tp):
        raise ValueError(
            f"{n} devices not divisible by sp*tp = {sp * tp}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    if tp == 1:
        return Mesh(arr.reshape(n // sp, sp), ("data", "sp"))
    return Mesh(arr.reshape(n // (sp * tp), sp, tp), ("data", "sp", "model"))


def _as_sp_mesh(mesh) -> Mesh:
    """``mesh`` as a ``model.Mesh``: a plain list of devices (the ranks
    earlier callers pass) is a one-row (data, sp) mesh."""
    if isinstance(mesh, Mesh):
        return mesh
    devices = [_device(dev) for dev in mesh]
    arr = np.empty((1, len(devices)), dtype=object)
    arr[0, :] = devices
    return Mesh(arr, ("data", "sp"))


def _local_ce_sum(x, params: dict, targets, cfg: ModelConfig):
    """The summed next-token NLL of one rank's [b, s_loc] block (final
    norm, unembedding, cross-entropy), chunked when ``cfg.ce_chunk``
    divides s_loc."""
    b, s_loc = targets.shape
    x = _rmsnorm(x, params["ln_f"])
    if cfg.ce_chunk is not None and s_loc % cfg.ce_chunk == 0:
        return _chunked_ce(x, params["unembed"], targets, cfg.ce_chunk,
                           cfg.dtype) * (b * s_loc)
    logits = (x @ params["unembed"].to(cfg.dtype)).float()
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets[..., None].long()).sum()


def _check_sp(mesh: Mesh, cfg: ModelConfig, impl: str) -> None:
    """The JAX package's refusals of ``make_sp_train_step`` (after the
    shard mode and impl name)."""
    tp = mesh.shape.get("model", 1)
    sp = mesh.shape["sp"]
    if tp > 1:
        if cfg.n_heads % tp or cfg.kv_heads % tp:
            raise ValueError(
                f"sp×tp needs heads divisible by the model axis ({tp}): got "
                f"{cfg.n_heads} q / {cfg.kv_heads} kv heads")
        if cfg.d_ff % tp:
            raise ValueError(f"sp×tp needs d_ff ({cfg.d_ff}) divisible by "
                             f"the model axis ({tp})")
    if impl == "ulysses" and ((cfg.n_heads // tp) % sp
                              or (cfg.kv_heads // tp) % sp):
        raise ValueError(
            f"impl='ulysses' needs per-TP-rank heads divisible by the sp "
            f"axis ({sp}): got {cfg.n_heads // tp} q / {cfg.kv_heads // tp} "
            f"kv local heads — use the ring impls for indivisible head "
            f"counts")
    if cfg.moe_experts is not None and cfg.moe_experts % sp:
        raise ValueError(
            f"sp×ep needs moe_experts ({cfg.moe_experts}) divisible by the "
            f"sp axis ({sp}) — the sp axis is reused as the expert axis "
            "(_sp_moe_ffn)")
    if cfg.seq_len % sp:
        raise ValueError(f"seq_len {cfg.seq_len} not divisible by the sp "
                         f"axis ({sp})")


def _ring_attend(rows, sp: int, impl: str, cfg: ModelConfig, kernel: bool):
    """The ``attend`` of ``model._tp_attention`` for sequence-parallel
    rows (row d·sp + r holds data row d's sequence shard r): one ring
    (or Ulysses all-to-all) per (data row, model rank) over that row's
    sp ranks, on the model rank's heads."""
    window = cfg.attention_window
    rings = {}
    for start in range(0, len(rows), sp):
        for j in range(len(rows[0])):
            devices = [row[j] for row in rows[start:start + sp]]
            if impl == "pallas":
                fn = make_local_ring_attention(devices, causal=True,
                                               window=window)
            elif impl == "ulysses":
                fn = functools.partial(
                    _ulysses_local, devices=devices, causal=True,
                    window=window, impl="pallas" if kernel else "einsum")
            else:
                def fn(qs, ks, vs, devices=devices):
                    return _ring_attn_local(qs, ks, vs, devices, causal=True,
                                            window=window)[0]
            rings[start, j] = fn

    def attend(shards):
        outs = [[None] * len(row) for row in shards]
        for (start, j), fn in rings.items():
            qs, ks, vs = zip(*(row[j] for row in shards[start:start + sp]))
            for r, o in enumerate(fn(list(qs), list(ks), list(vs))):
                outs[start + r][j] = o
        return outs

    return attend


def make_sp_loss(mesh, cfg: ModelConfig, impl: str | None = None):
    """``loss_of(params, tokens) -> loss``: the global mean next-token NLL
    of tokens [b, s + 1] with the batch cut over the mesh's ``data``
    axis and the sequence over ``sp`` (``mesh``: :func:`make_sp_mesh`'s,
    or a plain list of devices, one sp rank each, as a one-row mesh), on
    the first rank's device; ``params`` is the f32 master copy.  With MoE
    blocks (sp×ep) it returns ``(loss, metrics)``: the loss adds the
    weighted router losses, and metrics holds ``ce``, ``balance_loss``,
    ``z_loss`` and ``expert_fraction``, each the mean over layers, then
    over the (data, sp) rows.  ``impl`` as in :func:`make_sp_train_step`,
    which differentiates this loss."""
    mesh = _as_sp_mesh(mesh)
    rows = mesh_rows(mesh)
    sp = mesh.shape["sp"]
    tp = len(rows[0])
    first = rows[0][0]
    if impl is None:
        impl = "pallas" if first.type == "cuda" else "einsum"
    if impl not in {"einsum", "pallas", "ulysses"}:
        raise ValueError(f"unknown sp impl {impl!r}")
    _check_sp(mesh, cfg, impl)
    moe = cfg.moe_experts is not None
    kernel = cfg.resolved_attention(first) == "kernel"
    attend = _ring_attend(rows, sp, impl, cfg, kernel)
    e_loc = cfg.moe_experts // sp if moe else None
    distinct = list(dict.fromkeys(mesh.ranks))

    def layer_fn(xs, on, layer, rope):
        views: dict = {}

        def w(name, i, j, dev):
            # The params are one copy: every row reads the same.
            if (name, j, dev) not in views:
                t = _replica_cut(cfg, tp, name,
                                 on[dev]["blocks"][name][layer], j)
                views[name, j, dev] = (t.to(cfg.dtype) if name in _PRODUCTS
                                       else t)
            return views[name, j, dev]

        def experts(i, m):
            # Row i's sp rank owns experts [r·E/sp, (r+1)·E/sp).
            r = i % sp
            dev = rows[i][m]
            return (w("w1", i, m, dev)[r * e_loc:(r + 1) * e_loc],
                    w("w2", i, m, dev)[r * e_loc:(r + 1) * e_loc])

        xs = _tp_attention(xs, w, rows, cfg, rope, attend)
        if moe:
            return _ep_rows_ffn(xs, w, rows, cfg, sp, experts)
        return _tp_ffn(xs, w, rows, cfg)[0], None

    def loss_of(params: dict, tokens):
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        b, s = inputs.shape
        data = len(rows) // sp
        if b % data:
            raise ValueError(f"batch {b} not divisible by the {data} data "
                             "rows")
        b_loc, s_loc = b // data, s // sp
        # The master params as each card reads them: the params
        # themselves on their own card, a differentiable copy elsewhere.
        on = {dev: _map_tree(lambda w, dev=dev: w.to(dev), params)
              for dev in distinct}

        def cut(t, i):
            d, r = divmod(i, sp)
            return t[d * b_loc:(d + 1) * b_loc,
                     r * s_loc:(r + 1) * s_loc].to(rows[i][0])

        def rope(t, i):
            # Global positions: sp rank r's tokens sit at r * s_loc.
            return _rope(t, cfg.rope_theta, (i % sp) * s_loc)

        xs = [on[row[0]]["embed"].to(cfg.dtype)[cut(inputs, i)]
              for i, row in enumerate(rows)]
        per_layer = []
        for layer in range(cfg.n_layers):
            fn = functools.partial(layer_fn, on=on, layer=layer,
                                   rope=rope if cfg.rope else None)
            if cfg.remat:
                xs, auxs = checkpoint(fn, xs, use_reentrant=False)
            else:
                xs, auxs = fn(xs)
            per_layer.append(auxs)
        total = sum(_local_ce_sum(x, on[row[0]], cut(targets, i),
                                  cfg).to(first)
                    for i, (x, row) in enumerate(zip(xs, rows)))
        ce = total / (b * s)
        return _ranks_loss(ce, per_layer, cfg, first) if moe else ce

    return loss_of


def shard_sp_opt_state(mesh, cfg: ModelConfig, state: dict,
                       shard: str = "zero1") -> dict:
    """A one-device optimizer state as the sp step keeps it: as it is
    (shard "none"), or, under "zero1", each moment cut over every
    non-model axis of the mesh on its first axis they divide
    (``model._zero1_spec`` of a replicated param, the JAX step's
    ``opt_state_shardings``), each rank's slice on its own device;
    ``model.gather_params`` is the inverse (checkpoints)."""
    if shard == "none":
        return state
    mesh = _as_sp_mesh(mesh)
    specs = _state_specs(state, _map_tree(lambda _: P(), param_shapes(cfg)),
                         mesh, True)
    return _shard_state(mesh, cfg, state, specs)


def make_sp_train_step(mesh, cfg: ModelConfig, *,
                       train: TrainConfig | None = None,
                       impl: str | None = None, shard: str = "none"):
    """(init_fn, step_fn) training with the sequence cut over ``mesh``'s
    ``sp`` axis and the batch over ``data`` (:func:`make_sp_mesh`'s
    mesh, or a plain list of devices, one sp rank each).  A mesh with a
    ``model`` axis turns on sp×tp: attention heads and d_ff
    Megatron-cut over ``model`` inside every block (each ring then
    carries 1/tp of the K/V); needs n_heads, kv_heads and d_ff
    divisible by tp.

    ``init_fn(generator) -> (params, opt_state)``: the f32 master params
    (``model.init_params``) on the first rank's device, and their
    optimizer state.  ``step_fn(params, opt_state, tokens [b, s + 1]) ->
    (params, opt_state, loss)``: the gradient of :func:`make_sp_loss`'s
    loss, then the trainer's optimizer recipe (``model.make_optimizer``;
    clipping sees the summed global gradients).  ``impl``: "einsum" (the
    ring, f32 per-hop math), "pallas" (the ring with the kernel merge: K5
    forward, the K6 ring backward; the plain versions on CPU ranks) or
    "ulysses" (the all-to-all and local flash attention at full
    sequence: needs each model rank's heads and kv heads divisible by
    sp); None takes the kernel ring on CUDA ranks and the einsum ring on
    CPU ranks.  ``cfg.ce_chunk`` is honored on each rank's block.  With
    MoE blocks (sp×ep, needing moe_experts divisible by sp) step_fn
    returns ``(params, opt_state, loss, metrics)``, the expert-parallel
    step's signature (:func:`make_sp_loss`'s metrics).

    ``shard="zero1"`` cuts the AdamW moments over every non-model axis
    (data × sp; :func:`shard_sp_opt_state`) as ``model.Sharded`` leaves, the
    params staying one copy; the step's maths does not change.  The step
    takes the moments in that layout (:func:`shard_sp_opt_state` cuts a
    one-device state).
    """
    cfg.require_uniform("sequence parallelism")
    if shard not in {"none", "zero1"}:
        raise ValueError(
            f"sp supports shard='none' or 'zero1', got {shard!r} "
            "(params replicate under sp; fsdp belongs to the dp/tp "
            "step)")
    mesh = _as_sp_mesh(mesh)
    loss_of = make_sp_loss(mesh, cfg, impl)
    optimizer = make_optimizer(train or TrainConfig())
    init_fn, step_fn = _make_step(cfg, optimizer, mesh.ranks[0], loss_of,
                                  has_aux=cfg.moe_experts is not None)
    if shard == "none":
        return init_fn, step_fn

    def init_zero1(generator: torch.Generator):
        params, opt_state = init_fn(generator)
        return params, shard_sp_opt_state(mesh, cfg, opt_state, shard)

    return init_zero1, step_fn
