"""Context-parallel (sequence-parallel) TRAINING on PyTorch.

The counterpart of the JAX package's ``workloads/sp.py``: the whole
train step (embed, blocks, loss, grads, AdamW) with the SEQUENCE cut
into one shard per rank.  The JAX step runs under ``shard_map`` over the
mesh's ``sp`` axis; here one process holds the ranks as a list of
devices (``make_sp_mesh``), rank r's shard on ``devices[r]``, and ranks
share a card when there are fewer cards than ranks:

- every pointwise op and product (norms, the qkv/out/MLP projections,
  the unembedding and the cross-entropy) touches only its rank's
  [b, s_loc] token block;
- RoPE rotates at GLOBAL positions (rank * s_loc + i), so the sharded
  model computes what the unsharded one does;
- attention is the ring (``ring_attention.py``: the einsum merge, or
  the kernel merge K5 with its K6 backward ring) or Ulysses;
- the loss is the global mean, the local sums added on the first rank's
  device; the params are one f32 master copy that every rank reads
  through ``.to(devices[r])``, so autograd sums the replicated params'
  gradients (JAX's "broadcast transposes to psum").

With MoE blocks (sp×ep) the sp ranks double as the expert group: each
rank routes its shard's tokens over every expert and the exchange of
``moe._ep_moe_ffn`` moves them to the rank that owns their expert and
back (``_sp_moe_ffn``).  With ``cfg.remat`` each layer, over all ranks
at once, runs under ``torch.utils.checkpoint``.  Waiting for ROADMAP.md,
Queue 1: EP and the SP compositions: a data axis beside ``sp``, sp×tp
and ZeRO-1.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from tpu_autoscaler_torch.workloads.model import (
    ModelConfig,
    TrainConfig,
    _chunked_ce,
    _device,
    _ffn_residual,
    _make_step,
    _map_tree,
    _rmsnorm,
    _rope,
    _split_qkv,
    make_optimizer,
)
from tpu_autoscaler_torch.workloads.moe import _ep_moe_ffn, _ranks_loss
from tpu_autoscaler_torch.workloads.ring_attention import (
    _ring_attn_local,
    make_local_ring_attention,
)
from tpu_autoscaler_torch.workloads.ulysses import _ulysses_local


def make_sp_mesh(devices=None, sp: int | None = None,
                 tp: int = 1) -> list[torch.device]:
    """The sequence-parallel ranks as a list of devices: ``sp`` ranks
    (default: one per device) over ``devices`` (default: every visible
    CUDA card), round-robin, so rank r is on ``devices[r %
    len(devices)]``.  Ranks that share a card are the counterpart of the
    JAX package's virtual devices.  ``tp > 1`` (the JAX mesh's ``model``
    axis) waits for ROADMAP.md, Queue 1: EP and the SP compositions."""
    if tp != 1:
        raise ValueError(f"sp×tp (tp={tp}) is not ported yet (ROADMAP.md, "
                         "Queue 1: EP and the SP compositions)")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass devices=['cpu'] "
                               "(--platform cpu) to run on the CPU")
        devices = range(torch.cuda.device_count())
        devices = [torch.device("cuda", i) for i in devices]
    devices = [_device(dev) for dev in devices]
    if not devices:
        raise ValueError("make_sp_mesh needs at least one device")
    sp = len(devices) if sp is None else sp
    if sp < 1:
        raise ValueError(f"sp must be >= 1, got {sp}")
    return [devices[r % len(devices)] for r in range(sp)]


def _sp_moe_ffn(ys, layers, cfg: ModelConfig, devices):
    """The MoE FFN under sequence parallelism: the sp ranks are also the
    expert group.  Rank t slices its experts [t·E/sp, (t+1)·E/sp) from
    the replicated weights (so expert compute drops by sp, the weights
    stay replicated like every sp param), routes its shard's tokens
    over every expert, and ``moe._ep_moe_ffn``'s exchange moves them to
    their experts' ranks and back.  Returns (outs, aux per rank)."""
    e_loc = cfg.moe_experts // len(ys)
    local = [{**layer, "w1": layer["w1"][t * e_loc:(t + 1) * e_loc],
              "w2": layer["w2"][t * e_loc:(t + 1) * e_loc]}
             for t, layer in enumerate(layers)]
    return _ep_moe_ffn(ys, local, devices, top_k=cfg.moe_top_k,
                       capacity_factor=cfg.moe_capacity_factor,
                       dtype=cfg.dtype)


def _sp_block(xs, layers, cfg: ModelConfig, *, attn, devices):
    """``model._block`` over every rank's sequence shard, the attention
    mix replaced by ``attn(qs, ks, vs) -> outs`` over all ranks: xs[r]
    [b, s_loc, d] and layers[r] (the layer's weights) on rank r's
    device (``devices[r]``).  Returns the ranks' new residual streams,
    with MoE blocks ``(streams, aux per rank)``."""
    qs, ks, vs = [], [], []
    for r, (x, layer) in enumerate(zip(xs, layers)):
        q, k, v = _split_qkv(_rmsnorm(x, layer["ln1"]), layer["qkv"], cfg)
        if cfg.rope:
            # Global positions: rank r's tokens sit at r * s_loc.
            offset = r * x.shape[1]
            q = _rope(q, cfg.rope_theta, offset)
            k = _rope(k, cfg.rope_theta, offset)
        qs.append(q)
        ks.append(k)
        vs.append(v)
    mixed = []
    for x, a, layer in zip(xs, attn(qs, ks, vs), layers):
        b, s_loc, _ = x.shape
        a = a.transpose(1, 2).reshape(b, s_loc, a.shape[1] * a.shape[3])
        mixed.append(x + a.to(cfg.dtype) @ layer["attn_out"].to(cfg.dtype))
    ys = [_rmsnorm(x, layer["ln2"]) for x, layer in zip(mixed, layers)]
    if cfg.moe_experts is not None:
        outs, auxs = _sp_moe_ffn(ys, layers, cfg, devices)
        return [x + o for x, o in zip(mixed, outs)], auxs
    return [_ffn_residual(x, y, layer, cfg)
            for x, y, layer in zip(mixed, ys, layers)]


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


def make_sp_loss(devices, cfg: ModelConfig, impl: str | None = None):
    """``loss_of(params, tokens) -> loss``: the global mean next-token NLL
    of tokens [b, s + 1] with the sequence cut over ``devices`` (one rank
    each, from :func:`make_sp_mesh`), on the first rank's device;
    ``params`` is the f32 master copy.  With MoE blocks (sp×ep) it
    returns ``(loss, metrics)``: the loss adds the weighted router
    losses, and metrics holds ``ce``, ``balance_loss``, ``z_loss`` and
    ``expert_fraction``, each the mean over layers, then over ranks.
    ``impl`` as in :func:`make_sp_train_step`, which differentiates this
    loss."""
    devices = [_device(dev) for dev in devices]
    world = len(devices)
    moe = cfg.moe_experts is not None
    if moe and cfg.moe_experts % world:
        raise ValueError(
            f"sp×ep needs moe_experts ({cfg.moe_experts}) divisible by the "
            f"sp axis ({world}) — the sp axis is reused as the expert axis "
            "(_sp_moe_ffn)")
    if impl is None:
        impl = "pallas" if devices[0].type == "cuda" else "einsum"
    if impl not in {"einsum", "pallas", "ulysses"}:
        raise ValueError(f"unknown sp impl {impl!r}")
    if impl == "ulysses" and (cfg.n_heads % world or cfg.kv_heads % world):
        raise ValueError(
            f"impl='ulysses' needs per-TP-rank heads divisible by the sp "
            f"axis ({world}): got {cfg.n_heads} q / {cfg.kv_heads} kv "
            f"local heads — use the ring impls for indivisible head "
            f"counts")
    if cfg.seq_len % world:
        raise ValueError(f"seq_len {cfg.seq_len} not divisible by the sp "
                         f"axis ({world})")
    window = cfg.attention_window
    if impl == "pallas":
        attn = make_local_ring_attention(devices, causal=True, window=window)
    elif impl == "ulysses":
        local = "pallas" if cfg.resolved_attention(devices[0]) == "kernel" \
            else "einsum"
        attn = functools.partial(_ulysses_local, devices=devices,
                                 causal=True, window=window, impl=local)
    else:
        def attn(qs, ks, vs):
            return _ring_attn_local(qs, ks, vs, devices, causal=True,
                                    window=window)[0]
    block = functools.partial(_sp_block, cfg=cfg, attn=attn, devices=devices)
    distinct = list(dict.fromkeys(devices))

    def loss_of(params: dict, tokens):
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        b, s = inputs.shape
        s_loc = s // world
        # The master params as each card reads them: the params
        # themselves on their own card, a differentiable copy elsewhere.
        on = {dev: _map_tree(lambda w, dev=dev: w.to(dev), params)
              for dev in distinct}
        shard = [on[dev] for dev in devices]

        def cut(t, r):
            return t[:, r * s_loc:(r + 1) * s_loc].to(devices[r])

        xs = [p["embed"].to(cfg.dtype)[cut(inputs, r)]
              for r, p in enumerate(shard)]
        per_layer = []
        for i in range(cfg.n_layers):
            layers = [{name: w[i] for name, w in p["blocks"].items()}
                      for p in shard]
            if cfg.remat:
                xs = checkpoint(block, xs, layers, use_reentrant=False)
            else:
                xs = block(xs, layers)
            if moe:
                xs, auxs = xs
                per_layer.append(auxs)
        total = sum(_local_ce_sum(x, p, cut(targets, r), cfg).to(devices[0])
                    for r, (x, p) in enumerate(zip(xs, shard)))
        ce = total / (b * s)
        return _ranks_loss(ce, per_layer, cfg, devices[0]) if moe else ce

    return loss_of


def make_sp_train_step(devices, cfg: ModelConfig, *,
                       train: TrainConfig | None = None,
                       impl: str | None = None, shard: str = "none"):
    """(init_fn, step_fn) training with the sequence cut over ``devices``
    (one rank each, from :func:`make_sp_mesh`).

    ``init_fn(generator) -> (params, opt_state)``: the f32 master params
    (``model.init_params``) on the first rank's device.
    ``step_fn(params, opt_state, tokens [b, s + 1]) -> (params,
    opt_state, loss)``: the gradient of :func:`make_sp_loss`'s loss,
    then the trainer's optimizer recipe (``model.make_optimizer``;
    clipping sees the summed global gradients).  ``impl``: "einsum" (the
    ring, f32 per-hop math), "pallas" (the ring with the kernel merge: K5
    forward, the K6 ring backward; the plain versions on CPU ranks) or
    "ulysses" (the all-to-all and local flash attention at full
    sequence: needs heads and kv heads divisible by the ranks); None
    takes the kernel ring on CUDA ranks and the einsum ring on CPU ranks.
    ``cfg.ce_chunk`` is honored on each rank's block.  With MoE blocks
    (sp×ep, needing moe_experts divisible by the ranks) step_fn returns
    ``(params, opt_state, loss, metrics)``, the expert-parallel step's
    signature (:func:`make_sp_loss`'s metrics).

    Refused until ROADMAP.md, Queue 1: EP and the SP compositions:
    ``shard="zero1"`` (sp×tp is refused by :func:`make_sp_mesh`).
    """
    if shard not in {"none", "zero1"}:
        raise ValueError(
            f"sp supports shard='none' or 'zero1', got {shard!r} "
            "(params replicate under sp; fsdp belongs to the dp/tp "
            "step)")
    if shard == "zero1":
        raise ValueError("sp with shard='zero1' is not ported yet "
                         "(ROADMAP.md, Queue 1: EP and the SP compositions)")
    loss_of = make_sp_loss(devices, cfg, impl)
    optimizer = make_optimizer(train or TrainConfig())
    return _make_step(cfg, optimizer, _device(devices[0]), loss_of,
                      has_aux=cfg.moe_experts is not None)
