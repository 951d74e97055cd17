"""Mixture-of-experts FFN and expert parallelism (ep), on PyTorch.

The counterpart of the JAX package's ``workloads/moe.py``, and the
port's own dropless route.  Two routes, chosen by
``ModelConfig.moe_capacity_factor``:

- **Capacity** (a factor; the JAX package's): the routing rule
  ``route_topk`` every capacity path of the port shares, the flagship
  model's per-row dispatch (``model.moe_ffn``), the expert-parallel
  step (``_ep_moe_ffn``, ``make_ep_train_step``) and sp×ep
  (``sp.py``).  Each expert takes at most ``capacity`` tokens of a
  routing pool into an [E, cap, d] buffer; tokens over it are dropped
  (they contribute zero; the residual carries them),
  switch-transformer style.
- **Dropless** (None; ``dropless_ffn``, one device): what published
  MoE models such as Mellum2 run, with SwiGLU experts.  Every token goes to its top-k
  experts (``route_dropless``: softmax in f32, top-k with ties to the
  lower index, renormalised).  The (token, choice) pairs are
  sorted by expert on the device and each weight runs as one grouped
  product over the sorted rows (``grouped_mm``: ``torch._grouped_mm``
  on the card, whose group ends stay on the device; a loop over
  experts elsewhere), so a step does the work of its tokens, not of E
  full buffers, and never syncs the host.  Rows the caller marks
  invalid (a prefill lane's padding) are not routed.

The JAX package shards experts over a mesh axis and moves tokens with
two ``lax.all_to_all`` exchanges.  Here one process holds the ranks as
a ``model.Mesh`` (``make_ep_mesh``: (data, ep), or (data, ep, model)
for ep×tp), and ranks may share a card, as every mesh of the port's
may.  The exchange is a transpose of a per-rank list: rank t receives
bucket t of every rank of its ep group, a ``.to()`` copy between cards
and none on one card.  The ep step's expert weights and their Adam
moments are ``model.Sharded`` leaves cut over ep (and over model on
d_ff), each block on its rank's device.

The layer computes the two auxiliary router losses a trainable MoE
needs: the load-balance loss ``E * Σ_e f_e · p_e`` (f_e the share of
assignments to expert e, p_e its mean router probability) and the
router z-loss ``mean(logsumexp(logits)²)``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    d_model: int = 32
    d_ff: int = 64
    num_experts: int = 8
    capacity_factor: float = 1.25
    top_k: int = 1

    def __post_init__(self) -> None:
        if not 1 <= self.top_k <= self.num_experts:
            raise ValueError(
                f"top_k must be in [1, {self.num_experts}], got "
                f"{self.top_k}")


def init_moe_params(generator: torch.Generator, cfg: MoeConfig,
                    device=None) -> dict:
    """f32 ``router`` [d, E], ``w1`` [E, d, f] and ``w2`` [E, f, d],
    normal and scaled by fan-in (router 0.02), drawn from ``generator``
    on its own device and placed on ``device``."""
    from tpu_autoscaler_torch.workloads.model import resolve_device

    dev = resolve_device(device)
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    out = {}
    for name, shape, scale in (("router", (d, e), 0.02),
                               ("w1", (e, d, f), d ** -0.5),
                               ("w2", (e, f, d), f ** -0.5)):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        out[name] = (x * scale).to(dev)
    return out


def route_topk(logits: torch.Tensor, k: int, capacity: int):
    """THE routing rule, shared by every MoE path of the port.

    logits: [..., n, e] f32 router scores of n tokens (leading dims are
    independent routing pools).  Returns ``(expert, rank, gate, keep,
    aux)``, the first four [..., n, k]:

    - ``expert[i, c]``: token i's c-th choice (int64), the c-th largest
      router probability; among equal probabilities the lower expert
      index comes first, as ``jax.lax.top_k`` orders them (a stable
      descending sort; ``torch.topk`` promises no order for ties);
    - ``rank[i, c]``: its slot in that expert's capacity buffer (int64),
      choice-major (every first choice before any second), then
      token-major;
    - ``gate[i, c]``: the combine weight, the raw probability for k = 1,
      else renormalised over the k choices;
    - ``keep[i, c]``: False when the expert was already at ``capacity``;
    - ``aux``: ``balance_loss`` and ``z_loss`` [...] and
      ``expert_fraction`` [..., e], over all assignments, kept or not.
    """
    e = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :k], topi[..., :k]               # [..., n, k]
    if k == 1:
        # Switch-style: renormalising a single choice would pin it to 1
        # and cut the router out of the gradient.
        gate = topv
    else:
        gate = topv / torch.clamp_min(topv.sum(dim=-1, keepdim=True), 1e-9)

    onehot = F.one_hot(topi, e)                             # [..., n, k, e]
    # Slot of (token i, choice c): earlier choices of every token, then
    # earlier tokens of the same choice.
    per_choice = onehot.transpose(-3, -2)                   # [..., k, n, e]
    within = per_choice.cumsum(dim=-2) - per_choice
    counts = per_choice.sum(dim=-2)                         # [..., k, e]
    prior = counts.cumsum(dim=-2) - counts
    rank_full = within + prior.unsqueeze(-2)                # [..., k, n, e]
    rank = (rank_full.transpose(-3, -2) * onehot).sum(dim=-1)
    keep = rank < capacity

    frac = onehot.sum(dim=-2).float().mean(dim=-2) / k      # [..., e]
    mean_prob = probs.mean(dim=-2)
    balance = e * (frac * mean_prob).sum(dim=-1)
    z = torch.logsumexp(logits, dim=-1).square().mean(dim=-1)
    aux = {"balance_loss": balance, "z_loss": z, "expert_fraction": frac}
    return topi, rank, gate, keep, aux


def dispatch(x, expert, rank, keep, n_experts: int, capacity: int):
    """x [g, n, d] -> the capacity buffers [g, E, cap, d]: assignment
    (i, c) of group g at slot (expert, rank).  Dropped assignments add
    zeros at their expert's slot 0; the buffer accumulates (a plain
    write would let that zero race a kept token there)."""
    g, n, d = x.shape
    k = expert.shape[-1]
    safe = torch.where(keep, rank, 0)
    group = torch.arange(g, device=x.device)[:, None, None]
    slot = (group * n_experts + expert) * capacity + safe    # [g, n, k]
    vals = torch.where(keep[..., None], x[:, :, None, :].expand(g, n, k, d),
                       x.new_zeros(()))
    buf = x.new_zeros(g * n_experts * capacity, d).index_add(
        0, slot.reshape(-1), vals.reshape(-1, d))
    return buf.reshape(g, n_experts, capacity, d)


def combine(buf, expert, rank, gate, keep):
    """The gate-weighted sum of each token's kept expert outputs: buf
    [g, E, cap, d] -> [g, n, d] in buf's dtype.  The f32 gate is cast
    to that dtype first, so a bf16 stream stays bf16; dropped choices
    give zero output and zero gradient."""
    g, n_experts, capacity, d = buf.shape
    safe = torch.where(keep, rank, 0)
    group = torch.arange(g, device=buf.device)[:, None, None]
    o = buf.reshape(-1, d)[(group * n_experts + expert) * capacity + safe]
    out = buf.new_zeros(o.shape[:2] + (d,))
    for c in range(expert.shape[-1]):
        out = out + torch.where(
            keep[..., c, None], gate[..., c, None].to(o.dtype) * o[:, :, c],
            buf.new_zeros(()))
    return out


def expert_mlp(buf, w1, w2):
    """Each expert's gelu MLP over its buffers: buf [g, e, cap, d] with
    w1 [e, d, f], w2 [e, f, d] -> [g, e, cap, d], as one batched product
    per weight over the expert dim."""
    g, e, cap, d = buf.shape
    flat = buf.transpose(0, 1).reshape(e, g * cap, d)
    h = F.gelu(torch.bmm(flat, w1), approximate="tanh")
    out = torch.bmm(h, w2)
    return out.reshape(e, g, cap, -1).transpose(0, 1)


def route_dropless(logits: torch.Tensor, k: int):
    """Top-k routing with no capacity: logits [n, e] f32 -> (expert
    [n, k] int64, gate [n, k] f32).  Probabilities are the softmax in
    f32; the k largest in order, ties to the lower expert index (a
    stable descending sort, as :func:`route_topk`), renormalised over
    the k (``norm_topk_prob``)."""
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :k], topi[..., :k]
    return topi, topv / topv.sum(dim=-1, keepdim=True)


def grouped_mm(a: torch.Tensor, w: torch.Tensor,
               ends: torch.Tensor) -> torch.Tensor:
    """Rows of ``a`` [m, k] in groups by expert times that expert's
    weight ``w`` [E, k, n] -> [m, n]: group e is rows [ends[e - 1],
    ends[e]) (``ends`` int32 [E] on a's device).  Rows past ends[-1]
    are left unset.  bf16 CUDA tensors take ``torch._grouped_mm``, one
    launch whose group ends stay on the device; anything else loops over
    the experts, reading ``ends`` on the host."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch._grouped_mm(a, w, offs=ends)
    out = a.new_empty(a.shape[0], w.shape[-1])
    start = 0
    for e, end in enumerate(ends.tolist()):
        if end > start:
            out[start:end] = a[start:end] @ w[e]
        start = end
    return out


def dropless_ffn(y: torch.Tensor, layer: dict, cfg, *, valid=None,
                 counter=None, aux: bool = True):
    """The dropless MoE FFN over y [b, s, d] (post-norm activations in
    the compute dtype): route every token in f32 (``layer["router"]``
    [d, E]; :func:`route_dropless`), sort its k (token, choice) pairs by
    expert, run the SwiGLU experts' ``w1`` [E, d, 2 f] (gate | up) and
    ``w2`` [E, f, d] as grouped products over the sorted rows
    (:func:`grouped_mm`), put the rows back in token order
    and sum each token's k outputs gate-weighted (the f32 gates cast to
    the compute dtype, one batched product with f32 accumulation).

    ``valid`` [b, s] bool: rows left out of the routing (sorted past
    every group, their output zero).  ``counter``: records the call's
    group ends [E] int32 on the device (the assignments are the last,
    the experts that took a token its non-empty groups).  Returns
    (out [b, s, d], aux): the balance and z losses over the valid
    tokens, or zeros with ``aux`` False."""
    b, s, d = y.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    x = y.reshape(b * s, d)
    logits = x.float() @ layer["router"].float()
    expert, gate = route_dropless(logits, k)
    flat = expert.reshape(-1)
    if valid is not None:
        # Pairs of invalid rows sort after every group (expert E).
        flat = torch.where(valid.reshape(-1, 1), expert, E).reshape(-1)
    ordered, order = torch.sort(flat, stable=True)
    ends = torch.searchsorted(
        ordered, torch.arange(1, E + 1, device=y.device), out_int32=True)
    w1, w2 = layer["w1"].to(cfg.dtype), layer["w2"].to(cfg.dtype)
    gated, up = grouped_mm(x[order // k], w1, ends).chunk(2, dim=-1)
    o = grouped_mm(F.silu(gated) * up, w2, ends)
    if valid is not None:
        o = torch.where((ordered < E)[:, None], o, o.new_zeros(()))
    back = torch.empty_like(o)
    back[order] = o
    out = torch.bmm(gate.to(o.dtype)[:, None, :],
                    back.reshape(b * s, k, d)).reshape(b, s, d)
    if counter is not None:
        counter.add(ends)
    if not aux:
        zero = torch.zeros((), dtype=torch.float32, device=y.device)
        return out, {"balance_loss": zero, "z_loss": zero}
    keep = torch.ones(b * s, device=y.device) if valid is None \
        else valid.reshape(-1).float()
    n = keep.sum().clamp_min(1)
    frac = (F.one_hot(expert, E).sum(dim=1).float() * keep[:, None]).sum(0) \
        / (n * k)
    mean_prob = (torch.softmax(logits, dim=-1) * keep[:, None]).sum(0) / n
    z = (torch.logsumexp(logits, dim=-1).square() * keep).sum() / n
    return out, {"balance_loss": E * (frac * mean_prob).sum(), "z_loss": z}


def moe_reference(params: dict, x: torch.Tensor, capacity: int | None = None,
                  top_k: int = 1) -> torch.Tensor:
    """Unsharded oracle: x [n, d], top-k routing, optional per-expert
    capacity; each token's chosen experts' weights gathered per token."""
    n = x.shape[0]
    logits = (x @ params["router"]).float()
    cap = capacity if capacity is not None else n * top_k
    expert, _, gate, keep, _ = route_topk(logits, top_k, cap)
    out = torch.zeros_like(x)
    for c in range(top_k):
        h = F.gelu(torch.einsum("nd,ndf->nf", x, params["w1"][expert[:, c]]),
                   approximate="tanh")
        o = torch.einsum("nf,nfd->nd", h, params["w2"][expert[:, c]])
        out = out + torch.where(keep[:, c, None],
                                gate[:, c, None].to(o.dtype) * o,
                                o.new_zeros(()))
    return out.to(x.dtype)


def _exchange(parts, devices):
    """The all_to_all of one ep group: parts[s] [ep, ...] on rank s ->
    received[t] [ep, ...] on ``devices[t]``, received[t][s] =
    parts[s][t] (rank t gets bucket t of every source, in source
    order).  It is its own inverse."""
    return [torch.stack([p[t].to(dev) for p in parts])
            for t, dev in enumerate(devices)]


def _ep_moe_ffn(ys, layers, devices, *, top_k: int,
                capacity_factor: float, dtype=None):
    """The expert-parallel MoE FFN of one ep group: ys[r] [b_loc, s, d]
    on ``devices[r][0]``, where devices[r] lists ep rank r's model ranks
    (one device without a 'model' axis), and layers[r]: ``router`` [d,
    E] and this rank's experts, ``w1`` / ``w2`` lists over its model
    ranks of [E/ep, d, f/tp] / [E/ep, f/tp, d] (each expert's d_ff cut
    over the model ranks under ep×tp); ``dtype``, when given, is the
    compute dtype the router and expert weights are cast to.  Each rank
    routes its LOCAL pool (capacity = capacity_factor·n_loc·k/E,
    pool-level GShard semantics, against ``model.moe_ffn``'s per-row
    dispatch), the router product in the compute dtype then cast to
    f32; for each model rank the buckets go to their experts' ranks,
    each runs its experts' MLPs on its d_ff cut, and the outputs come
    back for the gate-weighted combine, which is summed over the model
    ranks after the combine (the JAX package's row-parallel psum: the
    return exchange, the gather and the gates are linear in the expert
    outputs, so [n_loc, d] is reduced instead of the larger capacity
    buffers).  Returns (outs [b_loc, s, d] per rank, aux per rank).

    The balance loss is nonlinear in (f, p), so the pool estimate
    differs from the per-row one by the rows' covariance (zero for a
    one-row pool); both are the JAX package's."""
    ep, k = len(ys), top_k
    if dtype is not None:
        layers = [{"router": layer["router"].to(dtype),
                   "w1": [w.to(dtype) for w in layer["w1"]],
                   "w2": [w.to(dtype) for w in layer["w2"]]}
                  for layer in layers]
    e = layers[0]["router"].shape[-1]
    e_loc = e // ep
    routes, buckets = [], []
    for y, layer in zip(ys, layers):
        b, s, d = y.shape
        cap = max(1, int(capacity_factor * b * s * k / e))
        flat = y.reshape(1, b * s, d)
        logits = (flat @ layer["router"]).float()
        expert, rank, gate, keep, aux = route_topk(logits, k, cap)
        routes.append((expert, rank, gate, keep, aux))
        buckets.append(dispatch(flat, expert, rank, keep, e, cap)
                       .reshape(ep, e_loc, cap, d))
    outs = [None] * ep
    for m in range(len(devices[0])):
        ranks = [row[m] for row in devices]
        received = _exchange(buckets, ranks)        # [ep(src), e_loc, cap, d]
        expert_out = [expert_mlp(buf, layer["w1"][m], layer["w2"][m])
                      for buf, layer in zip(received, layers)]
        returned = _exchange(expert_out, ranks)     # [ep(owner), e_loc, ...]
        for r, (y, ret, route) in enumerate(zip(ys, returned, routes)):
            expert, rank, gate, keep = (t.to(ret.device) for t in route[:4])
            combined = ret.reshape(1, e, *ret.shape[2:])
            out = combine(combined, expert, rank, gate, keep).reshape(
                y.shape).to(y.device)
            outs[r] = out if outs[r] is None else outs[r] + out
    auxs = [{name: v[0] for name, v in route[4].items()} for route in routes]
    return outs, auxs


def _ep_rows_ffn(xs, w, rows, cfg, ep: int, experts):
    """The FFN half of a block whose rows form expert-parallel groups:
    rows ``[g, g + ep)`` for each g, one per ep rank; ``xs``, ``w`` and
    ``rows`` as ``model._tp_attention`` takes them, ``experts(i, m) ->
    (w1, w2)`` row i's experts at model rank m on ``rows[i][m]``.  Each
    group runs :func:`_ep_moe_ffn` on the post-ln2 activations of its
    rows.  Returns (new streams, each row's router aux)."""
    from tpu_autoscaler_torch.workloads.model import _rmsnorm

    new, auxs = [], []
    for g in range(0, len(rows), ep):
        group = rows[g:g + ep]
        ys = [_rmsnorm(x, w("ln2", i, 0, row[0]))
              for i, (x, row) in enumerate(zip(xs[g:g + ep], group), g)]
        layers = []
        for i, row in enumerate(group, g):
            pairs = [experts(i, m) for m in range(len(row))]
            layers.append({"router": w("router", i, 0, row[0]),
                           "w1": [p[0] for p in pairs],
                           "w2": [p[1] for p in pairs]})
        outs, a = _ep_moe_ffn(ys, layers, group, top_k=cfg.moe_top_k,
                              capacity_factor=cfg.moe_capacity_factor,
                              dtype=cfg.dtype)
        new += [x + o for x, o in zip(xs[g:g + ep], outs)]
        auxs += a
    return new, auxs


def _mean_aux(auxs: list[dict], device) -> dict:
    """The elementwise mean of per-rank (or per-layer) aux dicts, on
    ``device``."""
    return {name: torch.stack([a[name].to(device) for a in auxs]).mean(dim=0)
            for name in auxs[0]}


def _ranks_loss(ce, per_layer: list[list[dict]], cfg, device):
    """(loss, metrics) of a step whose ranks each routed their own pool:
    per_layer[i][r] is rank r's aux at layer i; each router loss is the
    mean over layers, then over ranks (the JAX step's pmean), and the
    loss adds them, weighted, to the cross-entropy ``ce``."""
    aux = _mean_aux([_mean_aux([layer[r] for layer in per_layer], device)
                     for r in range(len(per_layer[0]))], device)
    loss = (ce + cfg.moe_balance_weight * aux["balance_loss"]
            + cfg.moe_z_weight * aux["z_loss"])
    return loss, {"ce": ce, **aux}


def make_moe_layer(mesh, cfg: MoeConfig, with_aux: bool = False):
    """``apply(params, x)`` with experts over the ep ranks ``mesh`` (a
    list of devices, one per rank): x [tokens, d] cut over the ranks on
    the token dim, each rank routing its own tokens (capacity
    capacity_factor·n_loc·k/E); params are ``init_moe_params``' (rank r
    reads its E/ep experts).  Returns out [tokens, d] on x's device;
    with ``with_aux``, ``(out, aux)`` with the rank-mean
    ``balance_loss``, ``z_loss`` and ``expert_fraction``."""
    devices = list(mesh)
    ep = len(devices)
    if cfg.num_experts % ep:
        raise ValueError(
            f"{cfg.num_experts} experts not divisible by ep={ep}")
    e_loc = cfg.num_experts // ep

    def apply(params, x):
        n, d = x.shape
        if n % ep:
            raise ValueError(f"{n} tokens not divisible by ep={ep}")
        n_loc = n // ep
        ys = [x[r * n_loc:(r + 1) * n_loc].to(dev)[None]
              for r, dev in enumerate(devices)]
        layers = [{"router": params["router"].to(dev),
                   "w1": [params["w1"][r * e_loc:(r + 1) * e_loc].to(dev)],
                   "w2": [params["w2"][r * e_loc:(r + 1) * e_loc].to(dev)]}
                  for r, dev in enumerate(devices)]
        outs, auxs = _ep_moe_ffn(ys, layers, [[dev] for dev in devices],
                                 top_k=cfg.top_k,
                                 capacity_factor=cfg.capacity_factor)
        out = torch.cat([o[0].to(x.device) for o in outs])
        if not with_aux:
            return out
        return out, _mean_aux(auxs, x.device)

    return apply


def make_ep_mesh(devices=None, ep: int | None = None, tp: int = 1):
    """(data, ep) mesh for expert-parallel training, as a
    ``model.Mesh`` over ``devices`` (default: every visible CUDA card; a
    device may repeat, so ranks share a card): the batch cuts over BOTH
    axes (every rank is data-parallel for the dense ops), and each data
    row is one ep group.  ``tp > 1`` appends a ``model`` axis — (data,
    ep, model) — for the dp×ep×tp composition: the dense attention
    heads Megatron-cut over ``model`` and each expert's d_ff
    column/row-cut over it too."""
    from tpu_autoscaler_torch.workloads.model import Mesh, _device

    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass devices=['cpu'] "
                               "(--platform cpu) to run on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_device(dev) for dev in devices]
    n = len(devices)
    if tp < 1 or tp > n:
        raise ValueError(f"tp={tp} must be in [1, {n}] for {n} devices")
    if ep is None:
        ep = n // tp
    if ep < 1 or n % (ep * tp):
        raise ValueError(
            f"{n} devices not divisible by ep*tp = {ep * tp}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    if tp == 1:
        return Mesh(arr.reshape(n // ep, ep), ("data", "ep"))
    return Mesh(arr.reshape(n // (ep * tp), ep, tp), ("data", "ep", "model"))


def _as_ep_mesh(mesh):
    """``mesh`` as a ``model.Mesh``: a list of rows of devices (the
    grid earlier callers pass) is the (data, ep) mesh of those rows."""
    from tpu_autoscaler_torch.workloads.model import Mesh, _device

    if isinstance(mesh, Mesh):
        return mesh
    rows = [[_device(dev) for dev in row] for row in mesh]
    arr = np.empty((len(rows), len(rows[0])), dtype=object)
    for i, row in enumerate(rows):
        arr[i, :] = row
    return Mesh(arr, ("data", "ep"))


def ep_param_specs(cfg, mesh) -> dict:
    """Partition specs of the ep step's params (the JAX step's
    ``p_specs``): w1 / w2 cut over 'ep' on the expert dim and, under
    ep×tp, over 'model' on d_ff; every dense leaf replicated (each rank
    reads its own copy and cuts it to its model rank's heads)."""
    from tpu_autoscaler_torch.workloads.model import P, param_shapes

    model_axis = "model" if "model" in mesh.axis_names else None
    specs = {name: ({k: P() for k in shape} if isinstance(shape, dict)
                    else P())
             for name, shape in param_shapes(cfg).items()}
    specs["blocks"]["w1"] = P(None, "ep", None, model_axis)
    specs["blocks"]["w2"] = P(None, "ep", model_axis, None)
    return specs


def shard_ep_params(mesh, cfg, tree: dict) -> dict:
    """A one-device params tree at :func:`ep_param_specs` over ``mesh``
    (:func:`make_ep_mesh`): each rank's block on its own device.  ``model.gather_params`` is the inverse (checkpoints)."""
    from tpu_autoscaler_torch.workloads.model import _shard_tree

    return _shard_tree(mesh, cfg, tree, ep_param_specs(cfg, mesh))


def shard_ep_opt_state(mesh, cfg, state: dict) -> dict:
    """A one-device optimizer state cut as its params
    (:func:`shard_ep_params`): the expert moments over ep (and model),
    the dense ones whole; the counts pass through."""
    from tpu_autoscaler_torch.workloads.model import (
        _shard_state,
        _state_specs,
    )

    return _shard_state(mesh, cfg, state, _state_specs(
        state, ep_param_specs(cfg, mesh), mesh, False))


def make_ep_loss(mesh, cfg):
    """``loss_of(params, tokens) -> (loss, metrics)`` for dp×ep MoE
    training over ``mesh`` (:func:`make_ep_mesh`, or the list of rows
    earlier callers pass): the flagship model (cfg.moe_experts set) on
    tokens [b, s + 1] with the batch cut over every (data, ep) row,
    row-major, on the row's first rank, and each ep group's experts
    split over its ranks; on the first rank's device.  loss = the
    global mean cross-entropy plus the weighted router losses; metrics
    holds ``ce``, ``balance_loss``, ``z_loss`` and ``expert_fraction``,
    each the mean over layers, then over rows.

    ``params`` is a tree of ``model.Sharded`` leaves at
    :func:`ep_param_specs` (a one-device tree is cut so first, through
    differentiable copies): each rank reads its own copy of the dense
    params and its own expert blocks; the step sums the replicas'
    gradients (the JAX step's psum).  Under ep×tp each row's attention is
    tensor-parallel over its model ranks (``model._tp_attention``: K1
    forward, K2 backward per (row, model rank) on its h/tp heads on CUDA
    ranks, the einsum elsewhere), the JAX package's ``_ep_tp_block``.
    Routing is pool-level over each row's tokens; with ample
    ``moe_capacity_factor`` nothing drops and the cross-entropy equals
    ``model.loss_and_metrics``'s per-row dispatch."""
    from torch.utils.checkpoint import checkpoint

    from tpu_autoscaler_torch.workloads.attention import (
        make_sharded_flash_attention,
    )
    from tpu_autoscaler_torch.workloads.model import (
        _PRODUCTS,
        ModelConfig,
        Sharded,
        _mesh_attend,
        _replica_cut,
        _rope,
        _shard_tree,
        _tp_attention,
        mesh_rows,
    )
    from tpu_autoscaler_torch.workloads.sp import _local_ce_sum

    assert isinstance(cfg, ModelConfig)
    mesh = _as_ep_mesh(mesh)
    _check_ep(mesh, cfg)
    ep, tp = mesh.shape["ep"], mesh.shape.get("model", 1)
    e_loc = cfg.moe_experts // ep
    rows = mesh_rows(mesh)
    first = rows[0][0]
    specs = ep_param_specs(cfg, mesh)
    attend = _mesh_attend(cfg, rows, make_sharded_flash_attention(
        mesh, causal=True, window=cfg.attention_window))
    rope = (lambda t, i: _rope(t, cfg.rope_theta)) if cfg.rope else None

    def layer_fn(xs, params, layer):
        views: dict = {}

        def w(name, i, j, dev):
            # Row i's model rank j is rank i·tp + j.
            if (name, i, j) not in views:
                t = _replica_cut(cfg, tp, name, params["blocks"][name]
                                 .blocks[i * tp + (j or 0)][layer].to(dev), j)
                views[name, i, j] = (t.to(cfg.dtype) if name in _PRODUCTS
                                     else t)
            return views[name, i, j]

        def experts(i, m):
            return tuple(leaf.blocks[i * tp + m][layer]
                         for leaf in (params["blocks"]["w1"],
                                      params["blocks"]["w2"]))

        xs = _tp_attention(xs, w, rows, cfg, rope, attend)
        return _ep_rows_ffn(xs, w, rows, cfg, ep, experts)

    def loss_of(params, tokens):
        if not isinstance(params["embed"], Sharded):
            params = _shard_tree(mesh, cfg, params, specs)
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        b, s = inputs.shape
        if b % len(rows):
            raise ValueError(f"batch {b} not divisible by the {len(rows)} "
                             "data×ep ranks")
        b_loc = b // len(rows)
        # Each row's first rank's own copies of the top-level leaves.
        tops = [{name: params[name].blocks[i * tp]
                 for name in ("embed", "ln_f", "unembed")}
                for i in range(len(rows))]

        def cut(t, i):
            return t[i * b_loc:(i + 1) * b_loc].to(rows[i][0])

        xs = [tops[i]["embed"].to(cfg.dtype)[cut(inputs, i)]
              for i in range(len(rows))]
        per_layer = []
        for layer in range(cfg.n_layers):
            fn = functools.partial(layer_fn, params=params, layer=layer)
            if cfg.remat:
                xs, auxs = checkpoint(fn, xs, use_reentrant=False)
            else:
                xs, auxs = fn(xs)
            per_layer.append(auxs)
        total = sum(_local_ce_sum(x, tops[i], cut(targets, i),
                                  cfg).to(first)
                    for i, x in enumerate(xs))
        return _ranks_loss(total / (b * s), per_layer, cfg, first)

    return loss_of


def _check_ep(mesh, cfg) -> None:
    """The JAX package's refusals of ``make_ep_train_step``."""
    cfg.require_uniform("make_ep_train_step")
    if cfg.moe_experts is None:
        raise ValueError("make_ep_train_step needs cfg.moe_experts set")
    ep = mesh.shape["ep"]
    if cfg.moe_experts % ep:
        raise ValueError(f"{cfg.moe_experts} experts not divisible by the ep "
                         f"axis ({ep})")
    tp = mesh.shape.get("model", 1)
    if tp > 1:
        if cfg.n_heads % tp or cfg.kv_heads % tp:
            raise ValueError(
                f"ep×tp needs heads divisible by the model axis ({tp}): got "
                f"{cfg.n_heads} q / {cfg.kv_heads} kv heads")
        if cfg.d_ff % tp:
            raise ValueError(f"ep×tp needs d_ff ({cfg.d_ff}) divisible by "
                             f"the model axis ({tp})")


def make_ep_train_step(mesh, cfg, *, train=None,
                       learning_rate: float = 1e-3):
    """(init_fn, step_fn) for dp×ep MoE training over ``mesh``
    (:func:`make_ep_mesh`, or the list of rows earlier callers pass),
    differentiating :func:`make_ep_loss`'s loss; under a (data, ep,
    model) mesh this is dp×ep×tp.

    ``init_fn(generator) -> (params, opt_state)``: the f32 params of
    ``model.init_params`` cut at :func:`ep_param_specs`, and their Adam
    moments cut the same way: each rank stores its E/ep experts' blocks
    (and, under ep×tp, their d_ff/tp cut) and their moments, so its
    expert state drops by ep·tp, while the dense params replicate (a
    copy on every rank).  ``step_fn(params, opt_state, tokens
    [b, s + 1]) -> (params, opt_state, loss, metrics)``: the gradient
    per block, then the trainer's optimizer recipe
    (``model.make_optimizer``) per block.  A step given the one-device
    layout (plain tensors, as a checkpoint holds) cuts it, steps, and
    returns that layout again; ``model.gather_params`` and
    :func:`shard_ep_params` / :func:`shard_ep_opt_state` convert
    between the two."""
    from tpu_autoscaler_torch.workloads.model import (
        Sharded,
        TrainConfig,
        _sharded_step,
        gather_params,
        init_params,
        make_optimizer,
    )

    mesh = _as_ep_mesh(mesh)
    loss_of = make_ep_loss(mesh, cfg)
    optimizer = make_optimizer(train or TrainConfig(
        learning_rate=learning_rate))
    sharded = _sharded_step(optimizer, loss_of, has_aux=True)

    def init_fn(generator: torch.Generator):
        params = init_params(generator, cfg, mesh.ranks[0])
        return (shard_ep_params(mesh, cfg, params),
                shard_ep_opt_state(mesh, cfg, optimizer.init(params)))

    def step_fn(params, opt_state, tokens):
        if isinstance(params["embed"], Sharded):
            return sharded(params, opt_state, tokens)
        params, opt_state, loss, metrics = sharded(
            shard_ep_params(mesh, cfg, params),
            shard_ep_opt_state(mesh, cfg, opt_state), tokens)
        return (gather_params(mesh, params), gather_params(mesh, opt_state),
                loss, metrics)

    return init_fn, step_fn
