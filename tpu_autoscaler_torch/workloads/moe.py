"""Mixture-of-experts FFN and expert parallelism (ep), on PyTorch.

The counterpart of the JAX package's ``workloads/moe.py`` at tp = 1.
The routing rule (``route_topk``) is the one every MoE path of the port
shares: the flagship model's per-row dispatch (``model.moe_ffn``), the
expert-parallel step (``_ep_moe_ffn``, ``make_ep_train_step``) and
sp×ep (``sp.py``).  Tokens over an expert's capacity are dropped (they
contribute zero; the residual carries them), switch-transformer style.

The JAX package shards experts over a mesh axis and moves tokens with
two ``lax.all_to_all`` exchanges.  Here one process holds the ranks as
a grid of devices (``make_ep_mesh``: rows are data replicas, columns
the ep group), and ranks may share a card, as ``sp.make_sp_mesh``'s
do.  The exchange is a transpose of a per-rank list: rank t receives
bucket t of every rank of its row, a ``.to()`` copy between cards and
none on one card.  A ``model`` axis beside ep (ep×tp) waits for
ROADMAP.md, Queue 1: EP and the SP compositions.

The layer computes the two auxiliary router losses a trainable MoE
needs: the load-balance loss ``E * Σ_e f_e · p_e`` (f_e the share of
assignments to expert e, p_e its mean router probability) and the
router z-loss ``mean(logsumexp(logits)²)``.
"""

from __future__ import annotations

import dataclasses

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
    and layers[r] (router [d, E] and this rank's experts, w1 [E/ep, d,
    f], w2 [E/ep, f, d]) on ``devices[r]``; ``dtype``, when given, is
    the compute dtype the router and expert weights are cast to.  Each
    rank routes its LOCAL pool (capacity = capacity_factor·n_loc·k/E,
    pool-level GShard semantics, against ``model.moe_ffn``'s per-row
    dispatch), the router product in the compute dtype then cast to
    f32; the buckets go to their experts' ranks, each rank runs its
    experts' MLPs, and the outputs come back for the gate-weighted
    combine.  Returns (outs [b_loc, s, d] per rank, aux per rank).

    The balance loss is nonlinear in (f, p), so the pool estimate
    differs from the per-row one by the rows' covariance (zero for a
    one-row pool); both are the JAX package's."""
    ep, k = len(ys), top_k
    if dtype is not None:
        layers = [{name: layer[name].to(dtype)
                   for name in ("router", "w1", "w2")} for layer in layers]
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
    received = _exchange(buckets, devices)          # [ep(src), e_loc, cap, d]
    expert_out = [expert_mlp(buf, layer["w1"], layer["w2"])
                  for buf, layer in zip(received, layers)]
    returned = _exchange(expert_out, devices)       # [ep(owner), e_loc, ...]
    outs, auxs = [], []
    for y, ret, (expert, rank, gate, keep, aux) in zip(ys, returned, routes):
        combined = ret.reshape(1, e, *ret.shape[2:])
        outs.append(combine(combined, expert, rank, gate, keep)
                    .reshape(y.shape))
        auxs.append({name: v[0] for name, v in aux.items()})
    return outs, auxs


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
                   "w1": params["w1"][r * e_loc:(r + 1) * e_loc].to(dev),
                   "w2": params["w2"][r * e_loc:(r + 1) * e_loc].to(dev)}
                  for r, dev in enumerate(devices)]
        outs, auxs = _ep_moe_ffn(ys, layers, devices, top_k=cfg.top_k,
                                 capacity_factor=cfg.capacity_factor)
        out = torch.cat([o[0].to(x.device) for o in outs])
        if not with_aux:
            return out
        return out, _mean_aux(auxs, x.device)

    return apply


def make_ep_mesh(devices=None, ep: int | None = None,
                 tp: int = 1) -> list[list[torch.device]]:
    """The (data, ep) grid of ranks for expert-parallel training: the
    devices (default: every visible CUDA card) in rows of ``ep``; a
    device may appear more than once, so ranks share a card.  The batch
    cuts over every rank; each row is one ep group.  ``tp > 1`` (the
    JAX mesh's ``model`` axis, ep×tp) waits for ROADMAP.md, Queue 1: EP
    and the SP compositions."""
    from tpu_autoscaler_torch.workloads.sp import _device

    if tp != 1:
        raise ValueError(f"ep×tp (tp={tp}) is not ported yet (ROADMAP.md, "
                         "Queue 1: EP and the SP compositions)")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass devices=['cpu'] "
                               "(--platform cpu) to run on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_device(dev) for dev in devices]
    n = len(devices)
    if ep is None:
        ep = n
    if ep < 1 or n % ep:
        raise ValueError(f"{n} devices not divisible by ep*tp = {ep}")
    return [devices[i:i + ep] for i in range(0, n, ep)]


def make_ep_loss(mesh, cfg):
    """``loss_of(params, tokens) -> (loss, metrics)`` for dp×ep MoE
    training over ``mesh`` (:func:`make_ep_mesh`'s grid): the flagship
    model (cfg.moe_experts set) on tokens [b, s + 1] with the batch cut
    over every rank, row-major, and each ep group's experts split over
    its ranks; on the first rank's device.  loss = the global mean
    cross-entropy plus the weighted router losses; metrics holds ``ce``,
    ``balance_loss``, ``z_loss`` and ``expert_fraction``, each the mean
    over layers, then over ranks.  ``params`` is the one f32 master
    copy: rank r reads the dense params and its ep column's experts
    through ``.to(devices[r])``, so autograd sums the replicated params'
    gradients (the JAX step's psum).  Routing is pool-level over each
    rank's tokens; with ample ``moe_capacity_factor`` nothing drops and
    the cross-entropy equals ``model.loss_and_metrics``'s per-row
    dispatch."""
    from torch.utils.checkpoint import checkpoint

    from tpu_autoscaler_torch.workloads.model import (
        ModelConfig,
        _attention_residual,
        _map_tree,
        _rmsnorm,
    )
    from tpu_autoscaler_torch.workloads.sp import _device, _local_ce_sum

    assert isinstance(cfg, ModelConfig)
    if cfg.moe_experts is None:
        raise ValueError("make_ep_train_step needs cfg.moe_experts set")
    grid = [[_device(dev) for dev in row] for row in mesh]
    ep = len(grid[0])
    if cfg.moe_experts % ep:
        raise ValueError(f"{cfg.moe_experts} experts not divisible by the ep "
                         f"axis ({ep})")
    e_loc = cfg.moe_experts // ep
    ranks = [dev for row in grid for dev in row]
    distinct = list(dict.fromkeys(ranks))

    def layer_fn(xs, layers):
        xs = [_attention_residual(x, layer, cfg)
              for x, layer in zip(xs, layers)]
        out, auxs = [], []
        for row in range(len(grid)):
            cut = slice(row * ep, (row + 1) * ep)
            ys = [_rmsnorm(x, layer["ln2"])
                  for x, layer in zip(xs[cut], layers[cut])]
            o, a = _ep_moe_ffn(ys, layers[cut], grid[row],
                               top_k=cfg.moe_top_k,
                               capacity_factor=cfg.moe_capacity_factor,
                               dtype=cfg.dtype)
            out += [x + oo for x, oo in zip(xs[cut], o)]
            auxs += a
        return out, auxs

    def loss_of(params, tokens):
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        b, s = inputs.shape
        if b % len(ranks):
            raise ValueError(f"batch {b} not divisible by the {len(ranks)} "
                             "data×ep ranks")
        b_loc = b // len(ranks)
        on = {dev: _map_tree(lambda w, dev=dev: w.to(dev), params)
              for dev in distinct}
        shard = [on[dev] for dev in ranks]

        def cut(t, r):
            return t[r * b_loc:(r + 1) * b_loc].to(ranks[r])

        xs = [p["embed"].to(cfg.dtype)[cut(inputs, r)]
              for r, p in enumerate(shard)]
        per_layer = []
        for i in range(cfg.n_layers):
            layers = []
            for r, p in enumerate(shard):
                j = r % ep
                layer = {name: w[i] for name, w in p["blocks"].items()}
                for name in ("w1", "w2"):
                    layer[name] = layer[name][j * e_loc:(j + 1) * e_loc]
                layers.append(layer)
            if cfg.remat:
                xs, auxs = checkpoint(layer_fn, xs, layers,
                                      use_reentrant=False)
            else:
                xs, auxs = layer_fn(xs, layers)
            per_layer.append(auxs)
        total = sum(_local_ce_sum(x, p, cut(targets, r), cfg).to(ranks[0])
                    for r, (x, p) in enumerate(zip(xs, shard)))
        return _ranks_loss(total / (b * s), per_layer, cfg, ranks[0])

    return loss_of


def make_ep_train_step(mesh, cfg, *, train=None,
                       learning_rate: float = 1e-3):
    """(init_fn, step_fn) for dp×ep MoE training over ``mesh``
    (:func:`make_ep_mesh`'s grid), differentiating
    :func:`make_ep_loss`'s loss.

    ``init_fn(generator) -> (params, opt_state)``: the f32 master params
    (``model.init_params``) on the first rank's device.
    ``step_fn(params, opt_state, tokens [b, s + 1]) -> (params,
    opt_state, loss, metrics)``, then the trainer's optimizer recipe
    (``model.make_optimizer``).  The JAX step shards the expert weights
    and their Adam moments over ep; here both stay whole on the first
    rank's device (ROADMAP.md, Queue 1: EP and the SP compositions)."""
    from tpu_autoscaler_torch.workloads.model import (
        TrainConfig,
        _make_step,
        make_optimizer,
    )
    from tpu_autoscaler_torch.workloads.sp import _device

    loss_of = make_ep_loss(mesh, cfg)
    optimizer = make_optimizer(train or TrainConfig(
        learning_rate=learning_rate))
    return _make_step(cfg, optimizer, _device(mesh[0][0]), loss_of,
                      has_aux=True)
