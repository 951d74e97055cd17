"""The in-tree decoder-only transformer LM, on PyTorch.

The counterpart of the JAX package's ``workloads/model.py`` without the
mesh: the same ``ModelConfig`` fields, the same stacked parameter layout
(leading dim = layer; packed ``qkv`` of width
``d + 2*kv_heads*head_dim``), and the same block math, so a JAX
parameter tree carries across one to one (``params_from_jax``) and the
tests can hold every function to its JAX twin.  The training half is
the loss (``loss_and_metrics``, with the chunked cross-entropy),
``TrainConfig`` and its hand-written schedules, ``make_optimizer``
(optax's clip + adamw inside ``MultiSteps``, over plain tensors) and
``make_train_step``, the single-device ``make_sharded_train_step``.
With ``moe_experts`` set, every block's MLP is a top-k mixture of
experts (``moe_ffn``, routed by ``moe.route_topk``) and the loss adds
the weighted router losses.

bf16 compute over f32 master parameters, as in the JAX package.  The
numbers follow the JAX code where the two frameworks would otherwise
round differently: the rmsnorm variance is taken in f32, rope angles in
f32 with cos/sin cast to the compute dtype, and gelu is the tanh
approximation (``jax.nn.gelu``'s default).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from tpu_autoscaler_torch.workloads.attention import (
    causal_band_mask,
    flash_attention,
)
from tpu_autoscaler_torch.workloads.moe import (
    combine as moe_combine,
    dispatch as moe_dispatch,
    expert_mlp,
    route_topk,
)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab: int = 256
    d_model: int = 128
    n_layers: int = 2
    n_heads: int = 4
    d_ff: int = 512
    seq_len: int = 64
    # GQA: number of shared KV heads (llama-family layout); None means
    # n_heads (classic MHA), 1 is MQA.
    n_kv_heads: int | None = None
    # Sliding-window attention: each position attends to the most
    # recent ``attention_window`` keys only.  None = full causal.
    attention_window: int | None = None
    dtype: Any = torch.bfloat16
    # "auto" (default): the CUDA attention kernels on a CUDA device
    # (which raises on a shape it does not take), the einsum path on the
    # CPU.  "einsum" always takes the plain path; "kernel" always takes
    # the kernel and is refused on the CPU.
    attention: str = "auto"
    # Flash-attention tile sizes of the JAX training kernel; carried
    # so configs round-trip, unused on the serving path.
    attn_block_q: int = 512
    attn_block_k: int = 1024
    rope: bool = True
    rope_theta: float = 10000.0
    # Training: rematerialize each block in the backward
    # (torch.utils.checkpoint), and the chunked cross-entropy.
    remat: bool = False
    ce_chunk: int | None = None
    # Mixture-of-experts FFN: when set, every block's dense MLP becomes
    # ``moe_experts`` expert MLPs with top-``moe_top_k`` routing
    # (moe.route_topk), dispatched per sequence with capacity
    # moe_capacity_factor * seq * k / E per expert per row; the router's
    # balance and z losses join the loss with the weights below.
    moe_experts: int | None = None
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_balance_weight: float = 0.01
    moe_z_weight: float = 1e-3

    def __post_init__(self) -> None:
        if self.attention not in {"auto", "einsum", "kernel"}:
            raise ValueError(
                f"unknown attention impl {self.attention!r}; "
                "expected 'auto', 'einsum' or 'kernel'")
        if self.attention_window is not None and self.attention_window < 1:
            raise ValueError(f"attention_window must be >= 1, got "
                             f"{self.attention_window}")
        if self.n_kv_heads is not None and self.n_kv_heads < 1:
            raise ValueError(f"n_kv_heads must be >= 1, got "
                             f"{self.n_kv_heads}")
        if self.ce_chunk is not None and self.ce_chunk < 1:
            raise ValueError(f"ce_chunk must be >= 1, got {self.ce_chunk}")
        if self.moe_experts is not None:
            if self.moe_experts < 2:
                raise ValueError(f"moe_experts must be >= 2, got "
                                 f"{self.moe_experts}")
            if not 1 <= self.moe_top_k <= self.moe_experts:
                raise ValueError(
                    f"moe_top_k must be in [1, {self.moe_experts}], got "
                    f"{self.moe_top_k}")
            if self.moe_capacity_factor <= 0:
                raise ValueError(
                    f"moe_capacity_factor must be > 0, got "
                    f"{self.moe_capacity_factor}")
        if self.n_heads % self.kv_heads:
            raise ValueError(
                f"n_heads ({self.n_heads}) must be a multiple of "
                f"n_kv_heads ({self.kv_heads})")
        if self.rope and self.head_dim % 2:
            raise ValueError(
                f"rope requires an even head_dim, got {self.head_dim} "
                f"(d_model {self.d_model} / n_heads {self.n_heads})")

    def resolved_attention(self, device: torch.device) -> str:
        """'kernel' or 'einsum' for tensors on ``device``.  'auto'
        takes the kernel on every CUDA device (any head_dim up to 256;
        a wider one raises there instead of running plain); an
        explicit 'kernel' off CUDA is refused, never run plain."""
        if self.attention == "kernel" and device.type != "cuda":
            raise ValueError(
                f"attention='kernel' needs CUDA tensors, got {device}")
        if self.attention != "auto":
            return self.attention
        return "kernel" if device.type == "cuda" else "einsum"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads if self.n_kv_heads is not None \
            else self.n_heads


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    for something else.  A CUDA request without a GPU raises — the
    port never quietly runs on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--platform cpu) "
            "to run on the CPU")
    return dev


def param_shapes(cfg: ModelConfig) -> dict:
    """The params tree's leaf shapes: what :func:`init_params` makes and
    what a checkpoint for ``cfg`` must hold."""
    L, d, f, E = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.moe_experts
    if E is None:
        ffn = {"w1": (L, d, f), "w2": (L, f, d)}
    else:
        ffn = {"router": (L, d, E), "w1": (L, E, d, f), "w2": (L, E, f, d)}
    return {
        "embed": (cfg.vocab, d),
        "blocks": {
            "qkv": (L, d, d + 2 * cfg.kv_heads * cfg.head_dim),
            "attn_out": (L, d, d),
            **ffn,
            "ln1": (L, d),
            "ln2": (L, d),
        },
        "ln_f": (d,),
        "unembed": (d, cfg.vocab),
    }


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device=None) -> dict:
    """Stacked-layer f32 params (leading dim = layer), drawn from
    ``generator`` on its own device and placed on ``device``: normal
    weights scaled by fan-in (embed and the MoE router 0.02), gains of
    one."""
    shapes = param_shapes(cfg)
    d, f = cfg.d_model, cfg.d_ff
    scale = {"embed": 0.02, "qkv": d ** -0.5, "attn_out": d ** -0.5,
             "router": 0.02, "w1": d ** -0.5, "w2": f ** -0.5,
             "unembed": d ** -0.5}
    dev = resolve_device(device)

    def leaf(name, shape):
        if name not in scale:                  # the norm gains
            return torch.ones(shape, dtype=torch.float32, device=dev)
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (x * scale[name]).to(dev)

    return {name: ({k: leaf(k, v) for k, v in shape.items()}
                   if isinstance(shape, dict) else leaf(name, shape))
            for name, shape in shapes.items()}


def _map_tree(fn, tree, *others):
    """fn over the leaves of ``tree`` (and the same leaves of ``others``,
    trees of the same paths), as a tree of the same paths."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    return fn(tree, *others)


def params_from_jax(tree, device=None) -> dict:
    """The JAX package's params tree (nested dicts of arrays, read
    through numpy) as this port's params on ``device``.  The layouts
    are identical, so this is a copy, not a conversion."""
    dev = resolve_device(device)
    return _map_tree(
        lambda x: torch.from_numpy(np.array(x, copy=True)).to(dev), tree)


def cast_params(params: dict, dtype: torch.dtype, device=None) -> dict:
    """Every leaf in ``dtype`` (on ``device`` when given): the engine's
    one compute-dtype copy.  The MoE router stays f32: :func:`moe_ffn`
    routes in f32 from the f32 master router, as the JAX engines do."""
    out = _map_tree(lambda x: x.to(device=device, dtype=dtype), params)
    if "router" in params.get("blocks", {}):
        out["blocks"]["router"] = params["blocks"]["router"].to(
            device=device, dtype=torch.float32)
    return out


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def save_params(directory: str, step: int, params: dict) -> str:
    """Write ``params`` as ``<directory>/step_<step>/params.npz`` (keys
    are '/'-joined tree paths); the step dir appears atomically, so
    ``checkpoint.latest_step`` never sees a half-written one."""
    from tpu_autoscaler_torch.workloads.checkpoint import write_step

    return write_step(directory, step, {"params": {
        k: v.detach().cpu().numpy() for k, v in _flatten(params)}})


def _unflatten(flat: dict) -> dict:
    """The tree of '/'-joined paths (the inverse of :func:`_flatten`)."""
    out: dict = {}
    for key, value in flat.items():
        node = out
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return out


def load_params(directory: str, step: int, device=None) -> dict:
    """Read what :func:`save_params` wrote, onto ``device``."""
    dev = resolve_device(device)
    path = os.path.join(os.path.abspath(directory), f"step_{step}",
                        "params.npz")
    with np.load(path) as npz:
        return _unflatten({key: torch.from_numpy(npz[key]).to(dev)
                           for key in npz.files})


def _rope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                 dtype: torch.dtype):
    """cos, sin [..., head_dim/2] in ``dtype`` for f32 absolute
    ``positions``; the angles themselves are f32.  A step computes them
    once and rotates q and k of every layer with them."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=positions.device) / half)
    angles = positions[..., None] * freqs
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def _rotate(x: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor) -> torch.Tensor:
    """Rotate the paired halves of head_dim (not interleaved)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _rope(x: torch.Tensor, theta: float, offset=0) -> torch.Tensor:
    """Rotary embedding over [batch, heads, seq, head_dim] at absolute
    positions ``offset .. offset+seq-1`` (``offset`` an int or a 0-d
    tensor on x's device)."""
    s, hd = x.shape[2], x.shape[3]
    positions = offset + torch.arange(s, dtype=torch.float32,
                                      device=x.device)
    return _rotate(x, *_rope_tables(positions, hd, theta, x.dtype))


def _rmsnorm(x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    # f32 variance; x * rsqrt promotes to f32 and is cast back before
    # the gain (in x's dtype) is applied — the JAX package's order.
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6)).to(x.dtype) * gain.to(x.dtype)


def _split_qkv(y: torch.Tensor, layer_qkv: torch.Tensor,
               cfg: ModelConfig):
    """Project [b, s, d] through the packed qkv weight -> q [b, h, s, hd],
    k/v [b, hkv, s, hd] (q | k | v, split at [d, d + hkv*hd])."""
    b, s, d = y.shape
    h, hd, hkv = cfg.n_heads, cfg.head_dim, cfg.kv_heads
    qkv = y @ layer_qkv.to(cfg.dtype)
    q, k, v = torch.split(qkv, [d, hkv * hd, hkv * hd], dim=-1)
    q = q.reshape(b, s, h, hd).transpose(1, 2)
    k = k.reshape(b, s, hkv, hd).transpose(1, 2)
    v = v.reshape(b, s, hkv, hd).transpose(1, 2)
    return q, k, v


def moe_ffn(y: torch.Tensor, layer: dict, cfg: ModelConfig):
    """Top-k MoE FFN over [b, s, d] normed activations.

    Routing is ``moe.route_topk`` on f32 logits of the f32 activations
    and router; dispatch is per sequence: each row routes its s tokens
    into [E, cap, d] buffers (cap = capacity_factor·s·k/E), the experts
    run as one batched product per weight over the expert dim, and the
    combine gathers each token's k outputs gate-weighted.  Rows route
    independently, so a chunk's pad tokens take capacity only in their
    own row.  Returns (out [b, s, d], aux) with the balance and z
    losses averaged over rows."""
    b, s, d = y.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    cap = max(1, int(cfg.moe_capacity_factor * s * k / E))
    logits = y.float() @ layer["router"].float()             # [b, s, E]
    expert, rank, gate, keep, aux = route_topk(logits, k, cap)
    buf = moe_dispatch(y, expert, rank, keep, E, cap)        # [b, E, cap, d]
    out_buf = expert_mlp(buf, layer["w1"].to(cfg.dtype),
                         layer["w2"].to(cfg.dtype))
    out = moe_combine(out_buf, expert, rank, gate, keep)
    return out, {"balance_loss": aux["balance_loss"].mean(),
                 "z_loss": aux["z_loss"].mean()}


def _ffn_residual(x: torch.Tensor, y: torch.Tensor, layer: dict,
                  cfg: ModelConfig) -> torch.Tensor:
    """The FFN half of a block (the dense gelu MLP or :func:`moe_ffn`)
    added onto the residual stream; y is the post-ln2 activations.
    The serving and decode bodies share it with :func:`_block`."""
    if cfg.moe_experts is not None:
        return x + moe_ffn(y, layer, cfg)[0]
    hdn = F.gelu(y @ layer["w1"].to(cfg.dtype), approximate="tanh")
    return x + hdn @ layer["w2"].to(cfg.dtype)


def _attention_residual(x: torch.Tensor, layer: dict,
                        cfg: ModelConfig) -> torch.Tensor:
    """The attention half of a block over x [batch, seq, d_model] in
    compute dtype, added onto the residual stream: the flash_attention
    kernel when the config resolves to it on x's device, else the
    grouped einsum with the band mask."""
    b, s, d = x.shape
    h, hd, hkv = cfg.n_heads, cfg.head_dim, cfg.kv_heads
    y = _rmsnorm(x, layer["ln1"])
    q, k, v = _split_qkv(y, layer["qkv"], cfg)
    if cfg.rope:
        q = _rope(q, cfg.rope_theta)
        k = _rope(k, cfg.rope_theta)
    if cfg.resolved_attention(x.device) == "kernel":
        attn = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=True, window=cfg.attention_window)
    else:
        # Grouped einsum (n = KV head, g = query heads per KV head): GQA
        # without repeating K/V.
        qg = q.reshape(b, hkv, h // hkv, s, hd)
        scores = torch.einsum("bngqd,bnkd->bngqk", qg, k) / math.sqrt(hd)
        mask = causal_band_mask(s, cfg.attention_window, x.device)
        scores = torch.where(mask, scores.float(), -1e30)
        probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
        attn = torch.einsum("bngqk,bnkd->bngqd", probs, v).reshape(
            b, h, s, hd)
    attn = attn.transpose(1, 2).reshape(b, s, d)
    return x + attn @ layer["attn_out"].to(cfg.dtype)


def _block(x: torch.Tensor, layer: dict, cfg: ModelConfig):
    """One transformer block over x [batch, seq, d_model] in compute
    dtype, without the JAX package's mesh branch and ``ffn`` hook.
    Returns ``(x, aux)``; aux holds the MoE router losses, zeros for
    the dense FFN."""
    x = _attention_residual(x, layer, cfg)
    y = _rmsnorm(x, layer["ln2"])
    if cfg.moe_experts is not None:
        out, aux = moe_ffn(y, layer, cfg)
        return x + out, aux
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return _ffn_residual(x, y, layer, cfg), {"balance_loss": zero,
                                             "z_loss": zero}


def features_with_aux(params: dict, tokens: torch.Tensor,
                      cfg: ModelConfig):
    """tokens [batch, seq] int -> (final-norm features [batch, seq,
    d_model] in compute dtype, aux dict of per-layer-mean router
    losses, zeros for the dense FFN).  With ``cfg.remat`` each block
    runs under ``torch.utils.checkpoint`` (non-reentrant): the backward
    recomputes it instead of keeping its activations."""
    x = params["embed"].to(cfg.dtype)[tokens]
    aux = []
    for i in range(cfg.n_layers):
        layer = {name: w[i] for name, w in params["blocks"].items()}
        if cfg.remat:
            x, layer_aux = checkpoint(_block, x, layer, cfg,
                                      use_reentrant=False)
        else:
            x, layer_aux = _block(x, layer, cfg)
        aux.append(layer_aux)
    mean = {name: torch.stack([a[name] for a in aux]).mean()
            for name in aux[0]}
    return _rmsnorm(x, params["ln_f"]), mean


def features(params: dict, tokens: torch.Tensor,
             cfg: ModelConfig) -> torch.Tensor:
    """tokens [batch, seq] int -> final-norm features [batch, seq,
    d_model] in compute dtype (everything before the unembedding)."""
    return features_with_aux(params, tokens, cfg)[0]


def forward(params: dict, tokens: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """tokens [batch, seq] int -> logits [batch, seq, vocab] f32, on
    the tokens' device."""
    x = features(params, tokens, cfg)
    return (x @ params["unembed"].to(cfg.dtype)).float()


def _chunked_ce(x: torch.Tensor, unembed: torch.Tensor,
                targets: torch.Tensor, chunk: int, dtype) -> torch.Tensor:
    """Cross-entropy over sequence chunks of ``chunk`` positions: the
    unembedding and the softmax of one [b, chunk, V] slice at a time,
    summed in f32, over b*s."""
    b, s, _ = x.shape
    w = unembed.to(dtype)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for start in range(0, s, chunk):
        logits = (x[:, start:start + chunk] @ w).float()
        lse = torch.logsumexp(logits, dim=-1)
        tgt = logits.gather(
            -1, targets[:, start:start + chunk, None].long())[..., 0]
        total = total + (lse - tgt).sum()
    return total / (b * s)


def loss_and_metrics(params: dict, tokens: torch.Tensor, cfg: ModelConfig):
    """Training loss and its decomposition: ``(loss, metrics)``, loss =
    next-token cross-entropy of tokens [batch, seq + 1], plus for MoE
    configs the weighted router balance and z losses; metrics holds
    ``ce`` and the unweighted router losses.  With ``cfg.ce_chunk`` set
    and dividing seq the cross-entropy runs chunked
    (:func:`_chunked_ce`); otherwise over the full [b, s, V] logits."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    s = inputs.shape[1]
    x, aux = features_with_aux(params, inputs, cfg)
    if cfg.ce_chunk is not None and s % cfg.ce_chunk == 0:
        ce = _chunked_ce(x, params["unembed"], targets, cfg.ce_chunk,
                         cfg.dtype)
    else:
        logits = (x @ params["unembed"].to(cfg.dtype)).float()
        logp = torch.log_softmax(logits, dim=-1)
        ce = -logp.gather(-1, targets[..., None].long()).mean()
    loss = ce
    if cfg.moe_experts is not None:
        loss = (loss + cfg.moe_balance_weight * aux["balance_loss"]
                + cfg.moe_z_weight * aux["z_loss"])
    return loss, {"ce": ce, **aux}


def loss_fn(params: dict, tokens: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """Next-token cross-entropy of tokens [batch, seq + 1] (+ the
    weighted MoE router losses)."""
    return loss_and_metrics(params, tokens, cfg)[0]


# ---- optimizer ----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer hyperparameters, field for field the JAX package's.

    - ``warmup_steps`` / ``decay_steps``: linear warmup from 0 to
      ``learning_rate`` then, when ``decay_steps`` is set, cosine decay
      to ``learning_rate * min_lr_ratio`` by step ``decay_steps``
      (warmup included).  Both count trainer steps (microbatches), even
      with ``accum_steps > 1``.  Without ``decay_steps`` the LR holds
      after warmup.
    - ``grad_clip``: global-norm gradient clipping before Adam.
    - ``accum_steps``: every k-th step applies the mean of the last k
      microbatch gradients (optax.MultiSteps).
    """

    learning_rate: float = 1e-3
    warmup_steps: int = 0
    decay_steps: int | None = None
    min_lr_ratio: float = 0.1
    weight_decay: float = 1e-4          # optax.adamw's default
    b1: float = 0.9
    b2: float = 0.999
    grad_clip: float | None = None
    accum_steps: int = 1

    def __post_init__(self) -> None:
        if self.warmup_steps < 0:
            raise ValueError(f"warmup_steps must be >= 0, got "
                             f"{self.warmup_steps}")
        if self.decay_steps is not None \
                and self.decay_steps <= self.warmup_steps:
            raise ValueError(
                f"decay_steps ({self.decay_steps}) must exceed "
                f"warmup_steps ({self.warmup_steps})")
        if self.grad_clip is not None and self.grad_clip <= 0:
            raise ValueError(f"grad_clip must be > 0, got {self.grad_clip}")
        if self.accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got "
                             f"{self.accum_steps}")

    def schedule(self):
        """The LR as a function of the step, or the constant peak: optax's
        ``warmup_cosine_decay_schedule`` (init 0) with ``decay_steps``,
        else a linear warmup joined to the constant peak, written out."""
        peak = self.learning_rate
        warmup = self.warmup_steps

        def ramp(step):  # optax.linear_schedule(0, peak, warmup)
            return peak * step / warmup

        if self.decay_steps is not None:
            span = self.decay_steps - warmup
            alpha = self.min_lr_ratio       # optax: end_value / peak_value

            def warmup_cosine(step):
                if step < warmup:
                    return ramp(step)
                t = min(step - warmup, span)
                cosine = 0.5 * (1 + math.cos(math.pi * t / span))
                return peak * ((1 - alpha) * cosine + alpha)

            return warmup_cosine
        if warmup:
            return lambda step: ramp(step) if step < warmup else peak
        return peak

    def lr_at(self, step: int) -> float:
        """Host-side LR readout for logging."""
        sched = self.schedule()
        return float(sched(step)) if callable(sched) else float(sched)


def _tree_zeros(params: dict) -> dict:
    return _map_tree(torch.zeros_like, params)


class Optimizer:
    """``optax.MultiSteps(chain(clip_by_global_norm, adamw(schedule)))``
    of the JAX trainer over trees of plain tensors, with optax's
    arithmetic: Adam's moments ``(1 - b) * g^order + b * m``, bias
    correction ``1 - b ** (count + 1)``, update ``-lr * (m_hat /
    (sqrt(v_hat) + 1e-8) + wd * p)`` with decay on every leaf, the LR
    read at the inner count before it increments; the clip
    ``where(norm < max, g, g / norm * max)`` (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``); the accumulator's running mean
    ``acc + (g - acc) / (n + 1)``, emitted on the k-th microstep with
    zero updates between, the inner count advancing only on emit and the
    schedule read at ``count * accum_steps``.

    The state is a dict: ``count`` (an int: inner updates so far),
    ``mu`` and ``nu`` (trees), and with accumulation ``mini_step``,
    ``gradient_step`` (ints) and ``acc`` (a tree).  Counts are host
    ints, so an update never waits on the device."""

    def __init__(self, train: TrainConfig):
        self.train = train
        self._sched = train.schedule()

    def init(self, params: dict) -> dict:
        state = {"count": 0, "mu": _tree_zeros(params),
                 "nu": _tree_zeros(params)}
        if self.train.accum_steps > 1:
            state.update(mini_step=0, gradient_step=0,
                         acc=_tree_zeros(params))
        return state

    def lr(self, count: int) -> float:
        """The LR of the inner update number ``count`` (from 0)."""
        if not callable(self._sched):
            return self._sched
        return self._sched(count * self.train.accum_steps)

    def _clip(self, grads: dict) -> dict:
        leaves = [g for _, g in _flatten(grads)]
        norm = torch.sqrt(sum(torch.sum(g * g) for g in leaves))
        max_norm = self.train.grad_clip
        keep = norm < max_norm
        return _map_tree(
            lambda g: torch.where(keep, g, g / norm * max_norm), grads)

    def _adamw(self, grads: dict, state: dict, params: dict):
        t = self.train
        count = state["count"] + 1
        mu = _map_tree(lambda g, m: (1 - t.b1) * g + t.b1 * m, grads,
                       state["mu"])
        nu = _map_tree(lambda g, v: (1 - t.b2) * (g * g) + t.b2 * v, grads,
                       state["nu"])
        bc1 = 1 - np.float32(t.b1) ** np.int32(count)
        bc2 = 1 - np.float32(t.b2) ** np.int32(count)
        lr = self.lr(state["count"])

        def step(m, v, p):
            u = (m / float(bc1)) / (torch.sqrt(v / float(bc2)) + 1e-8)
            return (u + t.weight_decay * p) * -lr

        updates = _map_tree(step, mu, nu, params)
        return updates, {"count": count, "mu": mu, "nu": nu}

    def _inner(self, grads: dict, state: dict, params: dict):
        if self.train.grad_clip is not None:
            grads = self._clip(grads)
        return self._adamw(grads, state, params)

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict):
        """(updates, new state) for ``grads`` at ``params``; add the
        updates to the params (:func:`apply_updates`)."""
        k = self.train.accum_steps
        if k == 1:
            return self._inner(grads, state, params)
        n = state["mini_step"]
        acc = _map_tree(lambda g, a: a + (g - a) / (n + 1), grads,
                        state["acc"])
        if n < k - 1:
            return _tree_zeros(grads), {**state, "mini_step": n + 1,
                                        "acc": acc}
        updates, inner = self._inner(acc, state, params)
        return updates, {**inner, "mini_step": 0,
                         "gradient_step": state["gradient_step"] + 1,
                         "acc": _tree_zeros(acc)}


def make_optimizer(train: TrainConfig) -> Optimizer:
    """The trainer's optimizer: [clip ->] adamw(schedule) [-> accum]."""
    return Optimizer(train)


@torch.no_grad()
def apply_updates(params: dict, updates: dict) -> dict:
    """params + updates, leaf by leaf (optax.apply_updates)."""
    return _map_tree(lambda p, u: p + u, params, updates)


def make_train_step(cfg: ModelConfig, train: TrainConfig | None = None,
                    device=None, shard: str = "none"):
    """(init_fn, step_fn) on one device: the single-device counterpart
    of the JAX package's ``make_sharded_train_step``.

    ``init_fn(generator) -> (params, opt_state)``: f32 master params
    drawn from ``generator`` (:func:`init_params`) on ``device``.
    ``step_fn(params, opt_state, tokens) -> (params, opt_state, loss)``:
    tokens [batch, seq + 1] (numpy or a tensor), the gradient of
    :func:`loss_fn` with respect to the f32 master params by
    ``torch.autograd.grad``, then the optimizer's update.  The step
    returns new params and state; the loss is a 0-d device tensor.
    Only ``shard="none"`` is ported: the sharded modes need the mesh
    (ROADMAP.md, Queue 1: the mesh)."""
    if shard != "none":
        raise ValueError(f"shard={shard!r} needs the mesh, which is not "
                         "ported yet (ROADMAP.md, Queue 1: the mesh); "
                         "only 'none'")
    dev = resolve_device(device)
    return _make_step(cfg, make_optimizer(train or TrainConfig()), dev,
                      lambda tree, tokens: loss_fn(tree, tokens, cfg))


def _make_step(cfg: ModelConfig, optimizer: Optimizer, dev: torch.device,
               loss_of, has_aux: bool = False):
    """(init_fn, step_fn) for the f32 master params on ``dev`` and the
    loss ``loss_of(params, tokens)``: the gradient by
    ``torch.autograd.grad`` with respect to the master params, then the
    optimizer's update (shared by the single-device, sequence-parallel
    and expert-parallel steps).  ``has_aux``: ``loss_of`` returns
    ``(loss, metrics)`` and step_fn ``(params, opt_state, loss,
    metrics)``, the metrics detached."""

    def init_fn(generator: torch.Generator):
        params = init_params(generator, cfg, dev)
        return params, optimizer.init(params)

    def step_fn(params: dict, opt_state: dict, tokens):
        tokens = torch.as_tensor(tokens, device=dev)
        paths, leaves = zip(*_flatten(params))
        leaves = [p.detach().requires_grad_() for p in leaves]
        loss = loss_of(_unflatten(dict(zip(paths, leaves))), tokens)
        if has_aux:
            loss, metrics = loss
        grads = torch.autograd.grad(loss, leaves)
        grads = _unflatten(dict(zip(paths, grads)))
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        if has_aux:
            return params, opt_state, loss.detach(), {
                name: m.detach() for name, m in metrics.items()}
        return params, opt_state, loss.detach()

    return init_fn, step_fn
