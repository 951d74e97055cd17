"""The in-tree decoder-only transformer LM, on PyTorch.

The counterpart of the JAX package's ``workloads/model.py``: the same
``ModelConfig`` fields, the same stacked parameter layout (leading dim =
layer; packed ``qkv`` of width ``d + 2*kv_heads*head_dim``), and the
same block math, so a JAX parameter tree carries across one to one
(``params_from_jax``) and the tests can hold every function to its JAX
twin.  The training half is the loss (``loss_and_metrics``, with the
chunked cross-entropy), ``TrainConfig`` and its hand-written schedules,
``make_optimizer`` (optax's clip + adamw inside ``MultiSteps``, over
plain tensors), ``make_train_step`` on one device and
``make_sharded_train_step`` over a (data, model) mesh (``make_mesh``):
Megatron tensor parallelism over ``model``, the batch over the data
axes, and the state replicated, its AdamW moments cut over data
(ZeRO-1) or everything cut over data (FSDP).  With ``moe_experts`` set,
every block's MLP is a top-k mixture of experts (``moe_ffn``, routed by
``moe.route_topk``) and the loss adds the weighted router losses.

bf16 compute over f32 master parameters, as in the JAX package.  The
numbers follow the JAX code where the two frameworks would otherwise
round differently: the rmsnorm variance is taken in f32, rope angles in
f32 with cos/sin cast to the compute dtype, and gelu is the tanh
approximation (``jax.nn.gelu``'s default).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import logging
import math
import os
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from tpu_autoscaler_torch.obs.trace import maybe_span
from tpu_autoscaler_torch.workloads.attention import (
    causal_band_mask,
    flash_attention,
    make_sharded_flash_attention,
)
from tpu_autoscaler_torch.workloads.distributed import process_mean
from tpu_autoscaler_torch.workloads.moe import (
    _ranks_loss,
    combine as moe_combine,
    dispatch as moe_dispatch,
    dropless_ffn,
    expert_mlp,
    route_topk,
)

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Yarn:
    """YaRN's rescaled rotary frequencies (arXiv:2309.00071), with the
    keys a published config's ``rope_parameters`` give them
    (``rope_type: "yarn"``), computed as Hugging Face's
    ``_compute_yarn_parameters`` does: :func:`rope_frequencies`."""
    factor: float
    original_max_position_embeddings: int
    # cos and sin are scaled by it.
    attention_factor: float
    beta_fast: float = 32.0
    beta_slow: float = 1.0


@dataclasses.dataclass(frozen=True)
class LayerKind:
    """One kind of attention layer: its window (None = full causal) and
    its rotary table (``theta``, and YaRN's rescaling when set)."""
    window: int | None = None
    rope_theta: float = 10000.0
    yarn: Yarn | None = None


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
    # Width of one attention head; None: d_model // n_heads.  Set, the
    # query width n_heads * head_dim may differ from d_model.
    head_size: int | None = None
    # Attention kind of each layer (window and rope), one entry per
    # layer, in place of attention_window and rope_theta; None: every
    # layer is attention_window / rope_theta with default RoPE.  Only
    # the one-device paged engine and the plain forward run layer kinds
    # (:meth:`require_uniform`).
    layer_kinds: tuple[LayerKind, ...] | None = None
    # Training: rematerialize each block in the backward
    # (torch.utils.checkpoint), and the chunked cross-entropy.
    remat: bool = False
    ce_chunk: int | None = None
    # Mixture-of-experts FFN: when set, every block's dense MLP becomes
    # ``moe_experts`` expert MLPs with top-``moe_top_k`` routing
    # (moe.route_topk), dispatched per sequence with capacity
    # moe_capacity_factor * seq * k / E per expert per row; the router's
    # balance and z losses join the loss with the weights below.
    # The capacity route's experts are gelu MLPs (w1 [E, d, d_ff]).
    # ``moe_capacity_factor=None`` is the dropless route instead
    # (moe.dropless_ffn: every token to its k experts, its k gates
    # renormalised, grouped products over the tokens sorted by expert),
    # whose experts are SwiGLU (w1 [E, d, 2*d_ff], gate | up), as the
    # published models that route so have them.
    moe_experts: int | None = None
    moe_top_k: int = 2
    moe_capacity_factor: float | None = 1.25
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
            if self.moe_capacity_factor is not None \
                    and self.moe_capacity_factor <= 0:
                raise ValueError(
                    f"moe_capacity_factor must be > 0, got "
                    f"{self.moe_capacity_factor}")
        if self.head_size is not None and self.head_size < 1:
            raise ValueError(f"head_size must be >= 1, got {self.head_size}")
        if self.layer_kinds is not None:
            if len(self.layer_kinds) != self.n_layers:
                raise ValueError(
                    f"layer_kinds has {len(self.layer_kinds)} entries for "
                    f"{self.n_layers} layers")
            if any(k.window is not None and k.window < 1
                   for k in self.layer_kinds):
                raise ValueError("every layer kind's window must be >= 1")
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

    def mesh_shardable(self, mesh: "Mesh") -> bool:
        """Whether attention can be cut by heads under ``mesh``: every
        model rank must hold whole KV-head groups, so both n_heads and
        kv_heads must divide by the 'model' axis size (which also keeps
        each rank's query heads aligned to its own KV heads).  When they
        do not, the step gathers qkv per data row and attends over whole
        heads instead (:func:`_mesh_layer`)."""
        return heads_split(self, mesh.shape.get("model", 1))

    def resolved_for_mesh(self, mesh: "Mesh") -> "ModelConfig":
        """The config a mesh-sharded step should build: 'auto' resolved
        on the mesh's ranks (:meth:`resolved_attention`: the kernel on
        CUDA, the einsum off it).  Unlike the JAX package, whose
        shard_map needs heads that divide, the kernel runs under any
        mesh: on head shards when :meth:`mesh_shardable` holds, else on
        each data row's whole heads."""
        return dataclasses.replace(
            self, attention=self.resolved_attention(mesh.first))

    @property
    def head_dim(self) -> int:
        return self.head_size if self.head_size is not None \
            else self.d_model // self.n_heads

    @property
    def q_width(self) -> int:
        """Columns of the query projection: n_heads * head_dim."""
        return self.n_heads * self.head_dim

    @property
    def moe_dropless(self) -> bool:
        """Experts on the dropless route, SwiGLU (see the fields)."""
        return self.moe_experts is not None \
            and self.moe_capacity_factor is None

    def require_uniform(self, what: str) -> None:
        """Refuse, for the paths ``what`` names (the meshes, the slot
        engines, the train steps), a block only the one-device paged
        engine and the plain forward run: layer kinds, a query width
        other than d_model, dropless SwiGLU experts."""
        if self.layer_kinds is not None or self.q_width != self.d_model \
                or self.moe_dropless:
            raise ValueError(
                f"{what} runs the in-tree block only (one layer kind, "
                "query width d_model, capacity-routed gelu experts)")

    @classmethod
    def from_published(cls, config: dict, **fields) -> "ModelConfig":
        """The config of a published model's ``config.json`` keys
        (Hugging Face names), with ``fields`` (``seq_len``, ``dtype``,
        ...) on top.  Reads the mixture-of-experts and layer-kind keys of
        Mellum-style configs: ``layer_types`` with per-kind
        ``rope_parameters`` (default or YaRN RoPE), ``sliding_window``,
        ``head_dim``, SwiGLU (``silu``) experts with renormalised gates
        (``norm_topk_prob``), routed dropless as the published model
        routes.  Refuses a key it does not model, and a value the
        program does not run."""
        return _from_published(cls, config, fields)

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads if self.n_kv_heads is not None \
            else self.n_heads


#: Published keys that describe no part of the forward pass the program
#: runs (ids, the context a model was trained to, the dtype it ships
#: in, how it was initialised).
_PUBLISHED_NOTES = frozenset({
    "architectures", "model_type", "torch_dtype", "dtype", "bos_token_id",
    "eos_token_id", "pad_token_id", "max_position_embeddings",
    "initializer_range", "use_cache", "attention_dropout",
    "transformers_version"})


def _published_kind(kind: str, config: dict) -> LayerKind:
    """The LayerKind of a ``layer_types`` entry: its window and its
    ``rope_parameters`` section (default or YaRN rotary)."""
    if kind not in ("full_attention", "sliding_attention"):
        raise ValueError(f"layer type {kind!r} is not modelled")
    rope = config["rope_parameters"][kind]
    known = {"rope_type", "rope_theta", "factor", "beta_fast", "beta_slow",
             "original_max_position_embeddings", "attention_factor"}
    if set(rope) - known:
        raise ValueError(f"rope keys {sorted(set(rope) - known)} of {kind} "
                         "are not modelled")
    yarn = None
    if rope.get("rope_type", "default") == "yarn":
        yarn = Yarn(factor=float(rope["factor"]),
                    original_max_position_embeddings=int(
                        rope["original_max_position_embeddings"]),
                    attention_factor=float(rope["attention_factor"]),
                    beta_fast=float(rope.get("beta_fast", 32.0)),
                    beta_slow=float(rope.get("beta_slow", 1.0)))
    elif rope.get("rope_type", "default") != "default":
        raise ValueError(f"rope_type {rope['rope_type']!r} is not modelled")
    window = None
    if kind == "sliding_attention":
        window = int(config["sliding_window"])
    return LayerKind(window=window, rope_theta=float(rope["rope_theta"]),
                     yarn=yarn)


def _from_published(cls, config: dict, fields: dict) -> ModelConfig:
    """:meth:`ModelConfig.from_published`."""
    modelled = {
        "vocab_size", "hidden_size", "num_hidden_layers",
        "num_attention_heads", "num_key_value_heads", "head_dim",
        "hidden_act", "rms_norm_eps", "layer_types", "rope_parameters",
        "sliding_window", "use_sliding_window", "max_window_layers",
        "mlp_layer_types", "num_experts", "num_experts_per_tok",
        "norm_topk_prob", "moe_intermediate_size", "intermediate_size",
        "attention_bias", "tie_word_embeddings"}
    unknown = set(config) - modelled - _PUBLISHED_NOTES
    if unknown:
        raise ValueError(f"published keys not modelled: {sorted(unknown)}")
    refusals = [
        (config.get("rms_norm_eps", 1e-6) != 1e-6,
         "the program's RMSNorm eps is 1e-6"),
        (config.get("attention_bias", False), "the program has no biases"),
        (config.get("tie_word_embeddings", False),
         "the program keeps an unembedding of its own"),
        (config.get("max_window_layers", 0) != 0
         or not config.get("use_sliding_window", True),
         "windows come from layer_types alone"),
        (config.get("hidden_act") != "silu" or "num_experts" not in config,
         "the program's published-config path runs SwiGLU (silu) experts"),
        (any(t != "sparse" for t in config.get("mlp_layer_types", [])),
         "every layer's MLP must be sparse"),
        (not config.get("norm_topk_prob", True),
         "the dropless route renormalises the top-k gates")]
    for refused, why in refusals:
        if refused:
            raise ValueError(f"published config refused: {why}")
    n_layers = int(config["num_hidden_layers"])
    kinds = tuple(_published_kind(t, config) for t in config.get(
        "layer_types", ["full_attention"] * n_layers))
    # Experts routed dropless: the published model drops no token.  The
    # dense intermediate_size is unused when every layer is sparse.
    return cls(vocab=int(config["vocab_size"]),
               d_model=int(config["hidden_size"]), n_layers=n_layers,
               n_heads=int(config["num_attention_heads"]),
               n_kv_heads=int(config["num_key_value_heads"]),
               head_size=config.get("head_dim"),
               d_ff=int(config["moe_intermediate_size"]), layer_kinds=kinds,
               moe_experts=int(config["num_experts"]),
               moe_top_k=int(config["num_experts_per_tok"]),
               moe_capacity_factor=None, **fields)


def layer_kinds(cfg: ModelConfig) -> tuple[list[tuple], list[int]]:
    """The distinct attention kinds of ``cfg``'s layers, in order of
    first use, each as (the config of a model of that kind alone: its
    ``attention_window`` and ``rope_theta``; its :class:`Yarn` or None),
    and each layer's index into them.  A config without ``layer_kinds``
    is its own one kind, with default RoPE, so a step over it builds
    what it always built."""
    if cfg.layer_kinds is None:
        return [(cfg, None)], [0] * cfg.n_layers
    distinct = list(dict.fromkeys(cfg.layer_kinds))
    kinds = [(dataclasses.replace(cfg, layer_kinds=None,
                                  attention_window=k.window,
                                  rope_theta=k.rope_theta), k.yarn)
             for k in distinct]
    return kinds, [distinct.index(k) for k in cfg.layer_kinds]


def yarn_range(head_dim: int, theta: float, yarn: Yarn) -> tuple:
    """YaRN's (low, high) dims of the ramp between the rescaled and the
    original frequencies: where a dim turns ``beta_fast`` and
    ``beta_slow`` times over the original context, floored and ceiled,
    clamped to [0, head_dim - 1]."""
    def dim(rotations):
        return head_dim * math.log(
            yarn.original_max_position_embeddings
            / (rotations * 2 * math.pi)) / (2 * math.log(theta))

    return (max(math.floor(dim(yarn.beta_fast)), 0),
            min(math.ceil(dim(yarn.beta_slow)), head_dim - 1))


def rope_frequencies(head_dim: int, theta: float, yarn: Yarn | None,
                     device) -> torch.Tensor:
    """f32 inverse frequencies [head_dim / 2]: theta ** (-i / half),
    and under YaRN the ramp from them (dims below ``low``) to them over
    ``factor`` (dims above ``high``)."""
    half = head_dim // 2
    base = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=device) / half)
    if yarn is None:
        return base
    low, high = yarn_range(head_dim, theta, yarn)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(half, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    extrap = 1 - ramp
    return base / yarn.factor * (1 - extrap) + base * extrap


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


def _device(dev) -> torch.device:
    """``dev`` as a torch.device with its index (a bare "cuda" is the
    current card), so ranks on one card compare equal."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def param_shapes(cfg: ModelConfig) -> dict:
    """The params tree's leaf shapes: what :func:`init_params` makes and
    what a checkpoint for ``cfg`` must hold."""
    L, d, f, E = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.moe_experts
    if E is None:
        ffn = {"w1": (L, d, f), "w2": (L, f, d)}
    else:
        f1 = 2 * f if cfg.moe_dropless else f
        ffn = {"router": (L, d, E), "w1": (L, E, d, f1), "w2": (L, E, f, d)}
    return {
        "embed": (cfg.vocab, d),
        "blocks": {
            "qkv": (L, d, cfg.q_width + 2 * cfg.kv_heads * cfg.head_dim),
            "attn_out": (L, cfg.q_width, d),
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
    scale = {"embed": 0.02, "qkv": d ** -0.5, "attn_out": cfg.q_width ** -0.5,
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
                 dtype: torch.dtype, yarn: Yarn | None = None):
    """cos, sin [..., head_dim/2] in ``dtype`` for f32 absolute
    ``positions``; the angles themselves are f32.  A step computes them
    once (once a layer kind) and rotates q and k of every layer with
    them.  Under ``yarn`` the frequencies are YaRN's and cos and sin
    are scaled by its attention factor."""
    angles = positions[..., None] * rope_frequencies(
        head_dim, theta, yarn, positions.device)
    cos, sin = torch.cos(angles), torch.sin(angles)
    if yarn is not None:
        cos, sin = cos * yarn.attention_factor, sin * yarn.attention_factor
    return cos.to(dtype), sin.to(dtype)


def _rotate(x: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor) -> torch.Tensor:
    """Rotate the paired halves of head_dim (not interleaved)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _rope(x: torch.Tensor, theta: float, offset=0,
          yarn: Yarn | None = None) -> torch.Tensor:
    """Rotary embedding over [batch, heads, seq, head_dim] at absolute
    positions ``offset .. offset+seq-1`` (``offset`` an int or a 0-d
    tensor on x's device)."""
    s, hd = x.shape[2], x.shape[3]
    positions = offset + torch.arange(s, dtype=torch.float32,
                                      device=x.device)
    return _rotate(x, *_rope_tables(positions, hd, theta, x.dtype, yarn))


def _rmsnorm(x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    # f32 variance; x * rsqrt promotes to f32 and is cast back before
    # the gain (in x's dtype) is applied — the JAX package's order.
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6)).to(x.dtype) * gain.to(x.dtype)


def _split_qkv(y: torch.Tensor, layer_qkv: torch.Tensor,
               cfg: ModelConfig, heads: tuple[int, int] | None = None):
    """Project [b, s, d] through the packed qkv weight -> q [b, h, s, hd],
    k/v [b, hkv, s, hd] (q | k | v, split at [h*hd, (h + hkv)*hd]).
    ``heads``: (h, hkv) of a tensor-parallel rank's head-aligned columns
    (:func:`_qkv_order`); default the config's."""
    b, s, _ = y.shape
    h, hkv = heads or (cfg.n_heads, cfg.kv_heads)
    hd = cfg.head_dim
    qkv = y @ layer_qkv.to(cfg.dtype)
    q, k, v = torch.split(qkv, [h * hd, hkv * hd, hkv * hd], dim=-1)
    q = q.reshape(b, s, h, hd).transpose(1, 2)
    k = k.reshape(b, s, hkv, hd).transpose(1, 2)
    v = v.reshape(b, s, hkv, hd).transpose(1, 2)
    return q, k, v


def moe_ffn(y: torch.Tensor, layer: dict, cfg: ModelConfig, experts=None,
            *, valid=None, counter=None, aux: bool = True):
    """Top-k MoE FFN over [b, s, d] normed activations, by one of two
    routes.

    Dropless (``cfg.moe_capacity_factor`` None, :func:`moe.dropless_ffn`):
    every token goes to its k experts, none dropped; the (token, choice)
    pairs are sorted by expert on the device and each weight runs as one
    grouped product over them.  ``valid`` [b, s] bool (the prefill's
    real tokens) keeps the other rows out of the routing, their output
    zero; ``counter`` (a traced engine's
    :class:`~tpu_autoscaler_torch.obs.trace.DeviceCounter`) keeps each
    call's group ends over the experts.  With ``aux``
    False the router losses are not computed (serving): zeros.

    Capacity (the JAX package's): routing is ``moe.route_topk`` on f32
    logits of the f32 activations and router; dispatch is per sequence:
    each row routes its s tokens
    into [E, cap, d] buffers (cap = capacity_factor·s·k/E), the experts
    run as one batched product per weight over the expert dim, and the
    combine gathers each token's k outputs gate-weighted.  Rows route
    independently, so a chunk's pad tokens take capacity only in their
    own row.  Returns (out [b, s, d], aux) with the balance and z
    losses averaged over rows.  ``experts(buf) -> out_buf``, when given,
    replaces the expert MLPs over the [b, E, cap, d] buffers (the
    tensor-parallel step sums them over the model ranks); ``layer`` then
    needs only the router."""
    if cfg.moe_dropless:
        return dropless_ffn(y, layer, cfg, valid=valid, counter=counter,
                            aux=aux)
    b, s, d = y.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    cap = max(1, int(cfg.moe_capacity_factor * s * k / E))
    logits = y.float() @ layer["router"].float()             # [b, s, E]
    expert, rank, gate, keep, aux = route_topk(logits, k, cap)
    buf = moe_dispatch(y, expert, rank, keep, E, cap)        # [b, E, cap, d]
    if experts is not None:
        out_buf = experts(buf)
    else:
        out_buf = expert_mlp(buf, layer["w1"].to(cfg.dtype),
                             layer["w2"].to(cfg.dtype))
    out = moe_combine(out_buf, expert, rank, gate, keep)
    return out, {"balance_loss": aux["balance_loss"].mean(),
                 "z_loss": aux["z_loss"].mean()}


def _ffn_residual(x: torch.Tensor, y: torch.Tensor, layer: dict,
                  cfg: ModelConfig, valid=None, counter=None) -> torch.Tensor:
    """The FFN half of a block (the dense gelu MLP or :func:`moe_ffn`)
    added onto the residual stream; y is the post-ln2 activations.
    The serving and decode bodies share it with :func:`_block`;
    ``valid`` and ``counter`` are :func:`moe_ffn`'s (the dropless
    route's)."""
    if cfg.moe_experts is not None:
        return x + moe_ffn(y, layer, cfg, valid=valid, counter=counter,
                           aux=False)[0]
    hdn = F.gelu(y @ layer["w1"].to(cfg.dtype), approximate="tanh")
    return x + hdn @ layer["w2"].to(cfg.dtype)


def _einsum_attention(q, k, v, cfg: ModelConfig) -> torch.Tensor:
    """The grouped einsum (n = KV head, g = query heads per KV head):
    GQA without repeating K/V, masked by the causal band, the softmax in
    f32 -> [b, h, s, hd] in the compute dtype."""
    b, h, s, hd = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, h // hkv, s, hd)
    scores = torch.einsum("bngqd,bnkd->bngqk", qg, k) / math.sqrt(hd)
    mask = causal_band_mask(s, cfg.attention_window, q.device)
    scores = torch.where(mask, scores.float(), -1e30)
    probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
    return torch.einsum("bngqk,bnkd->bngqd", probs, v).reshape(b, h, s, hd)


def _attend(q, k, v, cfg: ModelConfig, kernel: bool) -> torch.Tensor:
    """Causal (windowed) attention of rotated q [b, h, s, hd] over k/v
    [b, hkv, s, hd]: the flash_attention kernel or the grouped einsum."""
    if kernel:
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=True, window=cfg.attention_window)
    return _einsum_attention(q, k, v, cfg)


def _attention_residual(x: torch.Tensor, layer: dict, cfg: ModelConfig,
                        yarn: Yarn | None = None) -> torch.Tensor:
    """The attention half of a block over x [batch, seq, d_model] in
    compute dtype, added onto the residual stream: the flash_attention
    kernel when the config resolves to it on x's device, else the
    grouped einsum with the band mask.  ``yarn``: the layer kind's
    YaRN rotary (:func:`layer_kinds`)."""
    b, s, d = x.shape
    y = _rmsnorm(x, layer["ln1"])
    q, k, v = _split_qkv(y, layer["qkv"], cfg)
    if cfg.rope:
        q = _rope(q, cfg.rope_theta, yarn=yarn)
        k = _rope(k, cfg.rope_theta, yarn=yarn)
    kernel = cfg.resolved_attention(x.device) == "kernel"
    attn = _attend(q, k, v, cfg, kernel).transpose(1, 2).reshape(b, s, -1)
    return x + attn @ layer["attn_out"].to(cfg.dtype)


def _block(x: torch.Tensor, layer: dict, cfg: ModelConfig,
           yarn: Yarn | None = None):
    """One transformer block over x [batch, seq, d_model] in compute
    dtype, without the JAX package's ``ffn`` hook (its mesh branch is
    :func:`_mesh_layer`); ``yarn`` as in :func:`_attention_residual`.
    Returns ``(x, aux)``; aux holds the MoE router losses, zeros for
    the dense FFN."""
    x = _attention_residual(x, layer, cfg, yarn)
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
    kinds, of_layer = layer_kinds(cfg)
    for i in range(cfg.n_layers):
        layer = {name: w[i] for name, w in params["blocks"].items()}
        lcfg, yarn = kinds[of_layer[i]]
        if cfg.remat:
            x, layer_aux = checkpoint(_block, x, layer, lcfg, yarn,
                                      use_reentrant=False)
        else:
            x, layer_aux = _block(x, layer, lcfg, yarn)
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

    def _clip(self, grads: dict, norm_sq=None) -> dict:
        # The leaves may lie on several devices (a mesh's blocks): the
        # norm is summed on the first leaf's and read back on each.
        if norm_sq is None:
            leaves = [g for _, g in _flatten(grads)]
            dev = leaves[0].device
            norm = torch.sqrt(sum(torch.sum(g * g).to(dev) for g in leaves))
        else:
            norm = torch.sqrt(norm_sq(grads))
        max_norm = self.train.grad_clip
        keep = norm < max_norm
        return _map_tree(
            lambda g: torch.where(keep.to(g.device), g,
                                  g / norm.to(g.device) * max_norm), grads)

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

    def _inner(self, grads: dict, state: dict, params: dict, norm_sq):
        if self.train.grad_clip is not None:
            grads = self._clip(grads, norm_sq)
        return self._adamw(grads, state, params)

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict, norm_sq=None):
        """(updates, new state) for ``grads`` at ``params``; add the
        updates to the params (:func:`apply_updates`).  ``norm_sq(tree)
        -> 0-d tensor``, when given, is the clip's squared global norm
        of a gradient tree of this shape (the sum over the pieces every
        process holds, :func:`_sharded_update`); by default the sum
        over the tree's leaves."""
        k = self.train.accum_steps
        if k == 1:
            return self._inner(grads, state, params, norm_sq)
        n = state["mini_step"]
        acc = _map_tree(lambda g, a: a + (g - a) / (n + 1), grads,
                        state["acc"])
        if n < k - 1:
            return _tree_zeros(grads), {**state, "mini_step": n + 1,
                                        "acc": acc}
        updates, inner = self._inner(acc, state, params, norm_sq)
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


# ---- sharding -----------------------------------------------------------
#
# The JAX package declares its (data, model) layout with NamedSharding
# and lets XLA place the collectives.  Here a process holds the mesh as
# a grid of devices (a device may repeat, so ranks share a card, as the
# JAX tests' virtual CPU devices do), every rank holds its own block of
# every tensor of the state, cut by its partition spec (Sharded), the
# Megatron products run on the model ranks of each data row, and the
# collectives are ``.to()`` copies, cats and adds, which autograd
# transposes.  A mesh may span processes (the data rows of several
# hosts, ``distributed.make_process_mesh``): each process then holds the
# blocks of its own ranks, and meets the others through
# ``torch.distributed`` (:func:`_process_all_gather`).


class P(tuple):
    """A partition spec, the port's ``jax.sharding.PartitionSpec``: one
    entry per tensor axis from the front, each None (replicated), a mesh
    axis name, or a tuple of names (their product, the first major; a
    one-name tuple is the name, as JAX normalises it); missing trailing
    entries are None."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class Mesh:
    """A grid of devices with named axes, the port's
    ``jax.sharding.Mesh``.  ``devices`` is a numpy object array of
    torch.devices with one dimension per name; a device may appear more
    than once, so ranks share a card.  Rank r is the r-th device in
    row-major order (``ranks[r]``); ``shape`` maps each axis name to its
    size, in order.

    A mesh over several processes holds None at the ranks of the other
    processes: ``local`` lists this process's ranks (one contiguous run,
    as long on every process, so process p holds the p-th run), and
    ``process`` is its index among ``processes``.  A mesh of one process
    has every rank local."""

    def __init__(self, devices, axis_names):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-d device grid needs "
                             f"{devices.ndim} axis names, got {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = collections.OrderedDict(zip(self.axis_names,
                                                 devices.shape))
        self.size = devices.size
        self.ranks = [None if dev is None else _device(dev)
                      for dev in devices.flat]
        self.local = [r for r, dev in enumerate(self.ranks)
                      if dev is not None]
        n = len(self.local)
        if not n or self.size % n or self.local != list(
                range(self.local[0], self.local[0] + n)):
            raise ValueError("a process's ranks must be one contiguous run "
                             "that divides the mesh")
        self.processes = self.size // n
        self.process = self.local[0] // n

    @property
    def first(self) -> torch.device:
        """The device of this process's first rank."""
        return self.ranks[self.local[0]]

    def process_ranks(self, process: int) -> range:
        """The ranks process ``process`` holds."""
        n = len(self.local)
        return range(process * n, (process + 1) * n)

    def coords(self, rank: int) -> dict:
        """Rank ``rank``'s coordinate along each axis."""
        return dict(zip(self.axis_names,
                        np.unravel_index(rank, self.devices.shape)))


def make_mesh(devices=None, tp: int | None = None) -> Mesh:
    """2-D (data, model) mesh over ``devices`` (default: every visible
    CUDA card; a device may repeat).  tp defaults to 2 when the device
    count is even, as in the JAX package, the rest data-parallel; a
    count tp does not divide leaves the last devices out."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass devices=['cpu'] "
                               "(--platform cpu) to run on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_device(dev) for dev in devices]
    n = len(devices)
    if tp is None:
        tp = 2 if n % 2 == 0 and n >= 2 else 1
    if not 1 <= tp <= n:
        raise ValueError(f"tp must be in [1, {n}] for {n} devices, got {tp}")
    dp = n // tp
    grid = np.empty((dp, tp), dtype=object)
    for r in range(dp * tp):
        grid[r // tp, r % tp] = devices[r]
    return Mesh(grid, ("data", "model"))


def param_specs(cfg: ModelConfig) -> dict:
    """Partition specs: Megatron TP over the 'model' axis."""
    if cfg.moe_experts is None:
        ffn = {
            "w1": P(None, None, "model"),        # column-parallel
            "w2": P(None, "model", None),        # row-parallel
        }
    else:
        # Experts replicate over 'model'; TP splits each expert's d_ff.
        # The router is tiny and replicates.
        ffn = {
            "router": P(None, None, None),
            "w1": P(None, None, None, "model"),
            "w2": P(None, None, "model", None),
        }
    return {
        "embed": P(None, "model"),
        "blocks": {
            "qkv": P(None, None, "model"),       # heads split
            "attn_out": P(None, "model", None),  # row-parallel
            **ffn,
            "ln1": P(None, None),
            "ln2": P(None, None),
        },
        "ln_f": P(None),
        "unembed": P(None, "model"),
    }


def data_axes(mesh: Mesh) -> tuple:
    """The mesh axes that carry batch: every axis except 'model' (on a
    multi-slice (dcn, data, model) mesh, dcn and data)."""
    return tuple(n for n in mesh.axis_names if n != "model")


def batch_spec(mesh: Mesh | None = None) -> P:
    """Batch sharding: every mesh axis except 'model' is data-parallel."""
    if mesh is None:
        return P("data", None)
    return P(data_axes(mesh), None)


def _zero1_spec(spec: P, shape: tuple, mesh: Mesh,
                skip_axes: tuple = ()) -> P:
    """Data-axis sharding for one param-shaped buffer (ZeRO/FSDP): keep
    the param's TP sharding and also cut the first still-replicated axis
    (not in ``skip_axes``) whose size divides the data parallelism over
    the data axes.  If none qualifies, the buffer stays param-sharded."""
    daxes = data_axes(mesh)
    dp = int(np.prod([mesh.shape[a] for a in daxes])) if daxes else 1
    if dp <= 1:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for i, (dim, entry) in enumerate(zip(shape, entries)):
        if i in skip_axes:
            continue
        if entry is None and dim % dp == 0:
            entries[i] = daxes if len(daxes) > 1 else daxes[0]
            return P(*entries)
    return spec


def fsdp_param_specs(cfg: ModelConfig, mesh: Mesh) -> dict:
    """FSDP/ZeRO-3 partition specs: TP sharding plus a data-axis cut on
    each param's first eligible replicated axis; the stacked-layer axis
    (axis 0 of every ``blocks`` leaf) is never cut, so the step gathers
    one layer at a time."""
    shapes = param_shapes(cfg)
    return {name: ({k: _zero1_spec(spec, shapes[name][k], mesh,
                                   skip_axes=(0,))
                    for k, spec in tree.items()}
                   if isinstance(tree, dict)
                   else _zero1_spec(tree, shapes[name], mesh))
            for name, tree in param_specs(cfg).items()}


def _state_specs(state: dict, p_specs: dict, mesh: Mesh, zero1: bool):
    """Specs for an :class:`Optimizer` state dict: each moment tree
    (``mu``, ``nu``, and ``acc`` under accumulation) takes its params'
    specs, plus the ZeRO-1 data-axis cut when asked; the counts are host
    ints and replicate."""
    def one(leaf, spec):
        if leaf.ndim == 0:
            return P()
        return _zero1_spec(spec, tuple(leaf.shape), mesh) if zero1 else spec

    return {key: (_map_tree(one, value, p_specs) if isinstance(value, dict)
                  else P())
            for key, value in state.items()}


def opt_state_shardings(cfg: ModelConfig, optimizer: Optimizer,
                        p_specs: dict, mesh: Mesh, zero1: bool) -> dict:
    """Specs for ``optimizer``'s state given the params' specs, read off
    its state over the config's shapes on meta tensors."""
    meta = _map_tree(lambda shape: torch.empty(shape, device="meta"),
                     param_shapes(cfg))
    return _state_specs(optimizer.init(meta), p_specs, mesh, zero1)


def _cut_axes(spec: P, ndim: int) -> list[tuple]:
    """The mesh axes each of ``ndim`` tensor axes is cut over."""
    entries = list(spec) + [None] * (ndim - len(spec))
    return [() if e is None else (e,) if isinstance(e, str) else tuple(e)
            for e in entries]


@dataclasses.dataclass(eq=False)
class Sharded:
    """One leaf of a tree sharded over ``mesh``: the global ``shape`` cut
    by ``spec`` into blocks, ``blocks[rank]`` the block rank ``rank``
    holds (its position along each tensor axis: :meth:`index_of`), on
    that rank's device.  Every rank holds its own block, as each JAX
    device holds its shard: the ranks of a replica group hold equal
    copies, each in a storage of its own, and a step sums their
    gradients (JAX's psum) and updates every copy alike.  ``blocks``
    holds this process's ranks (:attr:`Mesh.local`); a step reads the
    blocks only other processes hold through :func:`_fetch`.  ``order``,
    when set, permutes the last axis before the cut (qkv's head-aligned
    columns, :func:`_qkv_order`)."""

    mesh: Mesh
    spec: P
    shape: tuple
    blocks: dict
    order: torch.Tensor | None = None

    @property
    def cut_axes(self) -> list[tuple]:
        return _cut_axes(self.spec, len(self.shape))

    @property
    def counts(self) -> list[int]:
        """Blocks along each tensor axis."""
        return [int(np.prod([self.mesh.shape[a] for a in axes]))
                for axes in self.cut_axes]

    def index_of(self, rank: int) -> tuple:
        """The index of the block rank ``rank`` holds."""
        coords = self.mesh.coords(rank)
        out = []
        for axes in self.cut_axes:
            i = 0
            for a in axes:
                i = i * self.mesh.shape[a] + int(coords[a])
            out.append(i)
        return tuple(out)

    @functools.cached_property
    def indices(self) -> list[tuple]:
        """Every rank's block index, in rank order."""
        return [self.index_of(r) for r in range(self.mesh.size)]

    def first_holders(self, ranks) -> dict:
        """index -> the first of ``ranks`` that holds it, for each index
        they hold, in rank order."""
        out: dict = {}
        for r in ranks:
            out.setdefault(self.indices[r], r)
        return out

    def holder(self, index: tuple, near: int | None = None) -> int | None:
        """A rank of this process that holds block ``index``: ``near``
        itself when it does, else the first; None when only other
        processes' ranks hold it."""
        if near in self.blocks and self.indices[near] == index:
            return near
        return next((r for r in self.blocks if self.indices[r] == index),
                    None)

    def region(self, index: tuple) -> tuple:
        """Block ``index``'s slices of the (ordered) global tensor."""
        return tuple(slice(i * (n // c), (i + 1) * (n // c))
                     for i, n, c in zip(index, self.shape, self.counts))


def shard_tensor(mesh: Mesh, x: torch.Tensor, spec: P,
                 order: torch.Tensor | None = None) -> Sharded:
    """``x`` cut by ``spec`` over ``mesh`` (after ``order`` permutes its
    last axis): each of this process's ranks gets its block on its own
    device, a copy of its own, so no two ranks share a storage and no
    block keeps the whole of ``x`` alive."""
    leaf = Sharded(mesh, P(*spec), tuple(x.shape), {}, order)
    for d, (n, c) in enumerate(zip(leaf.shape, leaf.counts)):
        if n % c:
            raise ValueError(f"axis {d} of a {leaf.shape} tensor does not "
                             f"divide over the {c} ranks of {spec}")
    if order is not None:
        x = x.index_select(-1, order.to(x.device))
    for r in mesh.local:
        leaf.blocks[r] = x[leaf.region(leaf.indices[r])].to(
            mesh.ranks[r], copy=True, memory_format=torch.contiguous_format)
    return leaf


def _process_all_gather(mesh: Mesh, tensors: list, group=None) -> list[list]:
    """Each process's ``tensors`` (the same count, shapes and dtype on
    every process), one list per process in process order, on this
    process's first device: one ``torch.distributed.all_gather`` over
    ``group`` (default: every process) of the tensors flattened into one
    buffer, through host memory under gloo.  Every process of the mesh
    must call it at the same point."""
    import torch.distributed as dist

    dev = mesh.first
    flat = torch.cat([t.detach().reshape(-1).to(dev) for t in tensors])
    if dist.get_backend(group) == "gloo":
        flat = flat.cpu()
    outs = [torch.empty_like(flat) for _ in range(mesh.processes)]
    dist.all_gather(outs, flat, group=group)
    sizes = [t.numel() for t in tensors]
    return [[part.view_as(t) for part, t in zip(out.to(dev).split(sizes),
                                                tensors)]
            for out in outs]


def _partial(leaf: Sharded) -> bool:
    """Whether only other processes' ranks hold some block of ``leaf``
    (a leaf FSDP or ZeRO-1 cuts over data rows of several processes).
    The same on every process."""
    return leaf.mesh.processes > 1 and len(leaf.first_holders(
        leaf.blocks)) < len(set(leaf.indices))


def _at(t: torch.Tensor, layer: int | None) -> torch.Tensor:
    return t if layer is None else t[layer]


def _sent(leaves: dict, layer: int | None = None) -> list:
    """What this process sends of ``leaves`` (name -> :class:`Sharded`):
    each leaf's distinct blocks at ``layer``, from their first holders,
    in rank order."""
    return [_at(leaf.blocks[r], layer) for leaf in leaves.values()
            for r in leaf.first_holders(leaf.blocks).values()]


def _received(leaves: dict, got: list[list]) -> dict:
    """(name, index) -> block, for the blocks of ``leaves`` that only
    other processes hold, read from ``got`` (:func:`_process_all_gather`
    of every process's :func:`_sent`)."""
    mesh = next(iter(leaves.values())).mesh
    out = {}
    for q, theirs in enumerate(got):
        theirs = iter(theirs)
        for name, leaf in leaves.items():
            mine = leaf.first_holders(leaf.blocks)
            for index in leaf.first_holders(mesh.process_ranks(q)):
                t = next(theirs)
                if index not in mine:
                    out.setdefault((name, index), t)
    return out


def gather_tensor(leaf: Sharded, device=None) -> torch.Tensor:
    """The whole tensor of ``leaf`` on ``device`` (default: this
    process's first rank's), in the one-device layout, a tensor of its
    own (a step overwrites the blocks): each block from its first
    holder; over a mesh that spans processes, the blocks only other
    processes hold come over ``torch.distributed``, so every process
    must call it."""
    dev = leaf.mesh.first if device is None else _device(device)
    blocks = {index: leaf.blocks[r]
              for index, r in leaf.first_holders(leaf.blocks).items()}
    if _partial(leaf):
        got = _process_all_gather(leaf.mesh, _sent({"": leaf}))
        blocks.update({index: t for (_, index), t in _received(
            {"": leaf}, got).items()})
    if len(blocks) == 1 and leaf.order is None:
        return next(iter(blocks.values())).to(dev, copy=True)
    t0 = next(iter(blocks.values()))
    out = torch.empty(leaf.shape, dtype=t0.dtype, device=dev)
    for index, t in blocks.items():
        out[leaf.region(index)] = t.to(dev)
    if leaf.order is not None:
        out = out.index_select(-1, torch.argsort(leaf.order).to(dev))
    return out


def gather_params(mesh: Mesh, tree):
    """A tree of :class:`Sharded` leaves (params, or an optimizer state
    whose counts pass through) in the one-device layout, on this
    process's first rank: what a checkpoint holds.  A collective over a
    mesh that spans processes (:func:`gather_tensor`)."""
    if isinstance(tree, dict):
        return {k: gather_params(mesh, v) for k, v in tree.items()}
    return gather_tensor(tree) if isinstance(tree, Sharded) else tree


def _qkv_rank_cols(cfg: ModelConfig, tp: int, j: int) -> torch.Tensor:
    """The packed qkv weight's columns of model rank j of ``tp``: its
    h/tp query heads, then its hkv/tp KV heads' k and v columns,
    ``[q_j | k_j | v_j]`` (the JAX package's ``sp._local_qkv``)."""
    d, kv = cfg.d_model, cfg.kv_heads * cfg.head_dim
    qw, kw = d // tp, kv // tp
    return torch.cat([torch.arange(j * qw, (j + 1) * qw),
                      d + torch.arange(j * kw, (j + 1) * kw),
                      d + kv + torch.arange(j * kw, (j + 1) * kw)])


def _qkv_order(cfg: ModelConfig, mesh: Mesh) -> torch.Tensor | None:
    """The column order that makes each model rank's contiguous block of
    the packed qkv weight head-aligned (:func:`_qkv_rank_cols` of each
    rank in turn).  JAX's spec cuts ``[q | k | v]`` contiguously, which
    GSPMD may do because it only lays memory out; a rank that computes
    needs whole heads.  None when tp is 1 or the heads do not divide
    (the step then gathers qkv and attends per data row)."""
    tp = mesh.shape.get("model", 1)
    if tp == 1 or not cfg.mesh_shardable(mesh):
        return None
    return torch.cat([_qkv_rank_cols(cfg, tp, j) for j in range(tp)])


def _replica_cut(cfg: ModelConfig, tp: int, name: str, t: torch.Tensor,
                 j: int) -> torch.Tensor:
    """Model rank j's part of one layer ``t`` of the ``blocks`` leaf
    ``name`` held whole (replicated over 'model', as the sp and ep steps
    hold the dense weights): the head-aligned qkv columns
    (:func:`_qkv_rank_cols`), or the block :func:`param_specs` cuts over
    'model'; the whole of a leaf it does not cut."""
    if tp == 1:
        return t
    if name == "qkv":
        return t.index_select(-1, _qkv_rank_cols(cfg, tp, j).to(t.device))
    axes = _cut_axes(param_specs(cfg)["blocks"][name], t.ndim + 1)[1:]
    for d, cut in enumerate(axes):
        if cut == ("model",):
            n = t.shape[d] // tp
            return t.narrow(d, j * n, n)
    return t


def _shard_tree(mesh: Mesh, cfg: ModelConfig, tree: dict, specs: dict):
    """``tree`` cut by ``specs`` over ``mesh`` (:func:`shard_tensor`);
    qkv takes its head-aligned order (:func:`_qkv_order`) where its spec
    cuts it over 'model'."""
    order = _qkv_order(cfg, mesh)
    flat_specs = dict(_flatten(specs))
    return _unflatten({
        path: shard_tensor(mesh, x, flat_specs[path],
                           order if path == "blocks/qkv" and any(
                               "model" in axes for axes in _cut_axes(
                                   flat_specs[path], x.ndim)) else None)
        for path, x in _flatten(tree)})


def _shard_specs(cfg: ModelConfig, mesh: Mesh, shard: str) -> dict:
    return fsdp_param_specs(cfg, mesh) if shard == "fsdp" \
        else param_specs(cfg)


def shard_params(mesh: Mesh, cfg: ModelConfig, tree: dict,
                 shard: str = "none") -> dict:
    """A one-device params tree at the specs of ``shard`` ("none" and
    "zero1": :func:`param_specs`; "fsdp": :func:`fsdp_param_specs`):
    each rank's block on its own device."""
    return _shard_tree(mesh, cfg, tree, _shard_specs(cfg, mesh, shard))


def shard_opt_state(mesh: Mesh, cfg: ModelConfig, state: dict,
                    shard: str = "none") -> dict:
    """A one-device :class:`Optimizer` state at the specs of ``shard``:
    the moments take their params' specs, cut over data under "zero1"
    as well; the counts pass through."""
    return _shard_state(mesh, cfg, state, _state_specs(
        state, _shard_specs(cfg, mesh, shard), mesh, shard == "zero1"))


def _shard_state(mesh: Mesh, cfg: ModelConfig, state: dict, specs: dict):
    return {key: (_shard_tree(mesh, cfg, value, specs[key])
                  if isinstance(value, dict) else value)
            for key, value in state.items()}


def rank_state_bytes(mesh: Mesh, params: dict, opt_state: dict) -> list:
    """The bytes of params and optimizer tensors each of this process's
    ranks stores (:attr:`Mesh.local`, in rank order): its own blocks,
    each in a storage of its own, so a block replicated over a group of
    ranks counts on every one of them, as JAX's addressable shards do on
    each device."""
    pos = {r: i for i, r in enumerate(mesh.local)}
    out = [0] * len(pos)
    for tree in (params, *(v for v in opt_state.values()
                           if isinstance(v, dict))):
        for _, leaf in _flatten(tree):
            for r, t in leaf.blocks.items():
                out[pos[r]] += t.numel() * t.element_size()
    return out


def _tp_view(leaf: Sharded, rank: int, dev, layer: int | None = None,
             remote: dict | None = None):
    """What rank ``rank`` computes with, on ``dev``: its own block of
    ``leaf``, at layer ``layer`` of a stacked ``blocks`` leaf, gathered
    over the data axes FSDP cuts: the blocks along that axis in order,
    its own where it holds one, else another rank's of this process, or
    ``remote[index]``, fetched from another process (:func:`_fetch`): a
    cat, which autograd transposes into the reduce-scatter."""
    own = leaf.indices[rank]
    cut = next((d for d, axes in enumerate(leaf.cut_axes)
                if axes and axes != ("model",)), None)

    def block(index):
        r = leaf.holder(index, rank)
        if r is None:
            return remote[index].to(dev)
        return _at(leaf.blocks[r], layer).to(dev)

    if cut is None:
        return block(own)
    return torch.cat([block(own[:cut] + (k,) + own[cut + 1:])
                      for k in range(leaf.counts[cut])],
                     dim=cut - (layer is not None))


class _Fetch(torch.autograd.Function):
    """FSDP's gather across processes, of the blocks at one layer of the
    leaves of :func:`_fetch`'s plan.  Forward: every process sends its
    distinct blocks (``sent``, :func:`_sent`) and receives the others'
    (one all-gather over the plan's gather group).  Backward: the
    gradients of the received blocks go back to the processes that hold
    them (one all-reduce, over the plan's reduce group, of a buffer of
    every block index, each process adding its received blocks'
    gradients; a process keeps its own indices' sums: the
    reduce-scatter), returned as the gradients of ``sent``.  ``token``
    orders the reductions: each call takes the previous call's token and
    returns its own, so a call's backward runs after the next call's on
    every process, whichever device thread runs it."""

    @staticmethod
    def forward(ctx, plan, token, *sent):
        ctx.plan = plan
        ctx.sent = [(t.shape, t.device) for t in sent]
        got = _received(plan["leaves"], _process_all_gather(
            plan["mesh"], list(sent), plan["groups"][0]))
        return (token.new_zeros(()), *(got[key] for key in plan["keys"]))

    @staticmethod
    def backward(ctx, d_token, *d_got):
        import torch.distributed as dist

        plan = ctx.plan
        dev, group = plan["mesh"].first, plan["groups"][1]
        flat = torch.zeros(plan["numel"], dtype=d_got[0].dtype, device=dev)
        for key, g in zip(plan["keys"], d_got):
            flat[plan["where"][key]] = g.reshape(-1).to(dev)
        if dist.get_backend(group) == "gloo":
            flat = flat.cpu()
        dist.all_reduce(flat, group=group)
        flat = flat.to(dev)
        return (None, torch.zeros_like(d_token), *(
            flat[plan["where"][key]].view(shape).to(sent_dev)
            for key, (shape, sent_dev) in zip(plan["sent_keys"],
                                              ctx.sent)))


def _fetch(tree: dict, layer: int | None, token, groups):
    """``(remote, token)``: the blocks at ``layer`` of the leaves of
    ``tree`` (a params tree of the step, or its ``blocks``) that only
    other processes hold, ``remote[name][index]``, through
    :class:`_Fetch` (FSDP's gather of one layer before it runs, inside
    the layer's checkpoint, so the blocks live as long as the layer's
    own activations), and the token that orders the next call (a new one
    when ``token`` is None).  Every process of the mesh calls it at the
    same point: when no leaf is cut over processes it does nothing, on
    every process, and returns ``token`` unchanged."""
    leaves = {name: leaf for name, leaf in tree.items()
              if isinstance(leaf, Sharded) and _partial(leaf)}
    if not leaves:
        return {}, token
    mesh = next(iter(leaves.values())).mesh
    where, start = {}, 0
    for name, leaf in leaves.items():
        block = _at(next(iter(leaf.blocks.values())), layer)
        for index in sorted(set(leaf.indices)):
            where[name, index] = slice(start, start + block.numel())
            start += block.numel()
    mine = {(name, index) for name, leaf in leaves.items()
            for index in leaf.first_holders(leaf.blocks)}
    plan = dict(mesh=mesh, leaves=leaves, groups=groups, where=where,
                numel=start, keys=[key for key in where if key not in mine],
                sent_keys=[(name, index) for name, leaf in leaves.items()
                           for index in leaf.first_holders(leaf.blocks)])
    if token is None:
        token = torch.zeros((), device=mesh.first)
    token, *got = _Fetch.apply(plan, token, *_sent(leaves, layer))
    remote = collections.defaultdict(dict)
    for (name, index), t in zip(plan["keys"], got):
        remote[name][index] = t
    return remote, token


def _vocab_parallel_ce_sum(x, targets, unembeds, row, cfg: ModelConfig):
    """The summed next-token NLL of one data row's [b, s] block with the
    unembedding's vocab cut over the row's model ranks (``unembeds[j]``
    [d, V/tp] in the compute dtype on ``row[j]``): each rank's logits
    stay on it; the log-sum-exps and the target logit are combined
    across ranks on the row's first.  Chunked over the sequence when
    ``cfg.ce_chunk`` divides it."""
    b, s = targets.shape
    head = row[0]
    chunk = cfg.ce_chunk if cfg.ce_chunk is not None \
        and s % cfg.ce_chunk == 0 else s
    v_loc = unembeds[0].shape[-1]
    total = torch.zeros((), dtype=torch.float32, device=head)
    for start in range(0, s, chunk):
        xc, tc = x[:, start:start + chunk], targets[:, start:start + chunk]
        lses, tgts = [], []
        for j, (u, dev) in enumerate(zip(unembeds, row)):
            logits = (xc.to(dev) @ u).float()
            lses.append(torch.logsumexp(logits, dim=-1).to(head))
            local = tc.to(dev).long() - j * v_loc
            picked = logits.gather(
                -1, local.clamp(0, v_loc - 1)[..., None])[..., 0]
            inside = (local >= 0) & (local < v_loc)
            tgts.append(torch.where(inside, picked, 0.0).to(head))
        lse = torch.logsumexp(torch.stack(lses), dim=0)
        total = total + (lse - sum(tgts)).sum()
    return total


_PRODUCTS = ("qkv", "attn_out", "w1", "w2")


def mesh_rows(mesh: Mesh) -> list[list[torch.device]]:
    """The mesh's data rows, row-major over every axis but 'model': row
    i lists the devices of its model ranks in 'model' order, so rank
    (i, j) is ``mesh_rows(mesh)[i][j]``.  A mesh without a 'model' axis
    has rows of one rank."""
    names = list(mesh.axis_names)
    grid = mesh.devices
    if "model" in names:
        grid = np.moveaxis(grid, names.index("model"), -1)
    tp = mesh.shape.get("model", 1)
    return [[_device(dev) for dev in row] for row in grid.reshape(-1, tp)]


def heads_split(cfg: ModelConfig, tp: int) -> bool:
    """Whether each of ``tp`` model ranks holds whole query and KV heads
    (both divide by tp): the attention and its cache are then cut by
    heads; otherwise each data row attends over whole heads on its first
    rank."""
    return cfg.n_heads % tp == 0 and cfg.kv_heads % tp == 0


def _tp_attention(xs, w, rows, cfg: ModelConfig, rope, attend):
    """The attention half of one block, tensor-parallel over every data
    row: ``xs[i]`` [b_i, s, d] in compute dtype on the row's first rank
    (``rows[i][0]``).  Training and serving share it; they differ in
    ``w``, ``rope`` and ``attend``:

    - ``w(name, i, j, dev)``: data row i's model rank j's block of the
      layer's weight ``name`` on ``dev`` (j None: the whole weight);
    - ``rope(t, i)``: t rotated at data row i's positions (None: no
      rope);
    - ``attend(shards) -> outs``: shards[i] holds data row i's (q, k,
      v), one per model rank when the heads divide over the ranks
      (:func:`heads_split`; rank j's head-aligned columns on rows[i][j],
      :func:`_qkv_order`), else one over whole heads on the row's first
      rank; outs[i] the matching attention outputs.  The rows need not
      attend alone: the sequence-parallel step's rows are the sequence
      shards its rings join.

    qkv is column-parallel by heads, attn_out row-parallel (the partial
    products summed on the row's first rank: the all-reduce).  Returns
    the streams with the attention added."""
    tp = len(rows[0])
    split = heads_split(cfg, tp)
    heads = (cfg.n_heads // tp, cfg.kv_heads // tp) if split else None
    shards = []
    for i, (x, row) in enumerate(zip(xs, rows)):
        y = _rmsnorm(x, w("ln1", i, 0, row[0]))
        ranks = list(enumerate(row)) if split else [(None, row[0])]
        shards.append([])
        for j, dev in ranks:
            q, k, v = _split_qkv(y.to(dev), w("qkv", i, j, dev), cfg, heads)
            if rope is not None:
                q, k = rope(q, i), rope(k, i)
            shards[-1].append((q, k, v))
    outs = attend(shards)
    new = []
    for i, (x, out, row) in enumerate(zip(xs, outs, rows)):
        head = row[0]
        b, s, d = x.shape
        if split:
            parts = [a.transpose(1, 2).reshape(b, s, d // tp) for a in out]
        else:
            # Whole heads on the row's first rank: cut the features for
            # the row-parallel attn_out.
            parts = torch.split(out[0].transpose(1, 2).reshape(b, s, d),
                                d // tp, dim=-1)
        new.append(x + sum((a.to(dev) @ w("attn_out", i, j, dev)).to(head)
                           for j, (a, dev) in enumerate(zip(parts, row))))
    return new


def _tp_ffn(xs, w, rows, cfg: ModelConfig):
    """The FFN half of one block over every data row (``xs``, ``w`` and
    ``rows`` as :func:`_tp_attention` takes them): w1 column-parallel,
    w2 row-parallel (the partial products summed on the row's first
    rank); a MoE layer routes once per row (the router replicates) and
    sums the experts' d_ff-cut MLPs over the row's ranks.  Returns (new
    streams, each row's router aux; zeros for the dense FFN)."""
    new, auxs = [], []
    for i, (x, row) in enumerate(zip(xs, rows)):
        head = row[0]
        y = _rmsnorm(x, w("ln2", i, 0, head))
        if cfg.moe_experts is not None:
            def experts(buf, i=i, row=row):
                return sum(expert_mlp(buf.to(dev), w("w1", i, j, dev),
                                      w("w2", i, j, dev)).to(buf.device)
                           for j, dev in enumerate(row))

            out, aux = moe_ffn(y, {"router": w("router", i, 0, head)}, cfg,
                               experts)
        else:
            out = sum((F.gelu(y.to(dev) @ w("w1", i, j, dev),
                              approximate="tanh")
                       @ w("w2", i, j, dev)).to(head)
                      for j, dev in enumerate(row))
            zero = torch.zeros((), dtype=torch.float32, device=head)
            aux = {"balance_loss": zero, "z_loss": zero}
        new.append(x + out)
        auxs.append(aux)
    return new, auxs


def _tp_layer(xs, w, rows, cfg: ModelConfig, rope, attend):
    """One block, tensor-parallel over every data row:
    :func:`_tp_attention`, then :func:`_tp_ffn`.  Returns (new streams,
    each row's router aux)."""
    return _tp_ffn(_tp_attention(xs, w, rows, cfg, rope, attend), w, rows,
                   cfg)


def _mesh_attend(cfg: ModelConfig, rows, attn):
    """The ``attend`` of a mesh whose rows attend alone: K1/K2 through
    ``attn`` (:func:`~attention.make_sharded_flash_attention` over the
    mesh) on the head shards of every row at once, or, when the heads
    do not divide, on each row's whole heads; else the einsum."""
    tp = len(rows[0])
    kernel = cfg.resolved_attention(rows[0][0]) == "kernel"

    def attend(shards):
        if kernel and heads_split(cfg, tp):
            qs, ks, vs = zip(*(s for row in shards for s in row))
            outs = attn(list(qs), list(ks), list(vs))
            return [outs[i * tp:(i + 1) * tp] for i in range(len(shards))]
        return [[_attend(q, k, v, cfg, kernel) for q, k, v in row]
                for row in shards]

    return attend


def _mesh_layer(xs, params: dict, layer: int, *, cfg: ModelConfig, rows,
                ranks, attn, remote=None):
    """Layer ``layer`` of the training block over every data row
    (:func:`_tp_layer`), each rank computing with its own blocks of the
    :class:`Sharded` ``params`` (``ranks[i][j]``: the rank of row i's
    model rank j) and the blocks ``remote`` holds of other processes
    (:func:`_fetch`): attention is K1/K2 through ``attn`` on head
    shards, or on each row's whole heads when the heads do not divide
    (K1/K2 there on CUDA), else the einsum (:func:`_mesh_attend`)."""
    remote = remote or {}
    tp = len(rows[0])
    dt = cfg.dtype
    blocks = params["blocks"]
    views: dict = {}

    def w(name, i, j, dev):
        # Each rank's weight once per layer; the products' weights
        # already in the compute dtype (norm gains and the router stay
        # f32, as one device reads them).
        if j is None:
            return torch.cat([w(name, i, k, dev) for k in range(tp)],
                             dim=-1)
        if (name, i, j, dev) not in views:
            t = _tp_view(blocks[name], ranks[i][j], dev, layer,
                         remote.get(name))
            views[name, i, j, dev] = t.to(dt) if name in _PRODUCTS else t
        return views[name, i, j, dev]

    rope = (lambda t, i: _rope(t, cfg.rope_theta)) if cfg.rope else None
    return _tp_layer(xs, w, rows, cfg, rope, _mesh_attend(cfg, rows, attn))


# ---- serving under a mesh ------------------------------------------------
#
# The serving steps run the training block's tensor-parallel layer
# (_tp_layer) over weights placed once, at engine construction, as each
# rank's compute-dtype blocks on that rank's own device (TPParams).  A
# block is held once per distinct device: ranks that share a card share
# it, so on one card the placement holds one model.


@dataclasses.dataclass(eq=False)
class TPParams:
    """A one-device params tree placed for serving over ``mesh``:
    ``blocks[(path, j, dev)]`` is model rank j's block of leaf ``path``
    (cut over 'model' by :func:`param_specs`, qkv in :func:`_qkv_order`)
    in the compute dtype (the MoE router f32, as :func:`cast_params`
    keeps it) on ``dev``; j is 0 for a leaf 'model' does not cut, and
    None for the whole packed qkv when the heads do not divide over the
    ranks (:func:`heads_split`).  ``cfg`` is resolved for the mesh."""

    mesh: Mesh
    cfg: ModelConfig
    blocks: dict

    @functools.cached_property
    def rows(self) -> list[list[torch.device]]:
        return mesh_rows(self.mesh)

    @property
    def first(self) -> torch.device:
        """The engine's device: where tokens arrive and logits leave."""
        return self.rows[0][0]

    def weights(self, layer: int | None = None):
        """``w(name, i, j, dev)`` over these blocks, as :func:`_tp_layer`
        reads it (every data row i reads the blocks of its devices): at
        layer ``layer`` of the stacked ``blocks`` leaves, or the
        top-level leaves (embed, ln_f, unembed) when None."""
        def w(name, i, j, dev):
            if layer is None:
                return self.blocks[name, j, dev]
            return self.blocks[f"blocks/{name}", j, dev][layer]
        return w

    def nbytes(self) -> int:
        """The bytes of every placed block (one model on one card)."""
        return sum(t.numel() * t.element_size() for t in self.blocks.values())


def row_sizes(n: int, rows: int) -> list[int]:
    """``n`` items cut over ``rows`` data rows as ``torch.tensor_split``
    cuts them: the first ``n % rows`` rows take one more."""
    return [n // rows + (i < n % rows) for i in range(rows)]


def place_params(mesh: Mesh, cfg: ModelConfig, params: dict) -> TPParams:
    """Place a one-device params tree (an f32 master from a checkpoint,
    or :func:`params_from_jax`) for serving over ``mesh``: each model
    rank's block of every leaf, in the compute dtype, on each distinct
    device that rank has across the data rows (the counterpart of the
    JAX engines' ``jax.device_put`` onto :func:`param_specs`).  Leaves
    'model' does not cut (the norm gains and the router) are placed on
    each row's first rank, which alone reads them; when the heads do not
    divide over the ranks the whole qkv goes there too.  A tree that is
    already placed over ``mesh`` is returned as it is."""
    cfg.require_uniform("serving under a mesh")
    if isinstance(params, TPParams):
        if params.mesh is not mesh:
            raise ValueError("params are placed over another mesh")
        return params
    cfg = cfg.resolved_for_mesh(mesh)
    tp = mesh.shape.get("model", 1)
    rows = mesh_rows(mesh)
    split = heads_split(cfg, tp)
    order = _qkv_order(cfg, mesh)
    specs = dict(_flatten(param_specs(cfg)))
    blocks: dict = {}
    for path, x in _flatten(params):
        dt = torch.float32 if path == "blocks/router" else cfg.dtype
        cut = [d for d, axes in enumerate(_cut_axes(specs[path], x.ndim))
               if axes == ("model",)]
        if cut and x.shape[cut[0]] % tp:
            raise ValueError(f"axis {cut[0]} of {path} {tuple(x.shape)} "
                             f"does not divide over {tp} model ranks")
        if path == "blocks/qkv" and order is not None:
            x = x.index_select(-1, order.to(x.device))
        size = x.shape[cut[0]] // tp if cut else None
        for row in rows:
            if path == "blocks/qkv" and not split:
                wanted = [(None, row[0])]
            elif cut:
                wanted = list(enumerate(row))
            else:
                wanted = [(0, row[0])]
            for j, dev in wanted:
                if (path, j, dev) in blocks:
                    continue
                t = x if j is None or not cut else x.narrow(
                    cut[0], j * size, size)
                blocks[path, j, dev] = t.to(
                    device=dev, dtype=dt, copy=True,
                    memory_format=torch.contiguous_format)
    return TPParams(mesh, cfg, blocks)


def tp_embed(sp: TPParams, tokens: list, rows: list[int]) -> list:
    """The tokens [b_i, s] of data rows ``rows`` (indices into
    ``sp.rows``) as their residual streams [b_i, s, d] in compute dtype
    on each row's first rank: the embedding's d_model cut gathered over
    the row's ranks."""
    w = sp.weights()
    out = []
    for t, i in zip(tokens, rows):
        row = sp.rows[i]
        out.append(torch.cat([w("embed", i, j, dev)[t.to(dev)].to(row[0])
                              for j, dev in enumerate(row)], dim=-1))
    return out


def tp_logits(sp: TPParams, xs: list, rows: list[int]) -> torch.Tensor:
    """The logits of the streams ``xs`` of data rows ``rows`` (indices
    into ``sp.rows``): final norm on each row's first rank, the
    unembedding vocab-parallel over its ranks, gathered over the vocab
    and then over the rows on the first device -> [sum b_i, ..., vocab]
    f32."""
    w = sp.weights()
    out = []
    for x, i in zip(xs, rows):
        row = sp.rows[i]
        x = _rmsnorm(x, w("ln_f", i, 0, row[0]))
        out.append(torch.cat([(x.to(dev) @ w("unembed", i, j, dev)).float()
                              .to(sp.first) for j, dev in enumerate(row)],
                             dim=-1))
    return torch.cat(out, dim=0)


def kv_zeros(sp: TPParams, row: list, lead: tuple, tail: tuple) -> list:
    """Zeroed KV-cache shards of one data row, in the compute dtype:
    ``[*lead, kv_heads/tp, *tail]`` on each of the row's ranks when the
    heads divide over them (:func:`heads_split`), else ``[*lead,
    kv_heads, *tail]`` on its first rank alone.  Each shard is a tensor
    of its own, so an in-place write lands in one shard only."""
    cfg = sp.cfg
    split = heads_split(cfg, len(row))
    hkv = cfg.kv_heads // len(row) if split else cfg.kv_heads
    return [torch.zeros((*lead, hkv, *tail), dtype=cfg.dtype, device=dev)
            for dev in (row if split else row[:1])]


def kv_gather(shards: list, device) -> torch.Tensor:
    """KV shards ``shards[i][n]`` (data row i, rank n; heads on axis 2,
    the row's batch on axis 1) as the one-device tensor on ``device``."""
    return torch.cat([torch.cat([t.to(device) for t in row], dim=2)
                      for row in shards], dim=1)


class _PerDevice:
    """Values a serving step's layers share, made once per (key,
    device): the per-row lengths, write indices and rope tables each
    shard reads on its own device."""

    def __init__(self):
        self._made: dict = {}

    def __call__(self, key, dev, make):
        if (key, dev) not in self._made:
            self._made[key, dev] = make(dev)
        return self._made[key, dev]


def tp_blocks(sp: TPParams, xs: list, rows: list[int], rope, attend):
    """Every layer over the streams ``xs`` of data rows ``rows``
    (:func:`_tp_layer`): ``rope(t, i)`` rotates at row i's positions,
    ``attend(layer, i, j, q, k, v)`` is the attention of shard (row i,
    rank j) at ``layer`` (j None: the row's whole heads).  Returns the
    streams after the last layer."""
    row_devs = [sp.rows[i] for i in rows]
    rot = None if rope is None else (lambda t, n: rope(t, rows[n]))
    split = heads_split(sp.cfg, len(row_devs[0]))
    for layer in range(sp.cfg.n_layers):
        def attend_all(shards, layer=layer):
            return [[attend(layer, rows[n], j if split else None, q, k, v)
                     for j, (q, k, v) in enumerate(row)]
                    for n, row in enumerate(shards)]

        xs, _ = _tp_layer(xs, sp.weights(layer), row_devs, sp.cfg, rot,
                          attend_all)
    return xs


def _make_mesh_loss(mesh: Mesh, cfg: ModelConfig):
    """``loss_of(params, tokens) -> loss``: :func:`loss_fn` of tokens
    [b, s + 1] with ``params`` a tree of :class:`Sharded` leaves over
    ``mesh``, on this process's first rank's device.  The batch is cut
    row-major over this process's data rows (every mesh axis but
    'model'); each row's block and residual stream live on its first
    model rank.  The embedding's d_model cut is gathered per row, the
    cross-entropy is vocab-parallel (:func:`_vocab_parallel_ce_sum`),
    and with ``cfg.remat`` each layer, over all ranks, runs under
    ``torch.utils.checkpoint``.  FSDP's gathers happen inside each
    layer, so one layer's weights are whole at a time; over a mesh that
    spans processes the layer first fetches its blocks of other
    processes (:func:`_fetch`, inside the checkpoint, and again when
    the backward recomputes the layer; their gradients go back to their
    processes as the backward leaves the layer), and the loss is this
    process's rows' mean.  Fetches and their reductions use two process
    groups, so the recomputes' gathers and the backward's reductions
    never meet in one group's order."""
    tp = mesh.shape.get("model", 1)
    ranks = [mesh.local[i:i + tp] for i in range(0, len(mesh.local), tp)]
    rows = [[mesh.ranks[r] for r in row] for row in ranks]
    attn = make_sharded_flash_attention(
        Mesh(np.array(rows, dtype=object), ("data", "model")), causal=True,
        window=cfg.attention_window)
    layer_fn = functools.partial(_mesh_layer, cfg=cfg, rows=rows,
                                 ranks=ranks, attn=attn)
    first = mesh.first
    groups = (None, None)
    if mesh.processes > 1:
        import torch.distributed as dist

        groups = (None, dist.new_group())

    def loss_of(params: dict, tokens):
        b, s = tokens.shape[0], tokens.shape[1] - 1
        if b % len(rows):
            raise ValueError(f"global batch {b} is not divisible by the "
                             f"{len(rows)}-way data parallelism")
        b_loc = b // len(rows)
        row_tokens = [tokens[i * b_loc:(i + 1) * b_loc].to(row[0])
                      for i, row in enumerate(rows)]
        views: dict = {}
        top, token = _fetch(params, None, None, groups)

        def w(name, i, j, dev):
            if (name, i, j) not in views:
                t = _tp_view(params[name], ranks[i][j], dev,
                             remote=top.get(name))
                views[name, i, j] = t if name == "ln_f" else t.to(cfg.dtype)
            return views[name, i, j]

        def run(xs, token, layer):
            remote, token = _fetch(params["blocks"], layer, token, groups)
            return (*layer_fn(xs, params=params, layer=layer,
                              remote=remote), token)

        xs = [torch.cat([w("embed", i, j, dev)[t[:, :-1].to(dev)].to(row[0])
                         for j, dev in enumerate(row)], dim=-1)
              for i, (t, row) in enumerate(zip(row_tokens, rows))]
        per_layer = []
        for layer in range(cfg.n_layers):
            if cfg.remat:
                xs, auxs, token = checkpoint(run, xs, token, layer,
                                             use_reentrant=False)
            else:
                xs, auxs, token = run(xs, token, layer)
            per_layer.append(auxs)
        total = sum(_vocab_parallel_ce_sum(
            _rmsnorm(x, w("ln_f", i, 0, row[0])), t[:, 1:],
            [w("unembed", i, j, dev) for j, dev in enumerate(row)], row,
            cfg).to(first)
            for i, (x, t, row) in enumerate(zip(xs, row_tokens, rows)))
        ce = total / (b * s)
        if cfg.moe_experts is None:
            return ce
        return _ranks_loss(ce, per_layer, cfg, first)[0]

    return loss_of


def _enclosing(p: Sharded, m: Sharded, mi: tuple):
    """The block of ``p`` that holds block ``mi`` of ``m`` (a buffer of
    p's shape whose spec refines p's), and mi's slices inside it."""
    pi, local = [], []
    for i, a, c, n in zip(mi, p.counts, m.counts, p.shape):
        pi.append(i * a // c)
        start = i * (n // c) - pi[-1] * (n // a)
        local.append(slice(start, start + n // c))
    return tuple(pi), tuple(local)


def _unit_norm_sq(moments: dict, mesh: Mesh):
    """The clip's ``norm_sq`` over the units of :func:`_sharded_update`
    (gradient pieces keyed (path, moment block index)) when the mesh
    spans processes: each process sums the units whose lowest holding
    rank is its own, so a unit held on several counts once, and the sum
    is all-reduced."""
    import torch.distributed as dist

    def norm_sq(grads: dict):
        dev = next(iter(grads.values())).device
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for (path, mi), g in grads.items():
            leaf = moments[path]
            if leaf.indices.index(mi) in leaf.blocks:
                total = total + torch.sum(g * g).to(dev)
        if dist.get_backend() == "gloo":
            total = total.cpu()
        dist.all_reduce(total)
        return total.to(dev)

    return norm_sq


@torch.no_grad()
def _sharded_update(optimizer: Optimizer, params: dict, grads: dict,
                    opt_state: dict):
    """The optimizer's update over sharded state, in place: ``params``
    maps each path to its :class:`Sharded` leaf, ``grads`` each (path,
    block index) to the gradient of that block, summed over its replicas
    (and averaged over the processes).  The optimizer runs once per
    distinct block of the moments this process holds (a unit), on the
    device of its first holder: the gradient and the param cut to it
    (the reduce-scatter ahead of a ZeRO-1 update), then the optimizer's
    own arithmetic over the flat dict of the units, so the clip's norm
    counts every element once (over the processes too,
    :func:`_unit_norm_sq`).  Every rank then copies its units' new
    moments into its own moment blocks, and adds to its own param block
    the updates of the units inside it (the all-gather back; units only
    other processes hold come over ``torch.distributed``), so the
    replicas of a block stay bit for bit equal.  The blocks are
    overwritten, as the JAX package's step donates its params and state,
    so a step holds one copy of the state and the optimizer's temporaries
    of one copy of the distinct units.  Returns the (params tree, opt
    state), their leaves the ones given."""
    moments = dict(_flatten(opt_state["mu"]))
    units, g_u, p_u = {}, {}, {}
    for path, p in params.items():
        m = moments[path]
        for mi, r in m.first_holders(m.blocks).items():
            pi, local = _enclosing(p, m, mi)
            dev = m.blocks[r].device
            units[path, mi] = (r, pi, local)
            g_u[path, mi] = grads[path, pi][local].to(dev)
            p_u[path, mi] = p.blocks[p.holder(pi, r)][local].to(dev)
    trees = {key: dict(_flatten(value)) for key, value in opt_state.items()
             if isinstance(value, dict)}
    state = {key: ({(path, mi): trees[key][path].blocks[r]
                    for (path, mi), (r, _, _) in units.items()}
                   if key in trees else value)
             for key, value in opt_state.items()}
    mesh = next(iter(moments.values())).mesh
    updates, state = optimizer.update(
        g_u, state, p_u,
        _unit_norm_sq(moments, mesh) if mesh.processes > 1 else None)
    del g_u, p_u
    parts = collections.defaultdict(list)
    for (path, mi), (_, pi, local) in units.items():
        parts[path, pi].append((local, updates[path, mi]))
    if mesh.processes > 1:
        _gather_updates(params, moments, units, updates, parts)
    for path, p in params.items():
        for r, t in p.blocks.items():
            for local, u in parts[path, p.indices[r]]:
                t[local] += u.to(t.device)
    del parts, updates
    for key, tree in trees.items():
        for path, leaf in tree.items():
            for r, t in leaf.blocks.items():
                t.copy_(state[key][path, leaf.indices[r]])
    return _unflatten(params), {
        key: (opt_state[key] if key in trees else state[key])
        for key in opt_state}


def _gather_updates(params: dict, moments: dict, units: dict, updates: dict,
                    parts) -> None:
    """Add to ``parts`` ((path, param block index) -> [(slices, update)])
    the updates of the moment units only other processes hold inside
    param blocks this process holds (ZeRO-1 over data axes that cross
    processes): each process sends its units' updates of every such
    leaf, in one all-gather.  Under FSDP a leaf's moments are cut as its
    params are, so no leaf needs it and nothing is sent."""
    paths = []
    for path, m in moments.items():
        p = params[path]
        held = {p.indices[r] for r in p.blocks}
        theirs = set(m.indices) - set(m.first_holders(m.blocks))
        if any(_enclosing(p, m, mi)[0] in held for mi in theirs):
            paths.append(path)
    if not paths:
        return
    mesh = moments[paths[0]].mesh
    sent = [updates[path, mi] for path in paths
            for mi in moments[path].first_holders(moments[path].blocks)]
    for q, got in enumerate(_process_all_gather(mesh, sent)):
        if q == mesh.process:
            continue
        got = iter(got)
        for path in paths:
            m = moments[path]
            for mi in m.first_holders(mesh.process_ranks(q)):
                u = next(got)
                if (path, mi) not in units:
                    pi, local = _enclosing(params[path], m, mi)
                    parts[path, pi].append((local, u))


def _replicated_update(optimizer: Optimizer, params: dict, grads: dict,
                       opt_state: dict):
    """The optimizer over one-copy params whose moments are
    :class:`Sharded` leaves (ZeRO-1 under sequence parallelism): each
    param and its gradient taken as a replicated leaf of the moments'
    mesh held by its first rank alone, the update per moment block
    (:func:`_sharded_update`, in place).  Returns the (params tree, opt
    state)."""
    mesh = next(leaf for _, leaf in _flatten(opt_state["mu"])).mesh
    first = mesh.local[0]
    whole = {path: Sharded(mesh, P(), tuple(t.shape), {first: t})
             for path, t in _flatten(params)}
    flat = {(path, (0,) * t.ndim): t for path, t in _flatten(grads)}
    new, opt_state = _sharded_update(optimizer, whole, flat, opt_state)
    return _map_tree(lambda leaf: leaf.blocks[first], new), opt_state


def _check_shard(shard: str) -> None:
    if shard not in {"none", "zero1", "fsdp"}:
        raise ValueError(f"unknown shard mode {shard!r}; expected "
                         "'none', 'zero1' or 'fsdp'")


def _sharded_step(optimizer: Optimizer, loss_of, has_aux: bool = False):
    """``step_fn(params, opt_state, tokens)`` over trees of
    :class:`Sharded` leaves: the gradient of ``loss_of(params, tokens)``
    by ``torch.autograd.grad`` with respect to every rank's blocks,
    summed per block index over its replicas in rank order on the first
    holder's device (the psum, one fixed order of adds, so every replica
    steps alike), then the optimizer per block, in place
    (:func:`_sharded_update`).  Over a mesh that spans processes the
    loss and the gradients of the blocks every process holds are
    averaged over the processes (``distributed.process_mean``); a block
    only this process holds already carries the other processes' parts
    (:func:`_fetch`'s backward) and is scaled alike.  ``has_aux``:
    ``loss_of`` returns ``(loss, metrics)`` and step_fn ``(params,
    opt_state, loss, metrics)``, the metrics detached."""

    def step_fn(params: dict, opt_state: dict, tokens):
        tokens = torch.as_tensor(tokens)
        live = {path: dataclasses.replace(leaf, blocks={
            r: t.detach().requires_grad_() for r, t in leaf.blocks.items()})
            for path, leaf in _flatten(params)}
        loss = loss_of(_unflatten(live), tokens)
        if has_aux:
            loss, metrics = loss
        keys = [(path, leaf.indices[r], t)
                for path, leaf in live.items() for r, t in leaf.blocks.items()]
        grads = torch.autograd.grad(loss, [k[-1] for k in keys],
                                    allow_unused=True)
        sums: dict = {}
        for (path, index, _), g in zip(keys, grads):
            if g is None:
                continue
            if (path, index) in sums:
                prev = sums[path, index]
                sums[path, index] = prev + g.to(prev.device)
            else:
                sums[path, index] = g
        del keys, grads     # the replicas' own gradients, summed now
        for path, leaf in live.items():     # a block no rank read: zeros
            for r, t in leaf.blocks.items():
                if (path, leaf.indices[r]) not in sums:
                    sums[path, leaf.indices[r]] = torch.zeros_like(t)
        mesh = next(iter(live.values())).mesh
        if mesh.processes > 1:
            shared = [key for key in sorted(sums)
                      if not _partial(live[key[0]])]
            loss, *synced = process_mean([loss, *(sums[k] for k in shared)])
            for key in sums:
                sums[key] = sums[key] / mesh.processes
            sums.update(zip(shared, synced))
        params, opt_state = _sharded_update(
            optimizer, dict(_flatten(params)), sums, opt_state)
        if has_aux:
            return params, opt_state, loss.detach(), {
                name: m.detach() for name, m in metrics.items()}
        return params, opt_state, loss.detach()

    return step_fn


def make_sharded_train_step(mesh: Mesh, cfg: ModelConfig,
                            learning_rate: float = 1e-3,
                            zero1: bool = False,
                            train: TrainConfig | None = None,
                            shard: str | None = None):
    """(init_fn, step_fn) over ``mesh`` (:func:`make_mesh`, or a
    (dcn, data, model) mesh from ``distributed.make_multislice_mesh``)
    with real DP + TP shardings: Megatron tensor parallelism over
    'model' (:func:`_mesh_layer`), the batch over the data axes.
    ``attention="auto"`` is resolved per the mesh
    (:meth:`ModelConfig.resolved_for_mesh`) and the route logged once.

    ``init_fn(generator) -> (params, opt_state)``: the f32 params of
    :func:`init_params` (the same seed gives the one-device step's
    model), placed at the specs as trees of :class:`Sharded` leaves.
    ``step_fn(params, opt_state, tokens) -> (params, opt_state, loss)``:
    the gradient by ``torch.autograd.grad`` with respect to every block,
    then the optimizer recipe (``train``, default bare
    adamw(``learning_rate``)) per block (:func:`_sharded_update`, in
    place: the step consumes its params and state, as the JAX package's
    donates them).  A mesh over several processes
    (``distributed.make_process_mesh``) is the JAX trainer's one mesh
    over every process's devices: each process steps on its own data
    rows and the gradients are averaged over the processes
    (:func:`_sharded_step`).

    ``shard`` (``zero1=True`` is the legacy spelling of "zero1"):

    - ``"none"``: params, grads and moments replicated over data;
    - ``"zero1"``: the AdamW moments (and the accumulator) also cut over
      the data axes; params and grads replicated;
    - ``"fsdp"``: params, grads and moments all cut over the data axes
      (:func:`fsdp_param_specs`), each layer's weights gathered inside
      the layer loop.

    :func:`gather_params` and :func:`shard_params` /
    :func:`shard_opt_state` move the state between these trees and the
    one-device layout (checkpoints)."""
    cfg.require_uniform("the mesh train step")
    if shard is None:
        shard = "zero1" if zero1 else "none"
    _check_shard(shard)
    cfg = cfg.resolved_for_mesh(mesh)
    log.info("mesh %s, shard %s: attention %s on %s", dict(mesh.shape),
             shard, cfg.attention, "head shards" if cfg.mesh_shardable(mesh)
             else "each data row's whole heads")
    if train is None:
        train = TrainConfig(learning_rate=learning_rate)
    optimizer = make_optimizer(train)
    p_specs = _shard_specs(cfg, mesh, shard)
    s_specs = opt_state_shardings(cfg, optimizer, p_specs, mesh,
                                  shard == "zero1")

    def init_fn(generator: torch.Generator):
        params = init_params(generator, cfg, mesh.first)
        return (_shard_tree(mesh, cfg, params, p_specs),
                _shard_state(mesh, cfg, optimizer.init(params), s_specs))

    return init_fn, _sharded_step(optimizer, _make_mesh_loss(mesh, cfg))


def make_train_step(cfg: ModelConfig, train: TrainConfig | None = None,
                    device=None, shard: str = "none", tracer=None):
    """(init_fn, step_fn) on one device: the single-device counterpart
    of the JAX package's ``make_sharded_train_step``.

    ``init_fn(generator) -> (params, opt_state)``: f32 master params
    drawn from ``generator`` (:func:`init_params`) on ``device``.
    ``step_fn(params, opt_state, tokens) -> (params, opt_state, loss)``:
    tokens [batch, seq + 1] (numpy or a tensor), the gradient of
    :func:`loss_fn` with respect to the f32 master params by
    ``torch.autograd.grad``, then the optimizer's update.  The step
    returns new params and state; the loss is a 0-d device tensor.
    ``shard`` "zero1" and "fsdp" cut the state over data ranks, and one
    device has one, so every mode runs this same step (the JAX
    package's single-device trainer takes them over a one-device
    mesh).  ``tracer``: each step is a span tree (:func:`_make_step`)."""
    _check_shard(shard)
    dev = resolve_device(device)
    return _make_step(cfg, make_optimizer(train or TrainConfig()), dev,
                      lambda tree, tokens: loss_fn(tree, tokens, cfg),
                      tracer=tracer)


def _make_step(cfg: ModelConfig, optimizer: Optimizer, dev: torch.device,
               loss_of, has_aux: bool = False, tracer=None):
    """(init_fn, step_fn) for the f32 master params on ``dev`` and the
    loss ``loss_of(params, tokens)``: the gradient by
    ``torch.autograd.grad`` with respect to the master params, then the
    optimizer's update (shared by the single-device, sequence-parallel
    and expert-parallel steps).  ``has_aux``: ``loss_of`` returns
    ``(loss, metrics)`` and step_fn ``(params, opt_state, loss,
    metrics)``, the metrics detached.  Moments held as
    :class:`Sharded` leaves (ZeRO-1 under sequence parallelism) are
    updated per block (:func:`_replicated_update`).

    ``tracer`` (:class:`~tpu_autoscaler_torch.obs.trace.Tracer`): each
    step is a ``train.step`` span over ``train.forward`` (the loss),
    ``train.backward`` (``torch.autograd.grad``, remat's recompute
    included) and ``train.update`` (the optimizer and the new params).
    Nothing waits for the device: the loss stays a device tensor."""

    def init_fn(generator: torch.Generator):
        params = init_params(generator, cfg, dev)
        return params, optimizer.init(params)

    def step_fn(params: dict, opt_state: dict, tokens):
        with maybe_span(tracer, "train.step"):
            tokens = torch.as_tensor(tokens, device=dev)
            paths, leaves = zip(*_flatten(params))
            leaves = [p.detach().requires_grad_() for p in leaves]
            with maybe_span(tracer, "train.forward"):
                loss = loss_of(_unflatten(dict(zip(paths, leaves))), tokens)
            if has_aux:
                loss, metrics = loss
            with maybe_span(tracer, "train.backward"):
                grads = torch.autograd.grad(loss, leaves)
            grads = _unflatten(dict(zip(paths, grads)))
            with maybe_span(tracer, "train.update"):
                if isinstance(next(_flatten(opt_state["mu"]))[1], Sharded):
                    params, opt_state = _replicated_update(
                        optimizer, params, grads, opt_state)
                else:
                    updates, opt_state = optimizer.update(grads, opt_state,
                                                          params)
                    params = apply_updates(params, updates)
        if has_aux:
            return params, opt_state, loss.detach(), {
                name: m.detach() for name, m in metrics.items()}
        return params, opt_state, loss.detach()

    return init_fn, step_fn
