"""The Mellum2 decoder (JetBrains, Mellum2-12B-A2.5B) as its
configuration file states it is run, in plain float32 PyTorch.

Per layer l, of kind ``layer_types[l]``:

    y = rmsnorm(x);  q, k, v = y W_q, y W_k, y W_v   (32 q / 4 kv heads of 128)
    x += W_o attn(rope_kind(q), rope_kind(k), v)
    y = rmsnorm(x);  p = softmax(y W_r) over the experts, in f32
    T = the top k of p (ties to the lower index);  w_e = p_e / sum_T p
    x += sum_{e in T} w_e (silu(y G_e) * (y U_e)) D_e

then a final rmsnorm and the unembedding.  Attention is causal and
grouped-query, scaled by head_dim ** -0.5; a ``sliding_attention``
layer sees key j from query i when i - sliding_window < j <= i, a
``full_attention`` layer every j <= i.  Each kind has its own RoPE
(``rope_parameters``): rotate-half at theta ** (-i / (head_dim / 2)),
and under ``rope_type: "yarn"`` Hugging Face's YaRN frequencies (the
ramp between the original and the ``factor``-scaled ones over the dims
that turn between ``beta_fast`` and ``beta_slow`` times in the original
context, floored and ceiled) with cos and sin scaled by the
``attention_factor``.  Every token goes to all of its k experts: no
capacity, none dropped.

The weights come in the layout the configuration states (``as_run``):
layers stacked along the first axis, q|k|v packed in one matrix's
columns, each expert's gate|up packed in ``w1`` [E, d, 2 f] and its
down projection in ``w2`` [E, f, d], every product as ``x @ W``.  No
cache and no batching: one sequence at a time, a layer at a time,
attention in blocks of queries, each expert over the tokens routed to
it.  ``quant``, when given, quantizes both operands of every linear
layer but the router (:mod:`reference.control`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.model import attend, linear, rmsnorm, rotate, \
    strict_f32

__all__ = ["Shape", "expert_ffn", "layer", "logits_at", "rope_tables",
           "strict_f32", "yarn_frequencies"]


class Shape:
    """The sizes the reference reads from a configuration file."""

    def __init__(self, config: dict):
        self.layers = config["num_hidden_layers"]
        self.d = config["hidden_size"]
        self.heads = config["num_attention_heads"]
        self.kv_heads = config["num_key_value_heads"]
        self.head_dim = config["head_dim"]
        self.eps = float(config["rms_norm_eps"])
        self.kinds = config["layer_types"]
        self.window = config["sliding_window"]
        self.rope = config["rope_parameters"]
        self.experts = config["num_experts"]
        self.top_k = config["num_experts_per_tok"]
        self.norm_topk = config["norm_topk_prob"]


def yarn_frequencies(head_dim: int, rope: dict) -> torch.Tensor:
    """YaRN's inverse frequencies [head_dim / 2], float64."""
    theta = float(rope["rope_theta"])
    half = head_dim // 2
    base = theta ** (-torch.arange(half, dtype=torch.float64) / half)
    original = rope["original_max_position_embeddings"]

    def turning_dim(rotations):
        return head_dim * math.log(original / (rotations * 2 * math.pi)) \
            / (2 * math.log(theta))

    low = max(math.floor(turning_dim(rope["beta_fast"])), 0)
    high = min(math.ceil(turning_dim(rope["beta_slow"])), head_dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(half, dtype=torch.float64) - low)
            / (high - low)).clamp(0, 1)
    keep = 1 - ramp
    return base / rope["factor"] * (1 - keep) + base * keep


def rope_tables(positions, head_dim: int, rope: dict):
    """cos, sin [T, head_dim / 2] float32 of one layer kind's RoPE."""
    if rope["rope_type"] == "yarn":
        inv = yarn_frequencies(head_dim, rope)
        scale = rope["attention_factor"]
    elif rope["rope_type"] == "default":
        half = head_dim // 2
        inv = float(rope["rope_theta"]) ** (
            -torch.arange(half, dtype=torch.float64) / half)
        scale = 1.0
    else:
        raise ValueError(f"rope_type {rope['rope_type']!r}")
    angles = positions.to(torch.float64)[:, None] \
        * inv.to(positions.device)[None, :]
    return ((torch.cos(angles) * scale).float(),
            (torch.sin(angles) * scale).float())


def expert_ffn(y, router, w1, w2, shape: Shape, quant=None):
    """The expert half over y [T, d]: f32 routing, then each expert over
    the tokens routed to it."""
    probs = torch.softmax(y @ router, dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :shape.top_k], topi[:, :shape.top_k]
    if shape.norm_topk:
        topv = topv / topv.sum(dim=-1, keepdim=True)
    out = torch.zeros_like(y)
    f = w2.shape[1]
    for e in range(shape.experts):
        token, choice = (topi == e).nonzero(as_tuple=True)
        if len(token) == 0:
            continue
        h = linear(y[token], w1[e], quant)
        h = F.silu(h[:, :f]) * h[:, f:]
        o = linear(h, w2[e], quant)
        out.index_add_(0, token, topv[token, choice, None] * o)
    return out


def layer(x, w: dict, *, shape: Shape, kind: str, cos, sin, quant=None):
    """One block over x [T, d] with this layer's weights ``w``."""
    t = x.shape[0]
    h, hkv, hd = shape.heads, shape.kv_heads, shape.head_dim
    y = linear(rmsnorm(x, w["ln1"], shape.eps), w["qkv"], quant)
    q, k, v = torch.split(y, [h * hd, hkv * hd, hkv * hd], dim=-1)
    q = q.reshape(t, h, hd).transpose(0, 1)
    k = k.reshape(t, hkv, hd).transpose(0, 1)
    v = v.reshape(t, hkv, hd).transpose(0, 1)
    window = shape.window if kind == "sliding_attention" else t
    a = attend(rotate(q, cos, sin), rotate(k, cos, sin), v, window)
    x = x + linear(a.transpose(0, 1).reshape(t, h * hd), w["attn_out"],
                   quant)
    y = rmsnorm(x, w["ln2"], shape.eps)
    return x + expert_ffn(y, w["router"], w["w1"], w["w2"], shape, quant)


_LAYER = ("ln1", "qkv", "attn_out", "ln2", "router", "w1", "w2")


@torch.no_grad()
def logits_at(weights: dict, tokens, config: dict, rows, quant=None):
    """Logits [len(rows), vocab] f32 of one sequence ``tokens`` [T] at
    positions ``rows``; the weights in any float type, upcast a layer at
    a time."""
    shape = Shape(config)
    positions = torch.arange(len(tokens), device=tokens.device)
    tables = {kind: rope_tables(positions, shape.head_dim,
                                shape.rope[kind])
              for kind in set(shape.kinds)}
    x = weights["embed"][tokens].float()
    blocks = weights["blocks"]
    for i, kind in enumerate(shape.kinds):
        w = {name: blocks[name][i].float() for name in _LAYER}
        x = layer(x, w, shape=shape, kind=kind, cos=tables[kind][0],
                  sin=tables[kind][1], quant=quant)
        del w
    x = rmsnorm(x[rows], weights["ln_f"].float(), shape.eps)
    return linear(x, weights["unembed"].float(), quant)
