"""The StarCoder2 decoder (BigCode, arXiv:2402.19173) as the benchmark's
configuration files state it is run, in plain float32 PyTorch.

Per layer: x += W_o · attn(rope(q), rope(k), v) over y = norm(x), then
x += W_2 · gelu_tanh(W_1 · norm(x)); a final norm and the unembedding.
Attention is causal within a sliding window (key j is seen by query i
when i - window < j <= i), grouped-query (each key/value head serves
``heads / kv_heads`` query heads), scaled by head_dim ** -0.5, and
computed in blocks of queries so that a 4,096-token sequence fits.
RoPE rotates the two halves of each head (``rotate_half``) at
``theta ** (-i / (head_dim / 2))``.

The weights come in the layout the configuration states (``as_run``):
layers stacked along the first axis, q|k|v packed in one matrix's
columns, every product as ``x @ W``.  Departures from the published
block are the configuration's: a gain-only RMSNorm, no biases, no
dropout, an unembedding of its own.

``quant``, when given, quantizes both operands of every linear layer
(the benchmark's lower-precision control, :mod:`reference.control`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def strict_f32() -> None:
    """Every float32 product in float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Shape:
    """The sizes the reference reads from a configuration file."""

    def __init__(self, config: dict):
        self.layers = config["num_hidden_layers"]
        self.d = config["hidden_size"]
        self.heads = config["num_attention_heads"]
        self.kv_heads = config["num_key_value_heads"]
        self.head_dim = self.d // self.heads
        self.window = config["sliding_window"]
        self.theta = float(config["rope_theta"])
        self.eps = float(config["as_run"]["rms_norm_eps"])


def linear(x, w, quant=None):
    return x @ w if quant is None else quant(x, w)


def rmsnorm(x, gain, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * gain


def rope_tables(positions, head_dim: int, theta: float):
    half = head_dim // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64,
                                  device=positions.device) / half)
    angles = positions.to(torch.float64)[:, None] * inv[None, :]
    return torch.cos(angles).float(), torch.sin(angles).float()


def rotate(x, cos, sin):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attend(q, k, v, window: int, block: int = 512):
    """q [..., h, T, hd], k/v [..., hkv, T, hd] -> [..., h, T, hd]."""
    *lead, h, t, hd = q.shape
    hkv = k.shape[-3]
    g = h // hkv
    k = k.unsqueeze(-3).expand(*lead, hkv, g, t, hd).reshape(*lead, h, t, hd)
    v = v.unsqueeze(-3).expand(*lead, hkv, g, t, hd).reshape(*lead, h, t, hd)
    scale = 1.0 / math.sqrt(hd)
    keys = torch.arange(t, device=q.device)
    out = []
    for q0 in range(0, t, block):
        q1 = min(q0 + block, t)
        k0 = max(0, q0 - window + 1)
        qi = torch.arange(q0, q1, device=q.device)[:, None]
        kj = keys[None, k0:q1]
        seen = (kj <= qi) & (kj > qi - window)
        s = (q[..., q0:q1, :] @ k[..., k0:q1, :].transpose(-1, -2)) * scale
        s = s.masked_fill(~seen, float("-inf"))
        out.append(torch.softmax(s, dim=-1) @ v[..., k0:q1, :])
    return torch.cat(out, dim=-2)


def layer(x, ln1, qkv, attn_out, ln2, w1, w2, *, shape: Shape, cos, sin,
          quant=None):
    """One block over x [..., T, d] with this layer's weights."""
    *lead, t, d = x.shape
    h, hkv, hd = shape.heads, shape.kv_heads, shape.head_dim
    y = linear(rmsnorm(x, ln1, shape.eps), qkv, quant)
    q, k, v = torch.split(y, [h * hd, hkv * hd, hkv * hd], dim=-1)
    q = q.reshape(*lead, t, h, hd).transpose(-2, -3)
    k = k.reshape(*lead, t, hkv, hd).transpose(-2, -3)
    v = v.reshape(*lead, t, hkv, hd).transpose(-2, -3)
    a = attend(rotate(q, cos, sin), rotate(k, cos, sin), v, shape.window)
    x = x + linear(a.transpose(-2, -3).reshape(*lead, t, d), attn_out, quant)
    y = rmsnorm(x, ln2, shape.eps)
    hidden = F.gelu(linear(y, w1, quant), approximate="tanh")
    return x + linear(hidden, w2, quant)


_LAYER = ("ln1", "qkv", "attn_out", "ln2", "w1", "w2")


@torch.no_grad()
def logits_at(weights: dict, tokens, config: dict, rows, quant=None):
    """Logits [len(rows), vocab] f32 of one sequence ``tokens`` [T] at
    positions ``rows``; the weights in any float type, upcast a layer at
    a time."""
    shape = Shape(config)
    cos, sin = rope_tables(torch.arange(len(tokens), device=tokens.device),
                           shape.head_dim, shape.theta)
    x = weights["embed"][tokens].float()
    blocks = weights["blocks"]
    for i in range(shape.layers):
        w = [blocks[name][i].float() for name in _LAYER]
        x = layer(x, *w, shape=shape, cos=cos, sin=sin, quant=quant)
    x = rmsnorm(x[rows], weights["ln_f"].float(), shape.eps)
    return linear(x, weights["unembed"].float(), quant)


def loss_and_grads(params: dict, tokens, config: dict, quant=None):
    """Mean next-token cross-entropy of tokens [B, T + 1] and its
    gradient for every f32 leaf of ``params`` (a sequence at a time,
    each layer recomputed in the backward); (loss, grads) with grads a
    tree like ``params``."""
    shape = Shape(config)
    leaves = _leaves(params)
    for p in leaves.values():
        p.grad = None
        p.requires_grad_(True)
    b, t = tokens.shape[0], tokens.shape[1] - 1
    cos, sin = rope_tables(torch.arange(t, device=tokens.device),
                           shape.head_dim, shape.theta)
    blocks = params["blocks"]
    total = 0.0
    for row in range(b):
        x = params["embed"][tokens[row, :-1]]
        for i in range(shape.layers):
            w = [blocks[name][i] for name in _LAYER]
            x = checkpoint(_layer_fn(shape, cos, sin, quant), x, *w,
                           use_reentrant=False)
        x = rmsnorm(x, params["ln_f"], shape.eps)
        logits = linear(x, params["unembed"], quant)
        loss = F.cross_entropy(logits, tokens[row, 1:], reduction="sum") \
            / (b * t)
        loss.backward()
        total += float(loss.detach())
        del x, logits, loss
    grads = {path: p.grad for path, p in leaves.items()}
    for p in leaves.values():
        p.requires_grad_(False)
        p.grad = None
    return total, grads


def _layer_fn(shape, cos, sin, quant):
    def run(x, *w):
        return layer(x, *w, shape=shape, cos=cos, sin=sin, quant=quant)
    return run


def _leaves(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


class AdamW:
    """AdamW with bias correction and decoupled decay on every leaf:
    m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2, then
    p -= lr (m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) + wd p),
    in place, in float32."""

    def __init__(self, params: dict, *, learning_rate: float, b1: float,
                 b2: float, eps: float, weight_decay: float):
        self.lr, self.b1, self.b2 = learning_rate, b1, b2
        self.eps, self.wd = eps, weight_decay
        self.t = 0
        self.m = {p: torch.zeros_like(x) for p, x in _leaves(params).items()}
        self.v = {p: torch.zeros_like(x) for p, x in _leaves(params).items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for path, p in _leaves(params).items():
            g, m, v = grads[path], self.m[path], self.v[path]
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            u = (m / bc1) / ((v / bc2).sqrt_() + self.eps)
            p.sub_(u.add_(p, alpha=self.wd).mul_(self.lr))


def leaves(tree: dict) -> dict:
    """The '/'-joined leaf paths of a params tree and their tensors."""
    return _leaves(tree)
