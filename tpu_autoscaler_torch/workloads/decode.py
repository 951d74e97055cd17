"""Decoding helpers shared by the serving engine: logit warping and
sampling, and the fixed-batch cached attention.

The counterparts of the JAX package's ``workloads/decode.py``
``_warp_logits``, ``_sample`` and ``_cached_attention``.  Sampling draws
from an explicit ``torch.Generator``; it cannot reproduce ``jax.random``
bits, so tests compare greedy tokens and warped distributions.
"""

from __future__ import annotations

import torch

from tpu_autoscaler_torch.workloads.model import ModelConfig


def _cached_attention(q, k_cache, v_cache, length, cfg: ModelConfig):
    """Attend q [b, h, sq, hd] (positions length-sq .. length-1, already
    rotated) over the cache's first ``length`` entries with causal +
    window visibility.  Grouped-einsum GQA, f32 softmax."""
    b, h, sq, hd = q.shape
    hkv = k_cache.shape[1]
    max_len = k_cache.shape[2]
    qg = q.reshape(b, hkv, h // hkv, sq, hd)
    scores = torch.einsum("bngqd,bnkd->bngqk", qg, k_cache) * hd ** -0.5
    kpos = torch.arange(max_len, device=q.device)
    qpos = length - sq + torch.arange(sq, device=q.device)
    visible = kpos[None, :] <= qpos[:, None]
    if cfg.attention_window is not None:
        visible &= kpos[None, :] > qpos[:, None] - cfg.attention_window
    scores = torch.where(visible, scores.float(), -1e30)
    probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
    out = torch.einsum("bngqk,bnkd->bngqd", probs, v_cache)
    return out.reshape(b, h, sq, hd)


def _warp_logits(logits: torch.Tensor, temperature: float,
                 top_k: int | None, top_p: float | None) -> torch.Tensor:
    """Temperature/top-k/top-p warping (temperature must be > 0);
    softmax of the result is the sampling distribution."""
    scaled = logits / temperature
    if top_k is not None:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, -torch.inf, scaled)
    if top_p is not None:
        # Keep the smallest set of tokens whose mass reaches top_p: a
        # token survives when the mass BEFORE it is < top_p (the first
        # token always survives); the n_keep-th largest is the cutoff.
        sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        n_keep = ((cum - probs) < top_p).sum(dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1, n_keep - 1)
        scaled = torch.where(scaled < cutoff, -torch.inf, scaled)
    return scaled


def _sample(logits: torch.Tensor, generator: torch.Generator,
            temperature: float, top_k: int | None,
            top_p: float | None = None) -> torch.Tensor:
    """Greedy at temperature 0.0, else softmax sampling with optional
    top-k and/or top-p truncation, drawn from ``generator``."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(_warp_logits(logits, temperature, top_k, top_p),
                          dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    tok = torch.multinomial(flat, 1, generator=generator)
    return tok.reshape(probs.shape[:-1]).to(torch.int32)
