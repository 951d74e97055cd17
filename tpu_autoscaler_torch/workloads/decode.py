"""Autoregressive inference over a KV cache: prefill, decode steps,
generate; and the logit warping and sampling the serving engines share.

The counterpart of the JAX package's ``workloads/decode.py`` without
its mesh (``cache_specs``, ``_constrain_cache``, ``make_sharded_generate``)
and without speculative decoding (both a later slice, ROADMAP.md):

- **KVCache**: a preallocated per-layer cache ``[layers, b, kv_heads,
  max_len, head_dim]``.  Its length is a host ``int``, so the overflow
  checks need no device sync.  PyTorch runs eagerly, so the steps write
  the cache in place (the JAX versions return a new one); they still
  return the cache, so the call sites read like the JAX ones.
- **Attention routes** (``_attend``), the JAX package's exactly: a
  one-token block (``decode_step``, or ``extend_step`` with s == 1)
  reads the cache through the ``flash_decode`` kernel; the prompt of
  ``prefill`` (offset 0, s > 1) runs the ``flash_attention`` kernel on
  its fresh k/v, whose visible keys are exactly the cache's; every
  other block (``extend_step`` with s > 1) takes the einsum
  ``_cached_attention``.  A config that resolves to "einsum" takes it
  everywhere.
- **generate**: prefill, then ``steps - 1`` decode steps in a Python
  loop that leaves every token on the device until the end.

Sampling draws from an explicit ``torch.Generator``; it cannot
reproduce ``jax.random`` bits, so tests compare greedy tokens and warped
distributions.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_autoscaler_torch.workloads.attention import (
    flash_attention,
    flash_decode,
)
from tpu_autoscaler_torch.workloads.model import (
    ModelConfig,
    _ffn_residual,
    _rmsnorm,
    _rope_tables,
    _rotate,
    _split_qkv,
    cast_params,
    resolve_device,
)


@dataclasses.dataclass
class KVCache:
    """Preallocated per-layer K/V cache.

    k, v: [layers, batch, kv_heads, max_len, head_dim] in compute dtype;
    length: the number of filled positions, the same for every row
    (left-aligned prompts), kept on the host."""

    k: torch.Tensor
    v: torch.Tensor
    length: int

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    @classmethod
    def zeros(cls, cfg: ModelConfig, batch: int, max_len: int,
              device=None) -> "KVCache":
        shape = (cfg.n_layers, batch, cfg.kv_heads, max_len, cfg.head_dim)
        dev = resolve_device(device)
        return cls(k=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                   v=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                   length=0)


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


def _attend(q, k, v, k_cache, v_cache, cfg: ModelConfig, length: int,
            prompt: bool, row_lengths=None):
    """Pick the attention path for one cached block (see module doc).
    ``length`` is the filled length after this block's write;
    ``prompt`` marks prefill's block at offset 0, which the caller
    states (the length alone cannot tell a prompt from an extension);
    ``row_lengths`` is the step's [b] int32 copy of ``length`` on the
    device, made once for every layer, for the decode kernel."""
    s = q.shape[2]
    if cfg.resolved_attention(q.device) == "kernel":
        if s == 1:
            return flash_decode(q.contiguous(), k_cache, v_cache,
                                row_lengths, window=cfg.attention_window)
        if prompt:
            return flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=True,
                                   window=cfg.attention_window)
    return _cached_attention(q, k_cache, v_cache, length, cfg)


def _block_with_cache(x, layer, k_cache, v_cache, cfg: ModelConfig,
                      offset: int, prompt: bool, rope=None,
                      row_lengths=None):
    """One transformer block over x [b, s, d] at positions offset ..
    offset+s-1: model._block's math, but this chunk's k/v are written
    into the layer's cache (in place) and attention reads the cache.
    ``rope``: the (cos, sin) tables of these positions, shared by every
    layer of the call."""
    b, s, d = x.shape
    y = _rmsnorm(x, layer["ln1"])
    q, k, v = _split_qkv(y, layer["qkv"], cfg)
    if rope is not None:
        q, k = _rotate(q, *rope), _rotate(k, *rope)
    k_cache[:, :, offset:offset + s] = k
    v_cache[:, :, offset:offset + s] = v
    attn = _attend(q, k, v, k_cache, v_cache, cfg, offset + s, prompt,
                   row_lengths)
    attn = attn.transpose(1, 2).reshape(b, s, d)
    x = x + attn @ layer["attn_out"].to(cfg.dtype)
    y = _rmsnorm(x, layer["ln2"])
    return _ffn_residual(x, y, layer, cfg)


def _run_blocks(params, x, cache: KVCache, cfg: ModelConfig, offset: int,
                prompt: bool = False):
    """Every layer over x [b, s, d], threading the cache; returns
    (logits [b, s, vocab] f32, cache advanced to offset + s).  The
    values every layer shares are made once: the rope tables and, for a
    one-token kernel step, the [b] lengths."""
    b, s, _ = x.shape
    rope = None
    if cfg.rope:
        positions = offset + torch.arange(s, dtype=torch.float32,
                                          device=x.device)
        rope = _rope_tables(positions, cfg.head_dim, cfg.rope_theta,
                            cfg.dtype)
    row_lengths = None
    if s == 1 and cfg.resolved_attention(x.device) == "kernel":
        row_lengths = torch.full((b,), offset + 1, dtype=torch.int32,
                                 device=x.device)
    for i in range(cfg.n_layers):
        layer = {name: w[i] for name, w in params["blocks"].items()}
        x = _block_with_cache(x, layer, cache.k[i], cache.v[i], cfg, offset,
                              prompt, rope, row_lengths)
    x = _rmsnorm(x, params["ln_f"])
    logits = x @ params["unembed"].to(cfg.dtype)
    return logits.float(), KVCache(k=cache.k, v=cache.v, length=offset + s)


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int) -> tuple[torch.Tensor, KVCache]:
    """Run the prompt [b, s] through the model, filling a fresh cache on
    the tokens' device.  Returns (logits [b, s, vocab] f32, cache with
    length == s); the last position's logits seed generation."""
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"prompt length {s} exceeds max_len {max_len}")
    cache = KVCache.zeros(cfg, b, max_len, tokens.device)
    x = params["embed"].to(cfg.dtype)[tokens]
    return _run_blocks(params, x, cache, cfg, 0, prompt=True)


def decode_step(params: dict, cache: KVCache, tokens: torch.Tensor,
                cfg: ModelConfig) -> tuple[torch.Tensor, KVCache]:
    """One token per sequence: tokens [b] at position cache.length.
    Returns (logits [b, vocab] f32, cache advanced by one)."""
    if cache.length >= cache.max_len:
        # A write past max_len has no slot to land in.
        raise ValueError(f"KV cache full: length {cache.length} >= max_len "
                         f"{cache.max_len}")
    x = params["embed"].to(cfg.dtype)[tokens][:, None, :]
    logits, cache = _run_blocks(params, x, cache, cfg, cache.length)
    return logits[:, 0], cache


def extend_step(params: dict, cache: KVCache, tokens: torch.Tensor,
                cfg: ModelConfig) -> tuple[torch.Tensor, KVCache]:
    """Append ``tokens`` [b, s] to the cache in ONE forward: returns
    (logits [b, s, vocab] f32 for every appended position, cache
    advanced by s).  The multi-token sibling of decode_step (the
    verification primitive of speculative decoding)."""
    if cache.length + tokens.shape[1] > cache.max_len:
        raise ValueError(
            f"KV cache overflow: length {cache.length} + {tokens.shape[1]} "
            f"> max_len {cache.max_len}")
    x = params["embed"].to(cfg.dtype)[tokens]
    return _run_blocks(params, x, cache, cfg, cache.length)


def _rewind(cache: KVCache, length: int) -> KVCache:
    """Roll the logical length back (entries beyond ``length`` stay as
    garbage; the next write at ``length`` overwrites them before they
    can ever become visible)."""
    return KVCache(k=cache.k, v=cache.v, length=int(length))


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


def generate(params: dict, prompt, cfg: ModelConfig, steps: int, *,
             generator: torch.Generator | None = None,
             temperature: float = 0.0, top_k: int | None = None,
             top_p: float | None = None, max_len: int | None = None,
             device=None) -> torch.Tensor:
    """Prefill the prompt [b, s], then decode ``steps`` tokens.  Returns
    [b, s + steps] (prompt + generated) on ``device``.  Greedy by
    default; pass a ``generator`` (on ``device``) and a temperature
    (and optionally top_k / top_p) to sample.

    Runs on CUDA unless ``device`` says otherwise; the params are cast
    to the compute dtype on the device once, for the whole call."""
    b, s = prompt.shape
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    max_len = max_len if max_len is not None else s + steps
    if s + steps > max_len:
        raise ValueError(
            f"prompt {s} + steps {steps} exceeds max_len {max_len}")
    if temperature != 0.0 and generator is None:
        raise ValueError("sampling (temperature != 0) needs a "
                         "torch.Generator")
    if temperature == 0.0 and (top_k is not None or top_p is not None):
        raise ValueError(
            "top_k/top_p require temperature > 0 (temperature 0 is "
            "greedy argmax; truncation would be silently ignored)")
    vocab = params["unembed"].shape[-1]
    if top_k is not None and not 1 <= top_k <= vocab:
        raise ValueError(f"top_k must be in [1, {vocab}], got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    dev = resolve_device(device)
    params = cast_params(params, cfg.dtype, dev)
    prompt = torch.as_tensor(prompt, device=dev)
    logits, cache = prefill(params, prompt, cfg, max_len)
    out = torch.empty((b, steps), dtype=prompt.dtype, device=dev)
    token = _sample(logits[:, -1], generator, temperature, top_k, top_p)
    out[:, 0] = token
    # steps-1 decode steps: prefill already gave token 1 of ``steps``,
    # and the last token is emitted without a trailing decode of it.
    for i in range(1, steps):
        logits, cache = decode_step(params, cache, token, cfg)
        token = _sample(logits, generator, temperature, top_k, top_p)
        out[:, i] = token
    return torch.cat([prompt, out], dim=1)
