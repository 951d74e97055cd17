"""Autoregressive inference over a KV cache: prefill, decode steps,
generate; and the logit warping and sampling the serving engines share.

The counterpart of the JAX package's ``workloads/decode.py``:

- **KVCache**: a preallocated per-layer cache ``[layers, b, kv_heads,
  max_len, head_dim]``.  Its length is a host ``int``, so the overflow
  checks need no device sync.  PyTorch runs eagerly, so the steps write
  the cache in place (the JAX versions return a new one); they still
  return the cache, so the call sites read like the JAX ones.
- **The mesh** (``mesh=`` on every step, ``make_sharded_generate``):
  the params placed once per rank (``model.place_params``), every layer
  tensor-parallel (``model.tp_blocks``), and the cache a
  :class:`MeshKVCache` cut as ``cache_specs`` says: the batch over the
  data rows (unevenly when it does not divide, where the JAX package
  leaves it whole), KV heads over 'model' when they divide, else whole
  heads on each row's first rank.  Each shard runs the one-device
  attention route on its own rows and heads: K3 per shard in decode,
  K1 per shard in the prompt's prefill.
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
- **speculative_generate** / **speculative_sample_generate**: a cheap
  draft proposes k tokens with decode steps, the target scores them in
  one ``extend_step``, and ``_rewind`` drops the rejected tail; the
  JAX package's host loop, round for round.

Sampling draws from an explicit ``torch.Generator``; it cannot
reproduce ``jax.random`` bits, so tests compare greedy tokens and warped
distributions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_autoscaler_torch.workloads.attention import (
    flash_attention,
    flash_decode,
)
from tpu_autoscaler_torch.workloads.model import (
    Mesh,
    ModelConfig,
    P,
    TPParams,
    _PerDevice,
    _ffn_residual,
    _rmsnorm,
    _rope_tables,
    _rotate,
    _split_qkv,
    cast_params,
    data_axes,
    kv_gather,
    kv_zeros,
    place_params,
    resolve_device,
    row_sizes,
    tp_blocks,
    tp_embed,
    tp_logits,
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


@dataclasses.dataclass
class MeshKVCache:
    """A :class:`KVCache` cut over a mesh's (data row, model rank)
    shards.  ``k[i][n]``, ``v[i][n]``: data row i's shard n, [layers,
    batch[i], kv_heads/tp, max_len, head_dim] on rank (i, n)'s device
    when the heads divide over the ranks (:func:`model.heads_split`),
    else one shard [layers, batch[i], kv_heads, max_len, head_dim] on the
    row's first rank.  Each shard is a tensor of its own, so an in-place
    write lands in one shard only.  ``batch``: the rows each data row
    holds (``model.row_sizes``); ``length`` is shared, on the host."""

    k: list
    v: list
    length: int
    batch: list

    @property
    def max_len(self) -> int:
        return self.k[0][0].shape[3]

    @classmethod
    def zeros(cls, sp: TPParams, batch: int, max_len: int) -> "MeshKVCache":
        sizes = row_sizes(batch, len(sp.rows))
        shards = [((sp.cfg.n_layers, b), (max_len, sp.cfg.head_dim), row)
                  for row, b in zip(sp.rows, sizes)]
        return cls(k=[kv_zeros(sp, row, lead, tail)
                      for lead, tail, row in shards],
                   v=[kv_zeros(sp, row, lead, tail)
                      for lead, tail, row in shards],
                   length=0, batch=sizes)

    def gather(self, device=None) -> KVCache:
        """The whole cache in the one-device layout on ``device``
        (default: the first shard's)."""
        dev = self.k[0][0].device if device is None else device
        return KVCache(k=kv_gather(self.k, dev), v=kv_gather(self.v, dev),
                       length=self.length)


def cache_specs(mesh: Mesh) -> KVCache:
    """Partition specs of a KVCache under a (data, model) mesh: batch
    over the data axes, KV heads over 'model' (the JAX package's
    ``cache_specs``).  :class:`MeshKVCache` realizes them per
    dimension: an uneven batch is cut unevenly, and KV heads that do
    not divide over 'model' stay whole on each data row's first rank."""
    kv = P(None, data_axes(mesh), "model", None, None)
    return KVCache(k=kv, v=kv, length=P())


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
    cfg.require_uniform("decode.generate")
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


def _mesh_run_blocks(sp: TPParams, tokens, cache: MeshKVCache,
                     offset: int, prompt: bool = False):
    """:func:`_run_blocks` under a mesh: tokens [b, s] cut over the data
    rows as the cache is, every layer tensor-parallel
    (:func:`model.tp_blocks`), each (row, rank) shard writing its own
    cache shard and attending through :func:`_attend` on it (K3 or K1
    per shard, or the einsum).  Returns (logits [b, s, vocab] f32 on the
    first device, cache advanced to offset + s)."""
    cfg = sp.cfg
    b, s = tokens.shape
    live = [i for i, n in enumerate(cache.batch) if n]
    parts = torch.split(tokens, cache.batch, dim=0)
    xs = tp_embed(sp, [parts[i] for i in live], live)
    on = _PerDevice()

    rope = None
    if cfg.rope:
        def rope(t, i):
            return _rotate(t, *on("rope", t.device, lambda d: _rope_tables(
                offset + torch.arange(s, dtype=torch.float32, device=d),
                cfg.head_dim, cfg.rope_theta, cfg.dtype)))

    def attend(layer, i, j, q, k, v):
        n = 0 if j is None else j
        k_c, v_c = cache.k[i][n][layer], cache.v[i][n][layer]
        k_c[:, :, offset:offset + s] = k
        v_c[:, :, offset:offset + s] = v
        lengths = None
        if s == 1 and cfg.resolved_attention(q.device) == "kernel":
            lengths = on(("lengths", i), q.device, lambda d: torch.full(
                (cache.batch[i],), offset + 1, dtype=torch.int32, device=d))
        return _attend(q, k, v, k_c, v_c, cfg, offset + s, prompt, lengths)

    xs = tp_blocks(sp, xs, live, rope, attend)
    logits = tp_logits(sp, xs, live)
    return logits, dataclasses.replace(cache, length=offset + s)


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int, mesh: Mesh | None = None):
    """Run the prompt [b, s] through the model, filling a fresh cache on
    the tokens' device.  Returns (logits [b, s, vocab] f32, cache with
    length == s); the last position's logits seed generation.

    ``mesh``: serve under it; ``params`` placed over it
    (:func:`model.place_params`, done here when given a plain tree) and
    the cache a :class:`MeshKVCache`; the logits come back on the mesh's
    first device."""
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"prompt length {s} exceeds max_len {max_len}")
    if mesh is not None:
        sp = place_params(mesh, cfg, params)
        cache = MeshKVCache.zeros(sp, b, max_len)
        return _mesh_run_blocks(sp, tokens.to(sp.first), cache, 0,
                                prompt=True)
    cache = KVCache.zeros(cfg, b, max_len, tokens.device)
    x = params["embed"].to(cfg.dtype)[tokens]
    return _run_blocks(params, x, cache, cfg, 0, prompt=True)


def decode_step(params: dict, cache, tokens: torch.Tensor,
                cfg: ModelConfig, mesh: Mesh | None = None):
    """One token per sequence: tokens [b] at position cache.length.
    Returns (logits [b, vocab] f32, cache advanced by one).  ``mesh``:
    as in :func:`prefill`, over its :class:`MeshKVCache`."""
    if cache.length >= cache.max_len:
        # A write past max_len has no slot to land in.
        raise ValueError(f"KV cache full: length {cache.length} >= max_len "
                         f"{cache.max_len}")
    if mesh is not None:
        sp = place_params(mesh, cfg, params)
        logits, cache = _mesh_run_blocks(sp, tokens.to(sp.first)[:, None],
                                         cache, cache.length)
        return logits[:, 0], cache
    x = params["embed"].to(cfg.dtype)[tokens][:, None, :]
    logits, cache = _run_blocks(params, x, cache, cfg, cache.length)
    return logits[:, 0], cache


def extend_step(params: dict, cache, tokens: torch.Tensor,
                cfg: ModelConfig, mesh: Mesh | None = None):
    """Append ``tokens`` [b, s] to the cache in ONE forward: returns
    (logits [b, s, vocab] f32 for every appended position, cache
    advanced by s).  The multi-token sibling of decode_step (the
    verification primitive of speculative decoding).  ``mesh``: as in
    :func:`prefill`."""
    if cache.length + tokens.shape[1] > cache.max_len:
        raise ValueError(
            f"KV cache overflow: length {cache.length} + {tokens.shape[1]} "
            f"> max_len {cache.max_len}")
    if mesh is not None:
        sp = place_params(mesh, cfg, params)
        return _mesh_run_blocks(sp, tokens.to(sp.first), cache, cache.length)
    x = params["embed"].to(cfg.dtype)[tokens]
    return _run_blocks(params, x, cache, cfg, cache.length)


def _rewind(cache, length: int):
    """Roll the logical length back (entries beyond ``length`` stay as
    garbage; the next write at ``length`` overwrites them before they
    can ever become visible)."""
    return dataclasses.replace(cache, length=int(length))


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


def _placed(params, cfg: ModelConfig, device, mesh: Mesh | None):
    """(params in the compute dtype on the device, or placed over
    ``mesh``; the device the call runs on: the mesh's first)."""
    if mesh is not None:
        sp = place_params(mesh, cfg, params)
        return sp, sp.first
    dev = resolve_device(device)
    return cast_params(params, cfg.dtype, dev), dev


def generate(params: dict, prompt, cfg: ModelConfig, steps: int, *,
             generator: torch.Generator | None = None,
             temperature: float = 0.0, top_k: int | None = None,
             top_p: float | None = None, max_len: int | None = None,
             device=None, mesh: Mesh | None = None) -> torch.Tensor:
    """Prefill the prompt [b, s], then decode ``steps`` tokens.  Returns
    [b, s + steps] (prompt + generated) on ``device``.  Greedy by
    default; pass a ``generator`` (on ``device``) and a temperature
    (and optionally top_k / top_p) to sample.

    Runs on CUDA unless ``device`` says otherwise; the params are cast
    to the compute dtype on the device once, for the whole call.
    ``mesh``: generate under it instead (params placed once,
    :func:`model.place_params`; see :func:`make_sharded_generate`): the
    logits of every step are gathered on the mesh's first device and
    sampled there from ``generator`` in the one-device order, so a
    sampled run equals the one-device run with the same generator."""
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
    vocab = cfg.vocab
    if top_k is not None and not 1 <= top_k <= vocab:
        raise ValueError(f"top_k must be in [1, {vocab}], got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    params, dev = _placed(params, cfg, device, mesh)
    prompt = torch.as_tensor(prompt, device=dev)
    logits, cache = prefill(params, prompt, cfg, max_len, mesh)
    out = torch.empty((b, steps), dtype=prompt.dtype, device=dev)
    token = _sample(logits[:, -1], generator, temperature, top_k, top_p)
    out[:, 0] = token
    # steps-1 decode steps: prefill already gave token 1 of ``steps``,
    # and the last token is emitted without a trailing decode of it.
    for i in range(1, steps):
        logits, cache = decode_step(params, cache, token, cfg, mesh)
        token = _sample(logits, generator, temperature, top_k, top_p)
        out[:, i] = token
    return torch.cat([prompt, out], dim=1)


def make_sharded_generate(mesh: Mesh, cfg: ModelConfig, steps: int, *,
                          temperature: float = 0.0,
                          top_k: int | None = None,
                          top_p: float | None = None,
                          max_len: int | None = None):
    """Build ``run(params, prompt, generator=None) -> tokens`` under the
    trainer's (data, model) mesh (:func:`model.make_mesh`): the
    checkpoint serves with the TP layout it trained with (each rank's
    blocks of :func:`model.param_specs`, placed once per call, or
    already placed with :func:`model.place_params`), the prompt rows cut
    over the data rows, and the cache over KV heads on 'model'
    (:class:`MeshKVCache`), so each shard reads only its slice of the
    cache; K1 and K3 run per shard.  Sampling draws from ``generator``
    on the mesh's first device, from the gathered logits."""

    def run(params, prompt, generator: torch.Generator | None = None):
        return generate(params, prompt, cfg, steps, generator=generator,
                        temperature=temperature, top_k=top_k, top_p=top_p,
                        max_len=max_len, mesh=mesh)

    return run


def _spec_setup(params, draft_params, prompt, cfg, draft_cfg, steps, k,
                max_len, device, mesh=None):
    """The speculative generators' shared checks and set-up: the
    params cast once on the device (or placed over ``mesh``), the
    prompt there, both caches prefilled.  Returns (params,
    draft_params, prompt, draft_cfg, target prompt logits, target
    cache, draft cache)."""
    if draft_cfg is None:
        draft_cfg = cfg
    b, s = prompt.shape
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    max_len = max_len if max_len is not None else s + steps
    if s + steps > max_len:
        raise ValueError(
            f"prompt {s} + steps {steps} exceeds max_len {max_len}")
    params, dev = _placed(params, cfg, device, mesh)
    draft_params, _ = _placed(draft_params, draft_cfg, dev, mesh)
    prompt = torch.as_tensor(prompt, device=dev)
    logits_t, cache_t = prefill(params, prompt, cfg, max_len, mesh)
    _, cache_d = prefill(draft_params, prompt, draft_cfg, max_len, mesh)
    return (params, draft_params, prompt, draft_cfg, logits_t, cache_t,
            cache_d)


def _spec_realign(draft_params, draft_cfg, cache_t, cache_d, out, n_out,
                  s, mesh=None):
    """After a round: rewind both caches to the confirmed stream (the
    prompt and every emitted token but the last, which the next round's
    block re-appends).  The draft wrote [cur, d1..d_{k-1}]: valid on
    the confirmed prefix, but when every draft was accepted the stream
    ran one token past what the draft ever wrote (d_k was computed,
    never cached), so that token is replayed through the draft."""
    confirmed = s + n_out - 1
    cache_t = _rewind(cache_t, confirmed)
    cache_d = _rewind(cache_d, min(cache_d.length, confirmed))
    behind = confirmed - cache_d.length
    if behind > 0:
        replay = out[:, n_out - behind - 1:n_out - 1]
        _, cache_d = extend_step(draft_params, cache_d, replay, draft_cfg,
                                 mesh)
    return cache_t, cache_d


def speculative_generate(params: dict, draft_params: dict, prompt,
                         cfg: ModelConfig, steps: int, *,
                         draft_cfg: ModelConfig | None = None, k: int = 4,
                         max_len: int | None = None, device=None,
                         mesh: Mesh | None = None):
    """Greedy speculative decoding: the DRAFT proposes ``k`` tokens
    autoregressively, the target scores all k in ONE cached forward
    (extend_step), and the longest prefix agreeing with the target's
    own greedy choices is accepted, plus one corrected token from the
    target's logits: every round emits between 1 and k+1 tokens for a
    single target pass.

    Every emitted token is the argmax of the target's verification
    logits, so the output is the target's greedy rollout; on the card
    those logits come from the einsum ``_cached_attention`` while plain
    ``generate`` reads its decode steps through the kernel, so a near
    tie can argmax differently there.

    Returns (tokens [b, prompt+steps], stats with ``rounds`` and
    ``accept_rate``).  Batched rows share each round's accepted length
    (the minimum over the rows) to keep one cache length.  Peak cache
    use is exactly ``prompt + steps``: the last round's draft is capped
    at the tokens still needed.  Runs on CUDA unless ``device`` says
    otherwise; ``mesh``: both models and caches under it, as in
    :func:`generate`."""
    (params, draft_params, prompt, draft_cfg, logits_t, cache_t,
     cache_d) = _spec_setup(params, draft_params, prompt, cfg, draft_cfg,
                            steps, k, max_len, device, mesh)
    b, s = prompt.shape
    out = torch.empty((b, steps), dtype=prompt.dtype, device=prompt.device)
    cur = torch.argmax(logits_t[:, -1], dim=-1).to(torch.int32)
    out[:, 0] = cur
    n_out = 1
    rounds = accepted_total = drafted_total = 0
    while n_out < steps:
        rounds += 1
        k_eff = min(k, steps - n_out)
        drafted_total += k_eff
        draft_toks = []
        tok_d = cur
        for _ in range(k_eff):
            dlogits, cache_d = decode_step(draft_params, cache_d, tok_d,
                                           draft_cfg, mesh)
            tok_d = torch.argmax(dlogits, dim=-1).to(torch.int32)
            draft_toks.append(tok_d)
        drafts = torch.stack(draft_toks, dim=1)            # [b, k_eff]
        # One target pass scores cur + the drafts: tlogits[:, i] is the
        # target's prediction after seeing cur, d1..di.
        block = torch.cat([cur[:, None], drafts], dim=1)
        tlogits, cache_t = extend_step(params, cache_t, block, cfg, mesh)
        targets = torch.argmax(tlogits, dim=-1).to(torch.int32)
        match = (drafts == targets[:, :k_eff]).cpu().numpy()
        # Accepted length shared across rows: the minimum over the batch.
        n_acc = int(min(int(np.argmin(row)) if not row.all() else k_eff
                        for row in match))
        accepted_total += n_acc
        m = min(n_acc + 1, steps - n_out)
        out[:, n_out:n_out + m] = targets[:, :m].to(out.dtype)
        n_out += m
        cur = targets[:, n_acc]
        cache_t, cache_d = _spec_realign(draft_params, draft_cfg, cache_t,
                                         cache_d, out, n_out, s, mesh)
    stats = {"rounds": rounds,
             "accept_rate": accepted_total / max(drafted_total, 1)}
    return torch.cat([prompt, out], dim=1), stats


def speculative_sample_generate(
        params: dict, draft_params: dict, prompt, cfg: ModelConfig,
        steps: int, *, generator: torch.Generator | None = None,
        temperature: float = 1.0, top_k: int | None = None,
        top_p: float | None = None, draft_cfg: ModelConfig | None = None,
        k: int = 4, max_len: int | None = None, device=None,
        mesh: Mesh | None = None):
    """Distribution-preserving speculative SAMPLING: the draft proposes
    x_i ~ q_i, the target scores all k proposals in ONE cached pass,
    and each x_i is accepted with probability min(1, p_i(x_i) /
    q_i(x_i)); the first rejection resamples from the residual
    norm(max(p_i - q_i, 0)) and ends the round.  The emitted stream is
    distributed exactly as sampling from the target alone, whatever the
    draft.  Temperature / top-k / top-p warp BOTH p and q through the
    same _warp_logits the plain sampler uses; temperature 0 delegates
    to the greedy speculative path.

    Batched rows accept or reject independently; the shared cache
    truncates every round at the batch's minimum accepted length (rows
    that accepted further emit their accepted token there, still a
    valid p-sample).  Draws come from ``generator`` (on the device),
    which sampling needs.

    Returns (tokens [b, prompt+steps], stats with ``rounds`` and
    ``accept_rate``, the per-row acceptance)."""
    if temperature == 0.0:
        if top_k is not None or top_p is not None:
            raise ValueError(
                "top_k/top_p require temperature > 0 (temperature 0 is "
                "greedy argmax; truncation would be silently ignored)")
        return speculative_generate(
            params, draft_params, prompt, cfg, steps, draft_cfg=draft_cfg,
            k=k, max_len=max_len, device=device, mesh=mesh)
    if generator is None:
        raise ValueError("sampling (temperature != 0) needs a "
                         "torch.Generator")
    (params, draft_params, prompt, draft_cfg, logits_t, cache_t,
     cache_d) = _spec_setup(params, draft_params, prompt, cfg, draft_cfg,
                            steps, k, max_len, device, mesh)
    b, s = prompt.shape

    def warped_probs(logits):
        return torch.softmax(_warp_logits(logits.float(), temperature,
                                          top_k, top_p), dim=-1)

    def draw(probs):
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
            torch.int32)

    out = torch.empty((b, steps), dtype=prompt.dtype, device=prompt.device)
    cur = _sample(logits_t[:, -1], generator, temperature, top_k, top_p)
    out[:, 0] = cur
    n_out = 1
    rounds = accepted_total = drafted_total = 0
    while n_out < steps:
        rounds += 1
        k_eff = min(k, steps - n_out)
        drafted_total += b * k_eff
        draft_toks, draft_q = [], []
        tok_d = cur
        for _ in range(k_eff):
            dlogits, cache_d = decode_step(draft_params, cache_d, tok_d,
                                           draft_cfg, mesh)
            q = warped_probs(dlogits)                      # [b, V]
            tok_d = draw(q)
            draft_toks.append(tok_d)
            draft_q.append(q)
        drafts = torch.stack(draft_toks, dim=1)            # [b, k_eff]
        qs = torch.stack(draft_q, dim=1)                   # [b, k_eff, V]
        block = torch.cat([cur[:, None], drafts], dim=1)
        tlogits, cache_t = extend_step(params, cache_t, block, cfg, mesh)
        ps = warped_probs(tlogits)                         # [b, k_eff+1, V]
        # Accept x_i with probability min(1, p_i(x)/q_i(x)); a row's
        # first rejection ends its accepted prefix.
        idx = drafts.long()[..., None]
        p_x = torch.gather(ps[:, :k_eff], -1, idx)[..., 0]
        q_x = torch.gather(qs, -1, idx)[..., 0]
        u = torch.rand(p_x.shape, generator=generator, device=p_x.device)
        accept = (u * q_x < p_x).cpu().numpy()             # [b, k_eff]
        acc_len = np.asarray([int(np.argmin(row)) if not row.all()
                              else k_eff for row in accept])
        n_acc = int(acc_len.min())
        # accept_rate is per-row acceptance (the economics signal); the
        # shared cache only truncates emission at the batch minimum.
        accepted_total += int(acc_len.sum())
        p_n = ps[:, n_acc]                                 # [b, V]
        if n_acc < k_eff:
            # Rejected rows draw from the residual; rows that accepted
            # past the truncation point emit their accepted draft.  A
            # zero residual (p == q) only arises where acceptance was
            # certain; the p fallback keeps the draw well-defined.
            residual = torch.clamp_min(p_n - qs[:, n_acc], 0.0)
            rsum = residual.sum(dim=-1, keepdim=True)
            residual = torch.where(rsum > 0, residual / rsum, p_n)
            res_tok = draw(residual)
            rejected_here = torch.from_numpy(acc_len == n_acc).to(
                res_tok.device)
            bonus = torch.where(rejected_here, res_tok, drafts[:, n_acc])
        else:
            # Every row accepted the whole block: the (k+1)-th logits
            # row is a fresh target sample past the last draft.
            bonus = draw(p_n)
        emit = torch.cat([drafts[:, :n_acc], bonus[:, None]], dim=1)
        m = min(n_acc + 1, steps - n_out)
        out[:, n_out:n_out + m] = emit[:, :m].to(out.dtype)
        n_out += m
        cur = out[:, n_out - 1].to(torch.int32)
        cache_t, cache_d = _spec_realign(draft_params, draft_cfg, cache_t,
                                         cache_d, out, n_out, s, mesh)
    stats = {"rounds": rounds,
             "accept_rate": accepted_total / max(drafted_total, 1)}
    return torch.cat([prompt, out], dim=1), stats
