"""Continuous-batching serving engine: slot KV cache + chunked prefill.

The PyTorch counterpart of the JAX package's ``workloads/serving.py``,
on one device or under a (data, model) mesh (``mesh=``):

- **SlotKVCache**: a fixed pool of ``slots`` sequences, each with its
  own cache region and its own ``length``; mixed-length sequences
  decode together in ONE batched step, whose cache read is the
  ``flash_decode`` CUDA kernel with per-row lengths on a CUDA device.
- **admit/evict**: a finished sequence frees its slot and the next
  request takes it over; the slot is reset by writing its length to 0.
- **chunked prefill**: prompts enter the cache in fixed-size chunks,
  one per engine tick, interleaved with decode steps.

PyTorch runs eagerly, so the step functions update the cache in place
(the JAX versions return a new cache); they still return the cache so
the call sites read like the JAX engine's.  Shapes stay fixed: which
slot and how many valid tokens are data, as in the JAX engine.

Under a mesh the params are placed once per rank (``model.place_params``)
and every layer runs tensor-parallel (``model.tp_blocks``); the cache
is a :class:`MeshSlotKVCache`, the slots cut over the data rows and the
KV heads over 'model'.  The decode step runs K3 once per (data row,
model rank) shard with that row's lengths; the prefill chunk runs on
its slot's data row only, on the einsum, as in the JAX engine; the
logits come back gathered on the engine's first device, where the host
sampling is unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_autoscaler_torch.obs.trace import maybe_span
from tpu_autoscaler_torch.serving.stats import (
    ServingSnapshot,
    ServingStatsRecorder,
)
from tpu_autoscaler_torch.workloads.attention import flash_decode
from tpu_autoscaler_torch.workloads.decode import _sample
from tpu_autoscaler_torch.workloads.model import (
    Mesh,
    ModelConfig,
    TPParams,
    _PerDevice,
    _ffn_residual,
    _rmsnorm,
    _rope_tables,
    _rotate,
    _split_qkv,
    cast_params,
    kv_gather,
    kv_zeros,
    place_params,
    resolve_device,
    tp_blocks,
    tp_embed,
    tp_logits,
)


@dataclasses.dataclass
class SlotKVCache:
    """Per-slot KV cache: k, v [layers, slots, kv_heads, max_len,
    head_dim]; lengths [slots] int32 — slot s holds a sequence whose
    first ``lengths[s]`` positions are live.  Admission resets a slot
    by writing 0 (stale K/V beyond every write point is never visible —
    writes always start exactly at the slot's current length)."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor

    @property
    def slots(self) -> int:
        return self.k.shape[1]

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    @classmethod
    def zeros(cls, cfg: ModelConfig, slots: int, max_len: int,
              device) -> "SlotKVCache":
        shape = (cfg.n_layers, slots, cfg.kv_heads, max_len, cfg.head_dim)
        return cls(k=torch.zeros(shape, dtype=cfg.dtype, device=device),
                   v=torch.zeros(shape, dtype=cfg.dtype, device=device),
                   lengths=torch.zeros((slots,), dtype=torch.int32,
                                       device=device))

    def reset(self, slot: int) -> None:
        """Admission: the slot's length back to 0."""
        self.lengths[slot] = 0


@dataclasses.dataclass
class MeshSlotKVCache:
    """A :class:`SlotKVCache` cut over a mesh's (data row, model rank)
    shards: ``k[i][n]``, ``v[i][n]`` [layers, slots/dp, kv_heads/tp,
    max_len, head_dim] on rank (i, n)'s device when the heads divide
    over the ranks (one shard of whole heads on the row's first rank
    otherwise), each a tensor of its own; ``lengths[i]`` [slots/dp]
    int32 on the row's first rank.  Slot s is row ``s // (slots/dp)``'s
    local slot ``s % (slots/dp)``."""

    k: list
    v: list
    lengths: list

    @property
    def row_slots(self) -> int:
        return self.k[0][0].shape[1]

    @property
    def slots(self) -> int:
        return self.row_slots * len(self.k)

    @property
    def max_len(self) -> int:
        return self.k[0][0].shape[3]

    @classmethod
    def zeros(cls, sp: TPParams, slots: int,
              max_len: int) -> "MeshSlotKVCache":
        """The JAX engine's slot sharding needs the slots to divide over
        the data rows (its jit refuses the cache otherwise); so does
        this one, with the same words."""
        cfg, rows = sp.cfg, sp.rows
        dp = len(rows)
        if slots % dp:
            raise ValueError(
                f"slots {slots} shard over the {dp} data rows of mesh "
                f"{dict(sp.mesh.shape)}, which implies that the global size "
                f"of the slot dimension should be divisible by {dp}, but it "
                f"is equal to {slots}")
        lead, tail = (cfg.n_layers, slots // dp), (max_len, cfg.head_dim)
        return cls(k=[kv_zeros(sp, row, lead, tail) for row in rows],
                   v=[kv_zeros(sp, row, lead, tail) for row in rows],
                   lengths=[torch.zeros((slots // dp,), dtype=torch.int32,
                                        device=row[0]) for row in rows])

    def locate(self, slot: int) -> tuple[int, int]:
        """(data row, local slot) of ``slot``."""
        return divmod(int(slot), self.row_slots)

    def reset(self, slot: int) -> None:
        i, local = self.locate(slot)
        self.lengths[i][local] = 0

    def gather(self, device=None) -> SlotKVCache:
        """The whole cache in the one-device layout on ``device``
        (default: the first shard's)."""
        dev = self.k[0][0].device if device is None else device
        return SlotKVCache(k=kv_gather(self.k, dev), v=kv_gather(self.v, dev),
                           lengths=torch.cat([n.to(dev)
                                              for n in self.lengths]))


def _row_rope_tables(positions: torch.Tensor, s: int, head_dim: int,
                     theta: float, dtype: torch.dtype, yarn=None):
    """cos, sin [b, 1, s, head_dim/2] for rows starting at per-row
    ``positions`` [b]; shared by every layer's q and k in a step (by
    every layer of one kind, ``yarn`` its :class:`model.Yarn`)."""
    pos = positions[:, None].float() + torch.arange(
        s, dtype=torch.float32, device=positions.device)[None, :]
    cos, sin = _rope_tables(pos, head_dim, theta, dtype, yarn)
    return cos[:, None], sin[:, None]


def _rope_rows(x: torch.Tensor, theta: float, positions: torch.Tensor):
    """RoPE with a PER-ROW position: x [b, h, s, hd], positions [b]
    (each row's absolute offset; within-row positions increment)."""
    return _rotate(x, *_row_rope_tables(positions, x.shape[2], x.shape[3],
                                        theta, x.dtype))


def _slot_cached_attention(q, k_cache, v_cache, lengths, cfg: ModelConfig):
    """Per-row-length cached attention (einsum path): q [b, h, 1, hd]
    at absolute positions ``lengths - 1``; row b sees cache slots
    j <= lengths[b]-1 (and within the window)."""
    b, h, sq, hd = q.shape
    hkv = k_cache.shape[1]
    max_len = k_cache.shape[2]
    qg = q.reshape(b, hkv, h // hkv, sq, hd)
    scores = torch.einsum("bngqd,bnkd->bngqk", qg, k_cache) * hd ** -0.5
    kpos = torch.arange(max_len, device=q.device)
    qpos = (lengths - 1)[:, None]                          # [b, 1]
    visible = kpos[None, :] <= qpos                        # [b, max_len]
    if cfg.attention_window is not None:
        visible &= kpos[None, :] > qpos - cfg.attention_window
    scores = torch.where(visible[:, None, None, None], scores.float(),
                         -1e30)
    probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
    out = torch.einsum("bngqk,bnkd->bngqd", probs, v_cache)
    return out.reshape(b, h, sq, hd)


def _row_index(positions, s: int, max_len: int):
    """(rows, cols) [b, s] addressing s entries per row from per-row
    offsets.  Offsets clamp so the write fits, as
    ``dynamic_update_slice`` does in the JAX engine."""
    b = positions.shape[0]
    start = positions.long().clamp(0, max_len - s)
    cols = start[:, None] + torch.arange(s, device=positions.device)
    rows = torch.arange(b, device=positions.device)[:, None].expand(b, s)
    return rows, cols


def _write_rows(cache, new, index):
    """Write new [b, hkv, s, hd] into cache [b, hkv, max_len, hd] at
    ``index = _row_index(...)``, in place."""
    rows, cols = index
    cache[rows, :, cols] = new.transpose(1, 2)
    return cache


def _ring_abs_pos(lengths, ring: int):
    """Absolute sequence position held by each ring slot, per row.

    Slot j of a row at logical length L holds the LARGEST position
    p ≡ j (mod ring) with p <= L-1: p = (L-1) - ((L-1-j) mod ring).
    Slots never written (L < ring) come out negative — mask on >= 0.
    Returns [rows, ring]."""
    j = torch.arange(ring, device=lengths.device)[None, :]
    last = (lengths - 1)[:, None]
    return last - torch.remainder(last - j, ring)


def _slot_ring_attention(q, k_cache, v_cache, lengths, cfg: ModelConfig,
                         window: int):
    """_slot_cached_attention over a RING buffer: each slot's absolute
    position is recovered from the row's logical length, and
    visibility is the same causal+window rule on absolute positions."""
    b, h, sq, hd = q.shape
    hkv = k_cache.shape[1]
    ring = k_cache.shape[2]
    qg = q.reshape(b, hkv, h // hkv, sq, hd)
    scores = torch.einsum("bngqd,bnkd->bngqk", qg, k_cache) * hd ** -0.5
    abs_pos = _ring_abs_pos(lengths, ring)                 # [b, ring]
    qpos = (lengths - 1)[:, None]
    visible = (abs_pos >= 0) & (abs_pos <= qpos) & (abs_pos > qpos - window)
    scores = torch.where(visible[:, None, None, None], scores.float(),
                         -1e30)
    probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
    out = torch.einsum("bngqk,bnkd->bngqd", probs, v_cache)
    return out.reshape(b, h, sq, hd)


def _slot_attend(q, k_c, v_c, new_len, cfg: ModelConfig,
                 ring: bool = False):
    """The cache read for one slot-decode layer: the flash_decode
    kernel with per-row lengths when the config resolves to it on q's
    device, the per-row einsum mask otherwise.  ``ring`` selects the
    ring-layout mask on both paths."""
    if cfg.resolved_attention(q.device) == "kernel":
        return flash_decode(q.contiguous(), k_c, v_c, new_len,
                            window=cfg.attention_window, ring=ring)
    if ring:
        return _slot_ring_attention(q, k_c, v_c, new_len, cfg,
                                    cfg.attention_window)
    return _slot_cached_attention(q, k_c, v_c, new_len, cfg)


def _layer(params: dict, i: int) -> dict:
    return {name: w[i] for name, w in params["blocks"].items()}


def _mesh_slot_decode_step(cfg: ModelConfig, ring: bool):
    """:func:`make_slot_decode_step` over a :class:`MeshSlotKVCache`
    with params placed by :func:`model.place_params`: each data row
    decodes its slots, K3 (or the einsum) once per (row, rank) shard
    with the row's lengths; the logits are gathered on the first
    device."""

    def step(sp: TPParams, cache: MeshSlotKVCache, tokens, active):
        per, width = cache.row_slots, cache.max_len
        rows = list(range(len(sp.rows)))
        tokens = tokens.to(sp.first).split(per)
        active = active.to(sp.first).split(per)
        xs = tp_embed(sp, [t[:, None] for t in tokens], rows)
        on = _PerDevice()

        def positions(i, dev):
            return on(("pos", i), dev, lambda d: cache.lengths[i].to(d))

        rope = None
        if cfg.rope:
            def rope(t, i):
                return _rotate(t, *on(("rope", i), t.device, lambda d: (
                    _row_rope_tables(positions(i, d), 1, cfg.head_dim,
                                     cfg.rope_theta, cfg.dtype))))

        def attend(layer, i, j, q, k, v):
            n, dev = (0 if j is None else j), q.device
            k_c, v_c = cache.k[i][n][layer], cache.v[i][n][layer]
            index = on(("index", i), dev, lambda d: _row_index(
                positions(i, d) % width if ring else positions(i, d), 1,
                width))
            _write_rows(k_c, k, index)
            _write_rows(v_c, v, index)
            new_len = on(("new_len", i), dev, lambda d: positions(i, d) + 1)
            return _slot_attend(q, k_c, v_c, new_len, cfg, ring=ring)

        xs = tp_blocks(sp, xs, rows, rope, attend)
        logits = tp_logits(sp, xs, rows)
        for n, a in zip(cache.lengths, active):
            n += a.to(device=n.device, dtype=torch.int32)
        return logits[:, 0], cache

    return step


def make_slot_decode_step(cfg: ModelConfig, ring: bool = False,
                          mesh: Mesh | None = None):
    """Build ``step(params, cache, tokens, active) -> (logits, cache)``:
    one token for EVERY slot in one batched step — slot s's token sits
    at its own position ``cache.lengths[s]``.  ``active`` [slots] bool
    marks the slots that really decode this tick: inactive slots
    compute values the engine ignores, and their lengths do NOT
    advance, so the K/V they wrote is overwritten by their next real
    write.

    tokens: [slots] int.  Returns logits [slots, vocab] f32 and the
    cache, updated in place with active lengths advanced by 1.

    ``ring=True`` (requires cfg.attention_window): the cache is a ring
    over its buffer width — writes land at position % width and each
    slot's absolute position is recovered from the row's logical
    length, so per-slot memory is O(window) instead of O(sequence).

    ``mesh``: the step takes params placed over it
    (:func:`model.place_params`) and a :class:`MeshSlotKVCache`; K3 runs
    once per (data row, model rank) shard.
    """
    cfg.require_uniform("the slot engines")
    if ring and cfg.attention_window is None:
        raise ValueError("ring=True needs cfg.attention_window (the "
                         "ring holds exactly the window of live keys)")
    if mesh is not None:
        return _mesh_slot_decode_step(cfg.resolved_for_mesh(mesh), ring)

    def step(params, cache: SlotKVCache, tokens, active):
        x = params["embed"].to(cfg.dtype)[tokens][:, None, :]
        positions = cache.lengths
        new_len = positions + 1
        b, s, d = x.shape
        # Per-step values every layer shares, computed once: the write
        # index and the rope tables.
        index = _row_index(positions % cache.max_len if ring else positions,
                           s, cache.max_len)
        if cfg.rope:
            rope = _row_rope_tables(positions, s, cfg.head_dim,
                                    cfg.rope_theta, cfg.dtype)
        for i in range(cfg.n_layers):
            layer = _layer(params, i)
            k_c, v_c = cache.k[i], cache.v[i]
            y = _rmsnorm(x, layer["ln1"])
            q, k, v = _split_qkv(y, layer["qkv"], cfg)
            if cfg.rope:
                q, k = _rotate(q, *rope), _rotate(k, *rope)
            _write_rows(k_c, k, index)
            _write_rows(v_c, v, index)
            attn = _slot_attend(q, k_c, v_c, new_len, cfg, ring=ring)
            attn = attn.transpose(1, 2).reshape(b, s, d)
            x = x + attn @ layer["attn_out"].to(cfg.dtype)
            y = _rmsnorm(x, layer["ln2"])
            x = _ffn_residual(x, y, layer, cfg)
        x = _rmsnorm(x, params["ln_f"])
        logits = x @ params["unembed"].to(cfg.dtype)
        cache.lengths += active.to(torch.int32)
        return logits[:, 0].float(), cache

    return step


def _chunk_visibility(cfg: ModelConfig, offset, s: int, n_valid: int,
                      width: int, ring: bool):
    """Where one slot's prefill chunk writes and what its queries see:
    (write positions, visible [s, width] bool, lanes written), on the
    offset's device.  Linear: all ``s`` lanes at the offset (clamped to
    fit); ring: the ``n_valid`` lanes at position % width, visibility on
    absolute positions."""
    dev = offset.device
    lane = torch.arange(s, device=dev)
    qpos = offset + lane
    if ring:
        write_at = (offset + lane[:n_valid]) % width
        abs_pos = _ring_abs_pos((offset + n_valid)[None], width)[0]
        visible = (abs_pos[None, :] >= 0) \
            & (abs_pos[None, :] <= qpos[:, None]) \
            & (abs_pos[None, :] > qpos[:, None] - cfg.attention_window)
        return write_at, visible, n_valid
    write_at = offset.clamp(0, width - s) + lane
    kpos = torch.arange(width, device=dev)
    visible = kpos[None, :] <= qpos[:, None]
    if cfg.attention_window is not None:
        visible &= kpos[None, :] > qpos[:, None] - cfg.attention_window
    return write_at, visible, s


def _chunk_attend(q, k, v, kc, vc, write_at, visible, n_write: int,
                  cfg: ModelConfig):
    """One slot's chunk attention over its cache kc/vc [hkv, width, hd]:
    write the chunk's k/v [1, hkv, s, hd] (its first ``n_write`` lanes)
    in place, then the grouped einsum over the slot, masked by
    ``visible``.  Returns [1, h, s, hd]; h and hkv are whatever q and
    the cache hold (a model rank's heads under a mesh)."""
    _, h, s, hd = q.shape
    hkv = kc.shape[0]
    kc[:, write_at] = k[0, :, :n_write]
    vc[:, write_at] = v[0, :, :n_write]
    qg = q.reshape(1, hkv, h // hkv, s, hd)
    scores = torch.einsum("bngqd,bnkd->bngqk", qg, kc[None]) * hd ** -0.5
    scores = torch.where(visible, scores.float(), -1e30)
    probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
    attn = torch.einsum("bngqk,bnkd->bngqd", probs, vc[None])
    return attn.reshape(1, h, s, hd)


def _mesh_prefill_chunk(cfg: ModelConfig, ring: bool):
    """:func:`make_prefill_chunk` over a :class:`MeshSlotKVCache`: the
    chunk runs on its slot's data row only, each of the row's shards
    writing and attending over its heads of the slot (the einsum)."""

    def fill(sp: TPParams, cache: MeshSlotKVCache, slot: int, tokens,
             n_valid: int):
        i, local = cache.locate(slot)
        head = sp.rows[i][0]
        (x,) = tp_embed(sp, [tokens.to(head)[None]], [i])
        s, width = x.shape[1], cache.max_len
        offset = cache.lengths[i][local]
        on = _PerDevice()

        def where(dev):
            return on("where", dev, lambda d: _chunk_visibility(
                cfg, offset.to(d), s, n_valid, width, ring))

        rope = None
        if cfg.rope:
            def rope(t, i):
                return _rotate(t, *on("rope", t.device, lambda d: (
                    _rope_tables((offset.to(d) + torch.arange(s, device=d))
                                 .float(), cfg.head_dim, cfg.rope_theta,
                                 cfg.dtype))))

        def attend(layer, i, j, q, k, v):
            n = 0 if j is None else j
            return _chunk_attend(q, k, v, cache.k[i][n][layer, local],
                                 cache.v[i][n][layer, local],
                                 *where(q.device), cfg)

        (x,) = tp_blocks(sp, [x], [i], rope, attend)
        logits = tp_logits(sp, [x[:, n_valid - 1]], [i])[0]
        cache.lengths[i][local] += n_valid
        return logits, cache

    return fill


def make_prefill_chunk(cfg: ModelConfig, chunk: int, ring: bool = False,
                       mesh: Mesh | None = None):
    """Build ``fill(params, cache, slot, tokens, n_valid) -> (logits,
    cache)``: append ``n_valid`` (<= chunk) prompt tokens to ONE slot's
    cache at its current length.  tokens: [chunk] int (padded past
    n_valid).  Returns the last VALID position's logits [vocab] f32 —
    the seed of generation when this was the prompt's final chunk.

    Linear cache: all ``chunk`` lanes are written at the offset (the
    pad lanes' K/V is overwritten by the next write before it is ever
    visible; ``submit`` guarantees the chunk fits).  ``ring=True``: the
    buffer width must be >= cfg.attention_window + chunk; only the
    ``n_valid`` lanes scatter, at position % width — a pad write would
    displace a live key.  Visibility runs on absolute positions.

    ``mesh``: as in :func:`make_slot_decode_step`; the chunk runs on its
    slot's data row.
    """
    cfg.require_uniform("the slot engines")
    if ring and cfg.attention_window is None:
        raise ValueError("ring=True needs cfg.attention_window")
    if mesh is not None:
        return _mesh_prefill_chunk(cfg.resolved_for_mesh(mesh), ring)

    def fill(params, cache: SlotKVCache, slot: int, tokens, n_valid: int):
        x = params["embed"].to(cfg.dtype)[tokens][None]   # [1, chunk, d]
        _, s, d = x.shape
        offset = cache.lengths[slot]                       # 0-d tensor
        where = _chunk_visibility(cfg, offset, s, n_valid, cache.max_len,
                                  ring)
        if cfg.rope:
            rope = _rope_tables(
                (offset + torch.arange(s, device=x.device)).float(),
                cfg.head_dim, cfg.rope_theta, cfg.dtype)
        for i in range(cfg.n_layers):
            layer = _layer(params, i)
            y = _rmsnorm(x, layer["ln1"])
            q, k, v = _split_qkv(y, layer["qkv"], cfg)
            if cfg.rope:
                q, k = _rotate(q, *rope), _rotate(k, *rope)
            # Attend over this slot's cache: causal within the chunk,
            # plus everything before the offset.
            attn = _chunk_attend(q, k, v, cache.k[i, slot],
                                 cache.v[i, slot], *where, cfg)
            attn = attn.transpose(1, 2).reshape(1, s, d)
            x = x + attn @ layer["attn_out"].to(cfg.dtype)
            y = _rmsnorm(x, layer["ln2"])
            x = _ffn_residual(x, y, layer, cfg)
        # Only the last valid row's logits are returned; rmsnorm and
        # the unembedding are per-row, so computing just that row gives
        # the same numbers.
        last = _rmsnorm(x[0, n_valid - 1], params["ln_f"])
        logits = last @ params["unembed"].to(cfg.dtype)
        cache.lengths[slot] += n_valid
        return logits.float(), cache

    return fill


@dataclasses.dataclass
class Request:
    """One generation request for the engine.  Sampling knobs are
    PER-REQUEST, so mixed greedy/sampled traffic batches together."""

    prompt: np.ndarray                   # [len] int32
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int | None = None
    top_p: float | None = None
    eos_id: int | None = None
    # Filled by the engine:
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False
    # Engine ticks at submission/completion (stats: latency in ticks).
    submitted_tick: int | None = None
    finished_tick: int | None = None
    # Queue-wait/execute split: first tick the request held a slot.
    first_scheduled_tick: int | None = None
    # Engine-assigned id ("r1", "r2", ...), kept across preemptions.
    request_id: str | None = None
    # Last tick a paged engine preempted it (its requeue wait starts).
    preempted_tick: int | None = None


@dataclasses.dataclass
class _PromptWait:
    """A traced request's way to its first token, on the tracer's clock:
    when it was submitted and first admitted, the wall time of the ticks
    in which it held unprefilled prompt without a prefill lane, and the
    chunks prefilled for it."""

    submitted: float
    admitted: float | None = None
    lane_wait_s: float = 0.0
    chunks: int = 0


@dataclasses.dataclass
class _SlotState:
    request: Request | None = None
    remaining_prompt: np.ndarray | None = None
    # The prompt is fully in the cache and generation has its first token.
    seeded: bool = False


class ContinuousBatcher:
    """Host-side scheduler over the slot step functions.

    Admission: a FREE slot takes the next queued request and prefills
    its prompt one chunk per tick.  Every tick also runs ONE batched
    decode step for all slots holding live generations.  Eviction: a
    sequence that hits max_new_tokens (or eos) frees its slot on the
    spot — the next request is admitted the next tick.  Shapes never
    change; slot occupancy is pure data.

    With a tracer (``tracer=``) every :meth:`tick` is one span tree, on
    the tracer's clock (profiler ranges too, while a profiler records)::

        serve.tick           attrs: tick, decode_rows, prefill_lanes,
        │                           prompt_tokens
        ├─ serve.admit
        ├─ serve.prefill.plan     lane choice (paged: block growth,
        │                         preemption, the host arrays)
        ├─ serve.prefill.step     the call into the prefill step
        │  └─ serve.prefill.inputs  (paged) its inputs to the device
        ├─ serve.prefill.sample   seeding the lanes whose prompt ended
        │  └─ serve.sync            waiting for the logits
        ├─ serve.decode.plan      (paged) block growth
        ├─ serve.decode.step      the call into the decode step (paged:
        │  │                      attr graph, whether it replayed)
        │  └─ serve.decode.inputs   (paged) its inputs to the device
        ├─ serve.decode.sample    sampling, bookkeeping, finishing
        │  └─ serve.sync            the sampled tokens to the host
        └─ serve.stats            closing the stats tick

    and each request's first token closes a root span
    ``serve.request.prefill`` from its submission, with attrs
    ``queue_s`` (submission to first admission), ``lane_wait_s`` (the
    wall time of the ticks in which it held unprefilled prompt without
    a lane) and ``chunks``.  The speculative engine's own decode phase
    and the mesh step functions are not split.
    """

    def __init__(self, params, cfg: ModelConfig, *, slots: int = 4,
                 max_len: int = 256, chunk: int = 32, device=None,
                 generator: torch.Generator | None = None,
                 ring: bool = False, slo_ticks: int | None = None,
                 reqtrace=None, mesh: Mesh | None = None, tracer=None):
        """``device``: where the engine runs, CUDA unless the caller
        asks for the CPU (``device='cpu'``).  ``generator``: the
        sampling generator, on ``device`` (default: seeded with 0).

        ``mesh`` (:func:`model.make_mesh`): serve under it instead of on
        ``device``.  The params are placed once, here, as each rank's
        compute-dtype blocks on its own device
        (:func:`model.place_params`, the JAX engine's re-placement onto
        ``param_specs``); the engine's device is the mesh's first, where
        tokens enter, logits leave and the generator draws.

        ``ring=True`` (needs cfg.attention_window): per-slot cache
        memory becomes O(window + chunk) instead of O(max_len), and
        sequences may run PAST max_len — max_len then only bounds the
        per-request budget check, not the buffer.

        ``slo_ticks``: completions within this many engine ticks of
        submission count as SLO-attained in ``stats()``.

        ``reqtrace``: an optional
        :class:`~tpu_autoscaler_torch.serving.reqtrace.RequestTraceSampler`,
        sampled per-request span trees built from the host-side
        bookkeeping this scheduler already does (submit, admit, seeded,
        preempt, finish); None costs one ``if`` per event.

        ``tracer``: an optional :class:`~tpu_autoscaler_torch.obs.trace.
        Tracer` for the tick's span tree (class docstring); None costs
        one ``if`` per seam."""
        self._tracer = tracer
        # Traced only: each unseeded request's way to its first token,
        # and the ones waiting for a lane in the current tick.
        self._prompt_waits: dict[str, _PromptWait] = {}
        self._lane_waiting: list[_PromptWait] = []
        self.mesh = mesh
        if mesh is not None:
            self.params = place_params(mesh, cfg, params)
            self.device = self.params.first
        else:
            self.device = resolve_device(device)
            # One compute-dtype copy of the params for the engine's
            # lifetime.  The JAX step casts every f32 master param on
            # each call; this gives the same numbers without re-reading
            # 4-byte weights every tick.
            self.params = cast_params(params, cfg.dtype, self.device)
        self.cfg = cfg
        self.chunk = chunk
        self.max_len = max_len
        self.ring = ring
        self._build_device_state(cfg, slots, max_len, chunk, ring)
        self._slots = [_SlotState() for _ in range(slots)]
        self._queue: list[Request] = []
        self._pending_token = np.zeros((slots,), np.int64)
        self._has_pending = np.zeros((slots,), bool)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self._gen = generator
        self.ticks = 0
        self.decode_steps = 0
        self.decode_tokens = 0
        self.prefill_chunks = 0
        self.prefill_tokens = 0
        self.draining = False
        # Signal export: host-side numpy rings.  _stat_lengths mirrors
        # cache.lengths host-side so KV occupancy never reads the device.
        self._stats = ServingStatsRecorder(slots, slo_ticks=slo_ticks)
        self._stat_lengths = np.zeros(slots, np.int64)
        # Request-trace sampler: wired to this recorder so promotion
        # counters and exemplars ride the snapshot export.
        self._reqtrace = reqtrace
        if reqtrace is not None and reqtrace.stats is None:
            reqtrace.stats = self._stats
        self._rid_seq = 0

    def _build_device_state(self, cfg, slots, max_len, chunk, ring) -> None:
        """Allocate the cache and build the step functions.  A subclass
        with another memory system (paged.PagedBatcher) overrides this;
        the host-side scheduling is shared."""
        if ring:
            if cfg.attention_window is None:
                raise ValueError("ring=True needs cfg.attention_window")
            buf_len = cfg.attention_window + chunk
        else:
            buf_len = max_len
        if self.mesh is not None:
            self.cache = MeshSlotKVCache.zeros(self.params, slots, buf_len)
        else:
            self.cache = SlotKVCache.zeros(cfg, slots, buf_len, self.device)
        self._decode = make_slot_decode_step(cfg, ring=ring, mesh=self.mesh)
        self._prefill = make_prefill_chunk(cfg, chunk, ring=ring,
                                           mesh=self.mesh)

    def submit(self, request: Request) -> None:
        """Queue a request, validating its cache footprint UP FRONT —
        an oversized request would write past its slot's cache."""
        plen = len(request.prompt)
        if plen < 1:
            raise ValueError("empty prompt (the engine seeds generation "
                             "from the prompt's last logits)")
        if request.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got "
                f"{request.max_new_tokens}")
        if request.temperature == 0.0 and (
                request.top_k is not None or request.top_p is not None):
            raise ValueError(
                "top_k/top_p require temperature > 0 (temperature 0 is "
                "greedy argmax; truncation would be silently ignored)")
        if request.top_p is not None and not 0.0 < request.top_p <= 1.0:
            raise ValueError(
                f"top_p must be in (0, 1], got {request.top_p}")
        if request.top_k is not None and request.top_k < 1:
            raise ValueError(
                f"top_k must be >= 1, got {request.top_k}")
        # Prefill writes chunk-wide blocks: the last chunk's write must
        # fit below max_len even though only n_valid entries are real.
        padded = int(np.ceil(plen / self.chunk) * self.chunk)
        need = max(padded, plen + request.max_new_tokens)
        if need > self.max_len:
            raise ValueError(
                f"request needs {need} cache slots (prompt {plen} "
                f"padded to chunk {self.chunk} multiples, + "
                f"{request.max_new_tokens} new tokens) but max_len is "
                f"{self.max_len}")
        if request.submitted_tick is None:
            request.submitted_tick = self.ticks
        if request.request_id is None:
            self._rid_seq += 1
            request.request_id = f"r{self._rid_seq}"
        if self._reqtrace is not None:
            self._reqtrace.note_submit(request.request_id, self.ticks)
        if self._tracer is not None:
            self._prompt_waits.setdefault(
                request.request_id, _PromptWait(self._tracer.clock()))
        self._queue.append(request)

    @property
    def idle(self) -> bool:
        return not self._queue and all(
            s.request is None for s in self._slots)

    def _note_admitted(self, req: Request) -> None:
        """Wait-split and trace bookkeeping for one admission, shared
        by every engine's ``_admit``: the first admission closes the
        submit→schedule wait, a re-admission closes a preemption's
        requeue wait."""
        if req.first_scheduled_tick is None:
            req.first_scheduled_tick = self.ticks
            self._stats.note_first_scheduled(
                self.ticks - (req.submitted_tick or 0))
        elif req.preempted_tick is not None:
            self._stats.note_requeue_wait(self.ticks - req.preempted_tick)
        if self._reqtrace is not None and req.request_id is not None:
            self._reqtrace.note_admit(req.request_id, self.ticks)
        if self._tracer is not None:
            wait = self._prompt_waits.get(req.request_id)
            if wait is not None and wait.admitted is None:
                wait.admitted = self._tracer.clock()

    def _note_seeded(self, i: int, tok: int) -> None:
        """Slot i's prompt is fully in the cache and ``tok``, sampled
        from its last logits, is the first generated token: it becomes
        the slot's pending decode input."""
        slot = self._slots[i]
        slot.request.generated.append(tok)
        slot.seeded = True
        self._pending_token[i] = tok
        self._has_pending[i] = True
        if self._reqtrace is not None \
                and slot.request.request_id is not None:
            self._reqtrace.note_seeded(slot.request.request_id, self.ticks)
        if self._tracer is not None:
            self._record_prompt_wait(slot.request)

    def _record_prompt_wait(self, req: Request) -> None:
        """The ``serve.request.prefill`` span of a request just seeded:
        a root span of its own, from its submission to now."""
        wait = self._prompt_waits.pop(req.request_id, None)
        if wait is None:
            return
        tracer = self._tracer
        with tracer.use(None):
            tracer.record("serve.request.prefill", start=wait.submitted,
                          end=tracer.clock(), attrs={
                              "queue_s": wait.admitted - wait.submitted,
                              "lane_wait_s": wait.lane_wait_s,
                              "chunks": wait.chunks})

    def _note_lanes(self, lanes: list[int]) -> None:
        """Traced prefill bookkeeping, before the call: a chunk for each
        lane's request; every other slot holding unprefilled prompt
        waits out this tick (see :meth:`_close_tick`)."""
        self._lane_waiting = []
        for i, slot in enumerate(self._slots):
            if slot.request is None or slot.remaining_prompt is None \
                    or len(slot.remaining_prompt) == 0:
                continue
            wait = self._prompt_waits.get(slot.request.request_id)
            if wait is None:
                continue
            if i in lanes:
                wait.chunks += 1
            else:
                self._lane_waiting.append(wait)

    def _trace_finish_attrs(self, req: Request) -> dict:
        """Extra root-span attrs for a finished request's trace (the
        speculative engine annotates its accept economics here)."""
        del req
        return {}

    def _admit(self) -> None:
        if self.draining:
            return
        for i, slot in enumerate(self._slots):
            if slot.request is None and self._queue:
                req = self._queue.pop(0)
                slot.request = req
                slot.remaining_prompt = np.asarray(req.prompt, np.int64)
                slot.seeded = False
                self._has_pending[i] = False
                self._stats.note_admit()
                self._note_admitted(req)
                self._stat_lengths[i] = 0
                # Reset the slot: stale cache beyond every future write
                # point is invisible by construction.
                self.cache.reset(i)

    def _sample_host(self, logits, req: Request) -> int:
        tok = _sample(logits, self._gen, req.temperature, req.top_k,
                      req.top_p)
        with maybe_span(self._tracer, "serve.sync"):
            return int(tok)

    def _batch_sample(self, logits, temps: np.ndarray,
                      greedy: np.ndarray) -> np.ndarray:
        """Device-side sampling of every row: argmax for greedy rows,
        a categorical draw at the row's temperature for the others.
        Only the [slots] token ids cross to the host."""
        toks = torch.argmax(logits, dim=-1)
        if not greedy.all():
            scale = torch.from_numpy(np.where(greedy, 1.0, temps).astype(
                np.float32)).to(self.device)
            probs = torch.softmax(logits / scale[:, None], dim=-1)
            drawn = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
            keep = torch.from_numpy(greedy).to(self.device)
            toks = torch.where(keep, toks, drawn)
        with maybe_span(self._tracer, "serve.sync"):
            toks = toks.cpu()
        return toks.numpy()

    def _finish_if_done(self, i: int) -> None:
        slot = self._slots[i]
        req = slot.request
        if req is None:
            return
        if len(req.generated) >= req.max_new_tokens or (
                req.eos_id is not None and req.generated
                and req.generated[-1] == req.eos_id):
            req.done = True
            req.finished_tick = self.ticks
            slot.request = None
            slot.remaining_prompt = None
            self._has_pending[i] = False
            # The device keeps the stale cache until readmission, but
            # the exported KV signal tracks LIVE sequences.
            self._stat_lengths[i] = 0
            self._stats.note_finish(
                self.ticks - (req.submitted_tick or 0))
            if self._reqtrace is not None \
                    and req.request_id is not None:
                self._reqtrace.note_finish(
                    req.request_id, self.ticks,
                    tokens=len(req.generated),
                    attrs=self._trace_finish_attrs(req) or None)

    def _kv_usage(self) -> tuple[int, int]:
        """(live KV token-slots, capacity), host-side only.  Ring
        caches hold at most the buffer width per slot."""
        width = self.cache.max_len
        used = int(np.minimum(self._stat_lengths, width).sum())
        return used, self._stat_lengths.size * width

    def stats(self) -> ServingSnapshot:
        """O(1) export of this engine's serving signals."""
        return self._stats.snapshot()

    def tick(self) -> None:
        """One engine step, then close the stats tick."""
        with maybe_span(self._tracer, "serve.tick") as span:
            counts = self._counts()
            self._tick()
            with maybe_span(self._tracer, "serve.stats"):
                used, cap = self._kv_usage()
                self._stats.end_tick(
                    queue_depth=len(self._queue),
                    active=sum(1 for s in self._slots
                               if s.request is not None),
                    kv_used=used, kv_capacity=cap,
                    decode_tokens_total=self.decode_tokens)
            if span is not None:
                self._close_tick(span, counts)

    def _counts(self) -> tuple[int, int, int]:
        return self.decode_tokens, self.prefill_chunks, self.prefill_tokens

    def _close_tick(self, span, counts) -> None:
        """The traced tick's attrs, and its wall time so far added to
        the lane wait of every request that waited for a lane in it."""
        rows, lanes, tokens = (now - before for now, before in
                               zip(self._counts(), counts))
        self._tracer.annotate(span, tick=self.ticks, decode_rows=rows,
                              prefill_lanes=lanes, prompt_tokens=tokens)
        took = self._tracer.clock() - span.start
        for wait in self._lane_waiting:
            wait.lane_wait_s += took
        self._lane_waiting = []

    def _tick(self) -> None:
        """One engine step: admit, at most one prefill chunk, then one
        batched decode step for every slot with a pending token."""
        tracer = self._tracer
        with maybe_span(tracer, "serve.admit"):
            self._admit()
        self.ticks += 1

        # Chunked prefill: the first slot still holding prompt gets one
        # chunk this tick (bounded head-of-line cost for decoders).
        for i, slot in enumerate(self._slots):
            if slot.request is None or slot.remaining_prompt is None \
                    or len(slot.remaining_prompt) == 0:
                continue
            with maybe_span(tracer, "serve.prefill.plan"):
                if tracer is not None:
                    self._note_lanes([i])
                take = min(self.chunk, len(slot.remaining_prompt))
                buf = np.zeros((self.chunk,), np.int64)
                buf[:take] = slot.remaining_prompt[:take]
                slot.remaining_prompt = slot.remaining_prompt[take:]
            with maybe_span(tracer, "serve.prefill.step"):
                logits, self.cache = self._prefill(
                    self.params, self.cache, i,
                    torch.from_numpy(buf).to(self.device), take)
            self.prefill_chunks += 1
            self.prefill_tokens += take
            self._stat_lengths[i] += take
            if len(slot.remaining_prompt) == 0:
                # Prompt complete: sample the first generated token.
                with maybe_span(tracer, "serve.prefill.sample"):
                    self._note_seeded(i, self._sample_host(logits,
                                                           slot.request))
                    self._finish_if_done(i)
            break

        if not self._has_pending.any():
            return

        # Batched decode over every live slot.  Slots without a pending
        # token run masked lanes; the active mask keeps their lengths
        # from advancing on the device.
        with maybe_span(tracer, "serve.decode.step"):
            logits, self.cache = self._decode(
                self.params, self.cache,
                torch.from_numpy(self._pending_token).to(self.device),
                torch.from_numpy(self._has_pending).to(self.device))
        self._stat_lengths[self._has_pending] += 1
        with maybe_span(tracer, "serve.decode.sample"):
            self._take_decoded(logits)

    def _take_decoded(self, logits) -> None:
        """After a batched decode step: sample every decoding row's next
        token, append it, and finish the requests that are done."""
        self.decode_steps += 1
        temps = np.array(
            [s.request.temperature if s.request else 0.0
             for s in self._slots], np.float32)
        toks = self._batch_sample(logits, temps, temps == 0.0)
        for i, slot in enumerate(self._slots):
            if not self._has_pending[i] or slot.request is None:
                continue
            self.decode_tokens += 1
            req = slot.request
            if req.top_k is not None or req.top_p is not None:
                # Per-row truncation re-samples this row on its own.
                tok = self._sample_host(logits[i], req)
            else:
                tok = int(toks[i])
            req.generated.append(tok)
            self._pending_token[i] = tok
            self._finish_if_done(i)

    def run(self, max_ticks: int = 10_000, watcher=None) -> None:
        """Drive until every submitted request completes.

        ``watcher`` (a checkpoint.DrainWatcher): when the autoscaler
        requests the slice back mid-run, stop ADMITTING queued requests
        but finish every in-flight sequence.  Unserved requests stay
        queued with done=False for the caller to re-dispatch."""
        self.draining = False
        for _ in range(max_ticks):
            if watcher is not None and not self.draining \
                    and watcher.drain_requested():
                self.draining = True
            if self.draining and all(
                    s.request is None for s in self._slots):
                self._note_drain_handoff()
                return
            if self.idle:
                return
            self.tick()
        raise RuntimeError(f"engine did not drain in {max_ticks} ticks")

    def _note_drain_handoff(self) -> None:
        """Drain exit with requests still queued: each one's trace (if
        sampled) closes with a ``drain_handoff`` span; a lost request
        is always tail-captured, whatever the head sampling said."""
        if self._reqtrace is None:
            return
        for req in self._queue:
            if req.request_id is not None:
                self._reqtrace.note_drain_lost(req.request_id,
                                               self.ticks)
