"""Paged KV cache + batched prefill: the serving engine's memory system.

The PyTorch counterpart of the JAX package's ``workloads/paged.py``,
on one device or under a mesh.  serving.py's SlotKVCache reserves ``slots x max_len``
of device memory up front; this module replaces that reservation with
the vLLM/PagedAttention design:

- **PagedKVCache**: one global pool of fixed-size blocks
  (``k, v: [layers, num_blocks, kv_heads, block_size, head_dim]``).  A
  sequence owns a *block table*, the list of pool blocks holding its
  keys in order, so it costs ceil(len / block_size) blocks, not max_len.
- **Host-side allocator, device-side data**: block allocation and free
  are host scheduling (BlockAllocator's free list); the step functions
  receive the block tables as int32 tensors.
- **On-demand growth + preemption**: blocks are allocated as sequences
  cross block boundaries.  A full pool preempts the youngest sequence
  (its blocks free at once; its request re-queues for a fresh prefill),
  so the pool can be sized for the expected load, not the worst case.
- **Batched prefill**: up to ``prefill_lanes`` prompts enter the cache
  per tick in one call; each lane scatters its chunk into its own pages
  and attends with its own causal + window mask.

The decode step's cache read is the ``paged_flash_decode`` CUDA kernel
on a CUDA device: it reads each row's pool blocks in place through the
block table.  The one-device prefill's is the ``paged_flash_prefill``
kernel there: each lane's chunk reads its pages in place, over only the
keys its queries see.  Elsewhere (CPU tensors, or
``attention="einsum"``) the rows are gathered into contiguous ``[rows,
kv_heads, tpr*bs, head_dim]`` views and attended with an einsum (the
prefill's masked over the whole table), as in the JAX package; the
prefill under a mesh always takes that route.

Under a mesh (``mesh=``) the params are placed per rank
(``model.place_params``) and every layer runs tensor-parallel; the pool
is a :class:`MeshPagedKVCache`, cut over KV heads per model rank, and
the tables and lengths are copied to each rank's device.  On a TP-only
mesh (every axis but 'model' of size 1) the decode step runs K4 once
per model rank over its heads of the pool; under dp > 1 the slots are
cut over the data rows, each row's rows are gathered from the pool and
read through ``serving._slot_attend`` (K3 per shard), as the JAX
package does.

Differences from the JAX package, each for a reason:

- The pool is updated in place (PyTorch runs eagerly); the step
  functions still return the cache, so the call sites read alike.
- ``PagedKVCache.lengths`` lives on the host.  The scheduler reads the
  lengths several times a tick, and the steps need them on the host to
  place their writes; the steps upload them with the tables.
- JAX's scatters send inactive rows, pad lanes and table entries < 0 or
  >= num_blocks to an out-of-range index and let XLA drop the write
  (``mode="drop"``).  PyTorch has no such mode.  The one-device decode
  step writes through ``paged_token_write``, which takes every slot and
  drops those rows itself (on CUDA a kernel); the mesh step and the
  prefill filter their write lists before ``index_put_``.  An inactive
  decode row writes nothing: its slot may be in the middle of its
  prefill.
- JAX compiles each step once.  On one CUDA device the decode step is
  captured as a CUDA graph instead (:class:`PagedDecodeStep`): its
  launches, tens a layer, replay as one; the prefill runs eagerly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_autoscaler_torch.obs.trace import maybe_span
from tpu_autoscaler_torch.workloads import attention
from tpu_autoscaler_torch.workloads.attention import (
    gather_pool_rows,
    paged_flash_decode,
    paged_flash_prefill,
    paged_token_write,
    paged_token_writes,
)
from tpu_autoscaler_torch.workloads.model import (
    Mesh,
    ModelConfig,
    TPParams,
    _PerDevice,
    _ffn_residual,
    _flatten,
    _rmsnorm,
    _rotate,
    _split_qkv,
    kv_gather,
    kv_zeros,
    layer_kinds,
    row_sizes,
    tp_blocks,
    tp_embed,
    tp_logits,
)
from tpu_autoscaler_torch.workloads.serving import (
    ContinuousBatcher,
    Request,
    _layer,
    _row_rope_tables,
    _slot_attend,
    _slot_cached_attention,
)

__all__ = ["PagedKVCache", "MeshPagedKVCache", "BlockAllocator",
           "PagedBatcher", "PagedDecodeStep", "Request",
           "make_paged_decode_step", "make_paged_prefill"]


@dataclasses.dataclass
class PagedKVCache:
    """Global block pool + per-slot lengths.

    k, v: [layers, num_blocks, kv_heads, block_size, head_dim] on the
    engine's device.  lengths: [slots] int32 on the host, the logical
    sequence length per slot.  Block tables live host-side in the
    engine (numpy) and enter each step as arguments.
    """

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor

    @property
    def num_blocks(self) -> int:
        return self.k.shape[1]

    @property
    def block_size(self) -> int:
        return self.k.shape[3]

    @classmethod
    def zeros(cls, cfg: ModelConfig, num_blocks: int, block_size: int,
              slots: int, device) -> "PagedKVCache":
        shape = (cfg.n_layers, num_blocks, cfg.kv_heads, block_size,
                 cfg.head_dim)
        return cls(k=torch.zeros(shape, dtype=cfg.dtype, device=device),
                   v=torch.zeros(shape, dtype=cfg.dtype, device=device),
                   lengths=torch.zeros((slots,), dtype=torch.int32))


@dataclasses.dataclass
class MeshPagedKVCache:
    """A :class:`PagedKVCache` cut over a mesh's KV heads: ``k[n]``,
    ``v[n]`` [layers, num_blocks, kv_heads/tp, block_size, head_dim],
    model rank n's heads of the pool, on the first data row's rank n
    (one pool of whole heads on the first device when the heads do not
    divide over the ranks), each a tensor of its own.  The pool is one
    for every slot, so data rows share it rather than cut it.  lengths:
    [slots] int32 on the host, as on one device."""

    k: list
    v: list
    lengths: torch.Tensor

    @property
    def num_blocks(self) -> int:
        return self.k[0].shape[1]

    @property
    def block_size(self) -> int:
        return self.k[0].shape[3]

    @classmethod
    def zeros(cls, sp: TPParams, num_blocks: int, block_size: int,
              slots: int) -> "MeshPagedKVCache":
        lead = (sp.cfg.n_layers, num_blocks)
        tail = (block_size, sp.cfg.head_dim)
        return cls(k=kv_zeros(sp, sp.rows[0], lead, tail),
                   v=kv_zeros(sp, sp.rows[0], lead, tail),
                   lengths=torch.zeros((slots,), dtype=torch.int32))

    def gather(self, device=None) -> PagedKVCache:
        """The whole pool in the one-device layout on ``device``
        (default: the first shard's)."""
        dev = self.k[0].device if device is None else device
        return PagedKVCache(k=kv_gather([self.k], dev),
                            v=kv_gather([self.v], dev),
                            lengths=self.lengths.clone())


class BlockAllocator:
    """Host-side free list over the pool.  ``-1`` in a block table means
    "no block": reads of it are masked and writes to it are dropped."""

    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, -1, -1))

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - len(self._free)

    def alloc(self) -> int | None:
        return self._free.pop() if self._free else None

    def free(self, blocks) -> None:
        for b in blocks:
            if b >= 0:
                self._free.append(int(b))


def _scatter_token(k_pool, v_pool, k, v, tables, positions,
                   active) -> None:
    """The one-device decode step's write of every slot's new k/v
    [slots, hkv, 1, hd] into one layer's pools [nb, hkv, bs, hd], in
    place: ``paged_token_write``, each row deciding on the pools' device
    whether it writes.  perfbench's fault check replaces it by this
    name."""
    paged_token_write(k_pool, v_pool, k, v, tables, positions, active)


def _scatter_rows(pool, new, writes) -> None:
    """Write one token per row into one layer's pool [nb, hkv, bs, hd],
    in place; new [rows, hkv, 1, hd]; writes from
    :func:`attention.paged_token_writes` (on the pool's device)."""
    rows, blocks, offsets = writes
    pool[blocks, :, offsets] = new[rows, :, 0]


def _chunk_writes(tables, offsets, n_valid, chunk: int, num_blocks: int,
                  block_size: int):
    """Where one batched prefill writes, computed on the host: (lanes,
    chunk indices, blocks, offsets), int64.  tables [lanes, tpr];
    offsets [lanes] (each lane's length before the chunk); n_valid
    [lanes].  Entries past a lane's n_valid, and positions whose table
    entry is < 0 or past the pool, write nothing."""
    tpr = tables.shape[1]
    i = torch.arange(chunk)
    pos = offsets.long()[:, None] + i[None, :]              # [lanes, chunk]
    block = tables.long().gather(1, (pos // block_size).clamp(0, tpr - 1))
    keep = (i[None, :] < n_valid.long()[:, None]) & (block >= 0) \
        & (block < num_blocks)
    lane, idx = keep.nonzero(as_tuple=True)
    return lane, idx, block[keep], (pos % block_size)[keep]


def _scatter_chunk(pool, new, writes) -> None:
    """Write the prefill lanes' chunks into one layer's pool, in place;
    new [lanes, hkv, chunk, hd]; writes from :func:`_chunk_writes` (on
    the pool's device)."""
    lane, idx, blocks, offsets = writes
    pool[blocks, :, offsets] = new[lane, :, idx]


def _paged_attend(q, k_pool, v_pool, tables, new_len, cfg: ModelConfig):
    """The paged cache read for one decode layer: the paged_flash_decode
    kernel, which reads the pool in place through the tables, when the
    config resolves to it on q's device; else gather the rows and run
    the linear engine's per-row einsum."""
    if cfg.resolved_attention(q.device) == "kernel":
        return paged_flash_decode(q.contiguous(), k_pool, v_pool, tables,
                                  new_len, window=cfg.attention_window)
    return _slot_cached_attention(q, gather_pool_rows(k_pool, tables),
                                  gather_pool_rows(v_pool, tables), new_len,
                                  cfg)


def _check_tables(tables, cache: PagedKVCache, tokens_per_row: int):
    if tables.shape[1] * cache.block_size != tokens_per_row:
        raise ValueError(
            f"tables of width {tables.shape[1]} at block_size "
            f"{cache.block_size} do not cover {tokens_per_row} tokens")


def _row_bounds(n: int, rows: int) -> list[tuple[int, int]]:
    """[start, stop) of each data row's share of ``n`` slots or lanes
    (:func:`model.row_sizes`)."""
    out, start = [], 0
    for size in row_sizes(n, rows):
        out.append((start, start + size))
        start += size
    return out


def _row_writes(writes, start: int, stop: int):
    """The host write lists of the rows in [start, stop), renumbered
    from the row's first."""
    rows, *rest = writes
    keep = (rows >= start) & (rows < stop)
    return (rows[keep] - start, *(t[keep] for t in rest))


def _mesh_paged_decode_step(cfg: ModelConfig, tokens_per_row: int):
    """:func:`make_paged_decode_step` over a :class:`MeshPagedKVCache`
    with params placed by :func:`model.place_params`.  Each data row
    decodes its share of the slots; shard (row, rank n) writes its
    tokens' k/v into pool n, then reads it: K4 on a TP-only mesh (one
    data row), else the row's rows gathered from the pool and read
    through ``_slot_attend`` (K3 per shard)."""

    def step(sp: TPParams, cache: MeshPagedKVCache, tables, tokens, active):
        _check_tables(tables, cache, tokens_per_row)
        positions = cache.lengths
        bounds = _row_bounds(tables.shape[0], len(sp.rows))
        live = [i for i, (a, b) in enumerate(bounds) if b > a]
        tp_only = len(sp.rows) == 1
        writes = paged_token_writes(tables, positions, active,
                                    cache.num_blocks, cache.block_size)
        tokens = tokens.to(sp.first)
        xs = tp_embed(sp, [tokens[a:b, None] for a, b in
                           (bounds[i] for i in live)], live)
        on = _PerDevice()

        def rows_of(t, i):
            a, b = bounds[i]
            return t[a:b]

        def positions_on(i, dev):
            return on(("pos", i), dev,
                      lambda d: rows_of(positions, i).to(d))

        rope = None
        if cfg.rope:
            def rope(t, i):
                return _rotate(t, *on(("rope", i), t.device, lambda d: (
                    _row_rope_tables(positions_on(i, d), 1, cfg.head_dim,
                                     cfg.rope_theta, cfg.dtype))))

        def attend(layer, i, j, q, k, v):
            n = 0 if j is None else j
            k_pool, v_pool = cache.k[n][layer], cache.v[n][layer]
            pdev = k_pool.device
            mine = on(("writes", i), pdev, lambda d: [
                t.to(d) for t in _row_writes(writes, *bounds[i])])
            _scatter_rows(k_pool, k.to(pdev), mine)
            _scatter_rows(v_pool, v.to(pdev), mine)
            new_len = on(("new_len", i), q.device,
                         lambda d: positions_on(i, d) + 1)
            tabs = on(("tables", i), pdev, lambda d: rows_of(tables, i).to(d))
            if tp_only:
                return _paged_attend(q, k_pool, v_pool, tabs, new_len, cfg)
            return _slot_attend(
                q, gather_pool_rows(k_pool, tabs).to(q.device),
                gather_pool_rows(v_pool, tabs).to(q.device), new_len, cfg)

        xs = tp_blocks(sp, xs, live, rope, attend)
        logits = tp_logits(sp, xs, live)
        cache.lengths += active.to(torch.int32)
        return logits[:, 0], cache

    return step


def make_paged_decode_step(cfg: ModelConfig, tokens_per_row: int,
                           mesh: Mesh | None = None, tracer=None):
    """Build ``step(params, cache, tables, tokens, active) -> (logits,
    cache)``: one token for every slot, written and read through the
    block tables.  tables: [slots, tokens_per_row // block_size] int32
    and active [slots] bool, on the host; tokens [slots] int.

    Returns logits [slots, vocab] f32 and the cache, its pool updated in
    place and active lengths advanced by 1.  Inactive rows write
    nothing; their logits are computed and ignored.

    ``mesh``: the step takes params placed over it
    (:func:`model.place_params`) and a :class:`MeshPagedKVCache`.
    Without one the step is a :class:`PagedDecodeStep`, which on a CUDA
    device replays a captured CUDA graph once the same pool and params
    come twice in a row.  ``tracer``: the one-device step's inputs are a
    ``serve.decode.inputs`` span (:class:`serving.ContinuousBatcher`)."""
    if mesh is not None:
        cfg.require_uniform("serving under a mesh")
        return _mesh_paged_decode_step(cfg.resolved_for_mesh(mesh),
                                       tokens_per_row)
    return PagedDecodeStep(cfg, tokens_per_row, tracer)


class PagedDecodeStep:
    """The one-device paged decode step (:func:`make_paged_decode_step`).

    Its :meth:`body` takes tensors of one shape every call, on the
    pool's device, and keeps the step's work there: each layer's new
    k/v are written by ``paged_token_write`` over every slot, each row
    deciding on the device whether it writes, so nothing in the body
    depends on which rows are live.  On a CUDA device:

    - the inputs reach the device in one non-blocking copy from a pinned
      buffer (:class:`_StagedInputs`);
    - a call whose pool and params (by storage) are those of the call
      before it captures the body as a ``torch.cuda.CUDAGraph``, after
      one warm-up run on a side stream, into the step's own graph memory
      pool; every later call on them replays it and returns a copy of
      its logits.  Any other call runs the body eagerly, and a pool or
      set of params that comes twice in a row is captured in turn;
    - a replay adds the captured launches to ``attention.LAUNCHES``
      (a capture counts those of its warm-up run, which reach the card,
      and not its own) and, for the dropless MoE route under a tracer,
      each layer's group ends to the tracer's ``serve.moe`` counter, a
      row a layer as the eager body adds them; no span is opened inside
      the graph.

    ``replays`` and ``captures`` count the calls answered by a replay
    and the graphs captured; :meth:`eager` runs a call without the
    graph."""

    def __init__(self, cfg: ModelConfig, tokens_per_row: int, tracer=None):
        self.cfg = cfg
        self.tokens_per_row = tokens_per_row
        self.tracer = tracer
        self.kinds, self.of_layer = layer_kinds(cfg)
        self.moe = _MoeSeam(cfg, tracer)
        self.replays = 0
        self.captures = 0
        self._staged: _StagedInputs | None = None
        self._graph: _Captured | None = None
        self._seen = None
        self._mempool = None

    def __call__(self, params, cache: PagedKVCache, tables, tokens, active):
        return self._step(params, cache, tables, tokens, active, graph=True)

    def eager(self, params, cache: PagedKVCache, tables, tokens, active):
        """The step with its body run eagerly, never replayed."""
        return self._step(params, cache, tables, tokens, active, graph=False)

    def _step(self, params, cache, tables, tokens, active, graph: bool):
        _check_tables(tables, cache, self.tokens_per_row)
        dev = cache.k.device
        served = self.moe.tokens(active)
        with maybe_span(self.tracer, "serve.decode.inputs"):
            # Off CUDA the body takes them where they are.
            inputs = (tables, cache.lengths, tokens, active)
            if dev.type == "cuda":
                inputs = self._stage(dev, *inputs)
        if graph and dev.type == "cuda":
            logits = self._graphed(params, cache, inputs, served)
        else:
            logits = self.body(params, cache.k, cache.v, *inputs,
                               served=served)
        cache.lengths += active.to(torch.int32)
        return logits, cache

    def body(self, params, k_pools, v_pools, tables, positions, tokens,
             active, *, moe=None, served=None):
        """The decode step over tensors on the pools' device, of one
        shape every call: pools [layers, nb, hkv, bs, hd]; tables
        [slots, tpr] int32, positions [slots] int32 (each row's length
        before the step), tokens [slots] int and active [slots] bool.
        Returns logits [slots, vocab] f32.  ``moe``: the FFN seam
        (default the step's), ``served`` its span attr."""
        cfg = self.cfg
        moe = self.moe if moe is None else moe
        new_len = positions + 1
        if cfg.rope:
            # Once a layer kind, shared by its layers.
            ropes = [_row_rope_tables(positions, 1, cfg.head_dim,
                                      kc.rope_theta, cfg.dtype, yarn)
                     for kc, yarn in self.kinds]
        x = params["embed"].to(cfg.dtype)[tokens][:, None, :]
        b, s, d = x.shape
        for i in range(cfg.n_layers):
            kcfg = self.kinds[self.of_layer[i]][0]
            layer = _layer(params, i)
            k_pool, v_pool = k_pools[i], v_pools[i]
            y = _rmsnorm(x, layer["ln1"])
            q, k, v = _split_qkv(y, layer["qkv"], cfg)
            if cfg.rope:
                rope = ropes[self.of_layer[i]]
                q, k = _rotate(q, *rope), _rotate(k, *rope)
            _scatter_token(k_pool, v_pool, k, v, tables, positions, active)
            attn = _paged_attend(q, k_pool, v_pool, tables, new_len, kcfg)
            attn = attn.transpose(1, 2).reshape(b, s, -1)
            x = x + attn @ layer["attn_out"].to(cfg.dtype)
            y = _rmsnorm(x, layer["ln2"])
            x = moe.ffn(x, y, layer, i, served)
        x = _rmsnorm(x, params["ln_f"])
        return (x @ params["unembed"].to(cfg.dtype))[:, 0].float()

    def _stage(self, dev, tables, positions, tokens, active):
        slots, tpr = tables.shape
        if self._staged is None or self._staged.shape != (slots, tpr) \
                or self._staged.device != dev:
            # A captured graph reads the old buffers: it goes with them.
            self._staged = _StagedInputs(slots, tpr, dev)
            self._graph = self._seen = None
        return self._staged.put(tables, positions, tokens, active)

    def _graphed(self, params, cache, inputs, served):
        key = tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in (
            cache.k, cache.v, *(w for _, w in _flatten(params))))
        captured = self._graph
        if captured is None or captured.key != key:
            if key != self._seen:
                self._seen = key
                return self.body(params, cache.k, cache.v, *inputs,
                                 served=served)
            captured = self._capture(key, params, cache, inputs)
        captured.graph.replay()
        for name, n in captured.launches.items():
            attention.LAUNCHES[name] += n
        if captured.ends is not None:
            self.moe.counter.add_rows(captured.ends)
        self.replays += 1
        return captured.logits.clone()

    def _capture(self, key, params, cache, inputs) -> "_Captured":
        self._graph = None  # its memory back to the pool before the next
        dev = cache.k.device
        if self._mempool is None:
            self._mempool = torch.cuda.graph_pool_handle()
        ends = None if self.moe.counter is None else torch.zeros(
            (self.cfg.n_layers, self.cfg.moe_experts), dtype=torch.int32,
            device=dev)
        seam = _MoeSeam(self.cfg, None, ends)
        # The warm-up writes what the replay writes again: the same k/v
        # at the same places.  Its launches run and are counted; the
        # capture's run nothing.
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.body(params, cache.k, cache.v, *inputs, moe=seam)
        torch.cuda.current_stream(dev).wait_stream(side)
        warm = dict(attention.LAUNCHES)
        # The graph as captured is kept beside its executable, so that
        # its kernel nodes can be read (``raw_cuda_graph``).
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph, pool=self._mempool):
            logits = self.body(params, cache.k, cache.v, *inputs, moe=seam)
        graph.instantiate()
        launches = {n: attention.LAUNCHES[n] - warm[n] for n in warm
                    if attention.LAUNCHES[n] != warm[n]}
        attention.LAUNCHES.update(warm)
        self._graph = _Captured(key, graph, logits, ends, launches)
        self.captures += 1
        return self._graph


@dataclasses.dataclass
class _Captured:
    """A captured decode step: the pool and params it was captured on
    (``key``: storage, shape and dtype of each), its graph, its output
    logits and MoE group ends (rewritten by every replay), and the
    kernel launches one replay makes."""

    key: tuple
    graph: object
    logits: torch.Tensor
    ends: torch.Tensor | None
    launches: dict


class _StagedInputs:
    """A decode step's inputs on their way to the device: one pinned
    host buffer holding tokens [slots] int64, tables [slots, tpr] int32,
    positions [slots] int32 and active [slots] bool, and the device
    buffer it reaches in one non-blocking copy.  :meth:`put` returns the
    device buffer's views, the same tensors every call, so a captured
    graph reads each call's inputs there.  The host buffer is rewritten
    only after its last copy has left it."""

    def __init__(self, slots: int, tpr: int, device):
        self.shape = (slots, tpr)
        self.device = device
        layout = ((torch.int64, (slots,)), (torch.int32, (slots, tpr)),
                  (torch.int32, (slots,)), (torch.bool, (slots,)))
        sizes = [int(np.prod(shape)) * dtype.itemsize
                 for dtype, shape in layout]
        self._host = torch.empty(sum(sizes), dtype=torch.uint8,
                                 pin_memory=True)
        self._dev = torch.empty(sum(sizes), dtype=torch.uint8, device=device)
        self.host, self.inputs = [], []
        for views, buf in ((self.host, self._host), (self.inputs, self._dev)):
            at = 0
            for (dtype, shape), n in zip(layout, sizes):
                views.append(buf[at:at + n].view(dtype).view(shape))
                at += n
        self._copied = torch.cuda.Event()

    def put(self, tables, positions, tokens, active):
        """Stage one call's inputs (each on the host, or already on the
        device); returns (tables, positions, tokens, active) on the
        device."""
        self._copied.synchronize()
        on_device = []
        for host, dev, t in zip(self.host, self.inputs,
                                (tokens, tables, positions, active)):
            if t.device.type == "cpu":
                host.copy_(t)
            else:
                on_device.append((dev, t))
        self._dev.copy_(self._host, non_blocking=True)
        self._copied.record()
        for dev, t in on_device:
            dev.copy_(t)
        tokens, tables, positions, active = self.inputs
        return tables, positions, tokens, active


class _MoeSeam:
    """A step's FFN half, through :func:`model._ffn_residual`: for an
    MoE config under a tracer, each layer's call is a ``serve.moe`` span
    (attrs ``layer``, ``tokens``: the rows the step serves, counted on
    the host) and the dropless route counts into the tracer's
    ``serve.moe`` device counter.  With ``ends`` (a captured decode
    step's [layers, E] int32 buffer) layer i's group ends go to row i
    of it instead, with no span.  Anything else calls through with
    nothing added."""

    def __init__(self, cfg: ModelConfig, tracer, ends=None):
        self.cfg = cfg
        self.dropless = cfg.moe_dropless
        self.ends = ends
        self.tracer = tracer if cfg.moe_experts is not None else None
        self.counter = None if self.tracer is None or not self.dropless \
            else self.tracer.counter("serve.moe")

    def tokens(self, rows) -> int | None:
        """The rows a step serves (a host tensor of flags or counts),
        read only under a tracer."""
        return None if self.tracer is None else int(rows.sum())

    def ffn(self, x, y, layer: dict, i: int, tokens, valid=None):
        if self.ends is not None:
            return _ffn_residual(x, y, layer, self.cfg, valid,
                                 _EndsRow(self.ends[i]))
        if self.tracer is None:
            return _ffn_residual(x, y, layer, self.cfg, valid)
        with maybe_span(self.tracer, "serve.moe",
                        {"layer": i, "tokens": tokens}):
            return _ffn_residual(x, y, layer, self.cfg, valid, self.counter)


class _EndsRow:
    """One layer's row of a captured step's group ends, in the place of
    the ``serve.moe`` counter: ``add`` copies the call's ends into it."""

    def __init__(self, row: torch.Tensor):
        self.row = row

    def add(self, values: torch.Tensor) -> None:
        self.row.copy_(values)


def _lanes_visible(offsets, s: int, tokens_per_row: int,
                   cfg: ModelConfig):
    """[lanes, s, tokens_per_row] bool: each lane's queries see its
    gathered pages causally from its offset (and within the window)."""
    dev = offsets.device
    qpos = offsets.long()[:, None] + torch.arange(s, device=dev)
    kpos = torch.arange(tokens_per_row, device=dev)
    visible = kpos[None, None, :] <= qpos[..., None]
    if cfg.attention_window is not None:
        visible &= kpos[None, None, :] > qpos[..., None] \
            - cfg.attention_window
    return visible


def _lanes_attend(q, k_rows, v_rows, visible, cfg: ModelConfig):
    """Each lane's chunk q [b, h, s, hd] over its gathered pages k/v
    rows [b, hkv, T, hd]: the grouped einsum masked by ``visible``;
    [b, h, s, hd] (h and hkv: whatever q and the rows hold)."""
    b, h, s, hd = q.shape
    hkv = k_rows.shape[1]
    qg = q.reshape(b, hkv, h // hkv, s, hd)
    scores = torch.einsum("bngqd,bnkd->bngqk", qg, k_rows) * hd ** -0.5
    scores = torch.where(visible[:, None, None], scores.float(), -1e30)
    probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
    return torch.einsum("bngqk,bnkd->bngqd", probs, v_rows).reshape(
        b, h, s, hd)


def _mesh_paged_prefill(cfg: ModelConfig, chunk: int, lanes: int,
                        tokens_per_row: int, return_all_logits: bool):
    """:func:`make_paged_prefill` over a :class:`MeshPagedKVCache`: the
    lanes cut over the data rows, shard (row, rank n) scattering its
    lanes' chunks into pool n and attending over its heads of their
    gathered pages (the einsum)."""

    def fill(sp: TPParams, cache: MeshPagedKVCache, tables, tokens,
             offsets, n_valid):
        _check_tables(tables, cache, tokens_per_row)
        if tokens.shape != (lanes, chunk):
            raise ValueError(f"tokens {tuple(tokens.shape)}: want "
                             f"[{lanes}, {chunk}]")
        bounds = _row_bounds(lanes, len(sp.rows))
        live = [i for i, (a, b) in enumerate(bounds) if b > a]
        tokens = tokens.to(sp.first)
        xs = tp_embed(sp, [tokens[a:b] for a, b in
                           (bounds[i] for i in live)], live)
        on = _PerDevice()

        def offsets_on(i, dev):
            a, b = bounds[i]
            return on(("off", i), dev, lambda d: offsets[a:b].to(d))

        rope = None
        if cfg.rope:
            def rope(t, i):
                return _rotate(t, *on(("rope", i), t.device, lambda d: (
                    _row_rope_tables(offsets_on(i, d), chunk, cfg.head_dim,
                                     cfg.rope_theta, cfg.dtype))))

        def attend(layer, i, j, q, k, v):
            n = 0 if j is None else j
            k_pool, v_pool = cache.k[n][layer], cache.v[n][layer]
            pdev = k_pool.device
            a, b = bounds[i]
            mine = on(("writes", i), pdev, lambda d: [t.to(d) for t in (
                _chunk_writes(tables[a:b], offsets[a:b], n_valid[a:b],
                              chunk, cache.num_blocks, cache.block_size))])
            _scatter_chunk(k_pool, k.to(pdev), mine)
            _scatter_chunk(v_pool, v.to(pdev), mine)
            tabs = on(("tables", i), pdev, lambda d: tables[a:b].to(d))
            visible = on(("visible", i), q.device, lambda d: _lanes_visible(
                offsets_on(i, d), chunk, tokens_per_row, cfg))
            return _lanes_attend(
                q, gather_pool_rows(k_pool, tabs).to(q.device),
                gather_pool_rows(v_pool, tabs).to(q.device), visible, cfg)

        xs = tp_blocks(sp, xs, live, rope, attend)
        if not return_all_logits:
            last = (n_valid.long() - 1).clamp_min(0)
            xs = [x[torch.arange(x.shape[0], device=x.device),
                    last[slice(*bounds[i])].to(x.device)]
                  for x, i in zip(xs, live)]
        return tp_logits(sp, xs, live), cache

    return fill


def make_paged_prefill(cfg: ModelConfig, chunk: int, lanes: int,
                       tokens_per_row: int, return_all_logits: bool = False,
                       mesh: Mesh | None = None, tracer=None):
    """Build ``fill(params, cache, tables, tokens, offsets, n_valid) ->
    (logits, cache)``: append one chunk to EACH of ``lanes`` prompts in
    one call.

    tables:  [lanes, tokens_per_row // block_size] int32 — each lane's
             pages (-1 rows for unused lanes), on the host.
    tokens:  [lanes, chunk] int (padded past n_valid).
    offsets: [lanes] int32 — each lane's length before this chunk, on
             the host.
    n_valid: [lanes] int32 — real tokens this chunk (0 = unused lane),
             on the host.

    Returns logits [lanes, vocab] f32 at each lane's last valid position
    (the generation seed when the lane just finished its prompt) and the
    cache, its pool updated in place; lengths are the caller's to
    advance.  ``return_all_logits=True`` returns [lanes, chunk, vocab]:
    every appended position's logits (rows past a lane's n_valid are
    padding).  ``mesh``, ``tracer`` (a ``serve.prefill.inputs`` span):
    as in :func:`make_paged_decode_step`.

    Each layer's attention, on one device, is the paged_flash_prefill
    kernel when the config resolves to it on the pool's device (as the
    decode step's read does): each lane's chunk reads its pages in
    place, its padding rows attended as the einsum attends them (an MoE
    layer routes their tokens in the lane's pool).  Otherwise, and always
    under a mesh, each lane's whole table is gathered and attended with
    the masked einsum (:func:`_lanes_attend`)."""
    if mesh is not None:
        cfg.require_uniform("serving under a mesh")
        return _mesh_paged_prefill(cfg.resolved_for_mesh(mesh), chunk, lanes,
                                   tokens_per_row, return_all_logits)
    hd = cfg.head_dim
    kinds, of_layer = layer_kinds(cfg)
    moe = _MoeSeam(cfg, tracer)

    def fill(params, cache: PagedKVCache, tables, tokens, offsets, n_valid):
        _check_tables(tables, cache, tokens_per_row)
        if tokens.shape != (lanes, chunk):
            raise ValueError(f"tokens {tuple(tokens.shape)}: want "
                             f"[{lanes}, {chunk}]")
        dev = cache.k.device
        kernel = cfg.resolved_attention(dev) == "kernel"
        with maybe_span(tracer, "serve.prefill.inputs"):
            writes = [t.to(dev) for t in _chunk_writes(
                tables, offsets, n_valid, chunk, cache.num_blocks,
                cache.block_size)]
            dev_tables = tables.to(dev)
            dev_tokens = tokens.to(dev)
            if kernel or moe.dropless:
                # offsets and n_valid in one copy to the device.
                dev_offsets, dev_n_valid = torch.stack(
                    [offsets.to(torch.int32), n_valid.to(torch.int32)]
                ).to(dev)
            else:
                dev_offsets = offsets.to(dev)
            if not kernel:
                # Each lane attends over its own gathered pages: causal
                # within the chunk plus everything before its offset
                # (and inside the window of each layer kind).
                visible = [_lanes_visible(dev_offsets, chunk, tokens_per_row,
                                          kc) for kc, _ in kinds]
            if cfg.rope:
                ropes = [_row_rope_tables(dev_offsets, chunk, hd,
                                          kc.rope_theta, cfg.dtype, yarn)
                         for kc, yarn in kinds]
            # The dropless route leaves the padding rows unrouted.
            valid = (torch.arange(chunk, device=dev)[None, :]
                     < dev_n_valid[:, None]) if moe.dropless else None
        x = params["embed"].to(cfg.dtype)[dev_tokens]  # [lanes, chunk, d]
        b, s, d = x.shape
        tokens_in = moe.tokens(n_valid)
        for i in range(cfg.n_layers):
            kcfg = kinds[of_layer[i]][0]
            layer = _layer(params, i)
            k_pool, v_pool = cache.k[i], cache.v[i]
            y = _rmsnorm(x, layer["ln1"])
            q, k, v = _split_qkv(y, layer["qkv"], cfg)     # [b, h, s, hd]
            if cfg.rope:
                rope = ropes[of_layer[i]]
                q, k = _rotate(q, *rope), _rotate(k, *rope)
            _scatter_chunk(k_pool, k, writes)
            _scatter_chunk(v_pool, v, writes)
            if kernel:
                attn = paged_flash_prefill(
                    q.contiguous(), k_pool, v_pool, dev_tables, dev_offsets,
                    dev_n_valid, window=kcfg.attention_window)
            else:
                attn = _lanes_attend(
                    q, gather_pool_rows(k_pool, dev_tables),
                    gather_pool_rows(v_pool, dev_tables),
                    visible[of_layer[i]], cfg)
            attn = attn.transpose(1, 2).reshape(b, s, -1)
            x = x + attn @ layer["attn_out"].to(cfg.dtype)
            y = _rmsnorm(x, layer["ln2"])
            x = moe.ffn(x, y, layer, i, tokens_in, valid)
        if return_all_logits:
            x = _rmsnorm(x, params["ln_f"])
            return (x @ params["unembed"].to(cfg.dtype)).float(), cache
        # Only each lane's last valid row is returned; rmsnorm and the
        # unembedding are per-row, so computing just those rows gives
        # the same numbers.
        last = (n_valid.long() - 1).clamp_min(0).to(dev)
        x = _rmsnorm(x[torch.arange(b, device=dev), last], params["ln_f"])
        return (x @ params["unembed"].to(cfg.dtype)).float(), cache

    return fill


class PagedBatcher(ContinuousBatcher):
    """Continuous batching over the paged cache.

    Differences from the linear ContinuousBatcher it subclasses:

    - Device memory is the POOL (``num_blocks * block_size`` token-slots
      shared by all sequences), not slots x max_len.  ``slots`` bounds
      concurrent sequences; memory bounds them only through actual use.
    - Admission allocates blocks for the first prompt chunk only;
      prefill and decode grow a sequence block by block.
    - Pool exhaustion preempts the YOUNGEST sequence (fewest generated
      tokens: the cheapest prefill to redo): its blocks free at once and
      its request re-queues at the head, un-done.  Head-of-line
      sequences therefore always complete.
    - Up to ``prefill_lanes`` prompts prefill per tick in one call.
    """

    def __init__(self, params, cfg: ModelConfig, *, slots: int = 4,
                 max_len: int = 256, block_size: int = 16,
                 num_blocks: int | None = None, chunk: int = 32,
                 prefill_lanes: int = 2, device=None,
                 generator: torch.Generator | None = None,
                 slo_ticks: int | None = None, reqtrace=None,
                 mesh: Mesh | None = None, tracer=None):
        """``mesh``: serve under it (see :class:`ContinuousBatcher`);
        the pool is cut over KV heads (:class:`MeshPagedKVCache`).
        ``tracer``: see :class:`ContinuousBatcher`."""
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if max_len % block_size:
            raise ValueError(f"max_len {max_len} must be a multiple of "
                             f"block_size {block_size}")
        # Paged geometry must exist before the parent's init calls our
        # _build_device_state override.
        self.block_size = block_size
        self.blocks_per_row = max_len // block_size
        self._num_blocks = (num_blocks if num_blocks is not None
                            else slots * self.blocks_per_row)
        self.prefill_lanes = prefill_lanes
        self.preemptions = 0
        super().__init__(params, cfg, slots=slots, max_len=max_len,
                         chunk=chunk, device=device, generator=generator,
                         ring=False, slo_ticks=slo_ticks, reqtrace=reqtrace,
                         mesh=mesh, tracer=tracer)

    def _pool(self, cfg, params):
        """A fresh pool for ``cfg`` (params placed over the engine's
        mesh, when it has one)."""
        if self.mesh is not None:
            return MeshPagedKVCache.zeros(params, self._num_blocks,
                                          self.block_size, len(self.tables))
        return PagedKVCache.zeros(cfg, self._num_blocks, self.block_size,
                                  len(self.tables), self.device)

    def _build_device_state(self, cfg, slots, max_len, chunk, ring) -> None:
        self.allocator = BlockAllocator(self._num_blocks)
        self.tables = np.full((slots, self.blocks_per_row), -1, np.int32)
        self.cache = self._pool(cfg, self.params)
        # Untraced, the builders are called as they always were, so a
        # wrapper of either with the untraced signature still serves.
        traced = {} if self._tracer is None else {"tracer": self._tracer}
        # The step as built, whatever later wraps self._decode: its
        # replay and capture counts say how each decode step ran.
        self._decode = self._decode_step = make_paged_decode_step(
            cfg, max_len, self.mesh, **traced)
        self._prefill = make_paged_prefill(cfg, chunk, self.prefill_lanes,
                                           max_len, mesh=self.mesh, **traced)

    # How the decode steps ran, read from the step (a PagedDecodeStep;
    # the mesh step and wrappers of the builder replay nothing).

    @property
    def decode_graph_replays(self) -> int:
        """Decode steps answered by a replay of the step's CUDA graph."""
        return getattr(self._decode_step, "replays", 0)

    @property
    def decode_graph_captures(self) -> int:
        """CUDA graphs the decode step captured."""
        return getattr(self._decode_step, "captures", 0)

    @property
    def decode_eager_steps(self) -> int:
        """Decode steps run eagerly."""
        return self.decode_steps - self.decode_graph_replays

    def submit(self, request: Request) -> None:
        """Linear-engine validation plus the pool-feasibility check: a
        request whose worst-case footprint exceeds the WHOLE pool could
        never run even alone; it would preempt itself forever."""
        need_blocks = -(-(len(request.prompt) + request.max_new_tokens)
                        // self.block_size)
        if need_blocks > self.allocator.num_blocks:
            raise ValueError(
                f"request needs {need_blocks} blocks "
                f"({len(request.prompt)} prompt + "
                f"{request.max_new_tokens} new at block_size "
                f"{self.block_size}) but the pool holds only "
                f"{self.allocator.num_blocks}; it can never be "
                "scheduled")
        super().submit(request)

    # ---- accounting ----------------------------------------------------

    def live_tokens(self) -> int:
        lengths = self.cache.lengths
        return sum(int(lengths[i]) for i, s in enumerate(self._slots)
                   if s.request is not None)

    def check_accounting(self) -> None:
        """The paged invariant: allocated blocks cover live tokens with
        less than one block of slack per live sequence (+ the blocks
        pre-allocated for in-flight prefill chunks), and the tables
        hold exactly the allocator's used blocks."""
        live = self.live_tokens()
        used = self.allocator.used_blocks * self.block_size
        live_seqs = sum(1 for s in self._slots if s.request is not None)
        slack = live_seqs * (self.block_size + self.chunk)
        if used > live + slack:
            raise AssertionError(
                f"paged accounting violated: {used} token-slots allocated "
                f"for {live} live tokens (+{slack} slack)")
        table_blocks = int((self.tables >= 0).sum())
        if table_blocks != self.allocator.used_blocks:
            raise AssertionError(
                f"table/allocator divergence: {table_blocks} vs "
                f"{self.allocator.used_blocks}")

    # ---- block management ----------------------------------------------

    def _ensure_blocks(self, i: int, upto_tokens: int) -> bool:
        """Grow slot i's table to cover ``upto_tokens`` positions;
        False when the pool is exhausted (the caller preempts)."""
        need = -(-upto_tokens // self.block_size)
        row = self.tables[i]
        have = int((row >= 0).sum())
        while have < need:
            b = self.allocator.alloc()
            if b is None:
                return False
            row[have] = b
            have += 1
        return True

    def _release_slot(self, i: int) -> None:
        self.allocator.free(self.tables[i][self.tables[i] >= 0])
        self.tables[i] = -1
        self.cache.lengths[i] = 0

    def _finish_if_done(self, i: int) -> None:
        before = self._slots[i].request
        super()._finish_if_done(i)
        if before is not None and self._slots[i].request is None:
            self._release_slot(i)

    def _preempt_youngest(self) -> bool:
        """Evict the live sequence with the fewest generated tokens back
        to the queue (cheapest re-prefill); False if none is live."""
        candidates = [
            (len(s.request.generated), i)
            for i, s in enumerate(self._slots) if s.request is not None]
        if not candidates:
            return False
        _, i = min(candidates)
        self._preempt_slot(i)
        return True

    def _preempt_slot(self, i: int) -> None:
        """Evict slot i's sequence back to the queue head: its request
        restarts from a fresh prefill; every block frees at once."""
        slot = self._slots[i]
        req = slot.request
        req.generated.clear()
        req.done = False
        req.preempted_tick = self.ticks
        self._queue.insert(0, req)
        slot.request = None
        slot.remaining_prompt = None
        slot.seeded = False
        self._has_pending[i] = False
        self._release_slot(i)
        self.preemptions += 1
        self._stats.note_preempt()
        if self._reqtrace is not None and req.request_id is not None:
            self._reqtrace.note_preempt(req.request_id, self.ticks)

    # ---- engine loop ---------------------------------------------------

    def _admit(self) -> None:
        if self.draining:
            return
        for i, slot in enumerate(self._slots):
            if slot.request is None and self._queue:
                req = self._queue[0]
                # Admission only needs the FIRST chunk's blocks; growth
                # is on demand.  If even that fails, return the partial
                # allocation and stop admitting: decode progress will
                # free blocks.
                if not self._ensure_blocks(i, min(self.chunk,
                                                  len(req.prompt))):
                    self._release_slot(i)
                    return
                self._queue.pop(0)
                slot.request = req
                slot.remaining_prompt = np.asarray(req.prompt, np.int64)
                slot.seeded = False
                self._has_pending[i] = False
                self._stats.note_admit()
                self._note_admitted(req)
                self.cache.lengths[i] = 0

    def _kv_usage(self) -> tuple[int, int]:
        """Pool-block accounting: the paged engine's real KV pressure
        is allocator occupancy, not per-slot logical length."""
        return (self.allocator.used_blocks * self.block_size,
                self.allocator.num_blocks * self.block_size)

    def _tick(self) -> None:
        """One engine step: admit, one BATCHED prefill over up to
        ``prefill_lanes`` slots still holding prompt, then one batched
        decode step for every slot with a pending token.  The device
        phases are hooks: spec_serving.py mirrors the prefill into the
        draft cache (``_after_prefill``) and replaces the decode phase
        with draft-propose / target-verify rounds."""
        with maybe_span(self._tracer, "serve.admit"):
            self._admit()
        self.ticks += 1
        self._after_prefill(self._prefill_phase())
        if self._has_pending.any():
            self._decode_phase()

    def _after_prefill(self, served: list) -> None:
        """Hook: called with the prefill phase's served chunks
        ``[(slot, tokens, take, offset_before)]`` (possibly empty).  A
        subclass that mirrors the prefill elsewhere (the draft cache)
        does so BEFORE calling _prefill_finish, which may release
        completed slots."""
        self._prefill_finish(served)

    def _prefill_finish(self, served: list) -> None:
        """Completion checks for the lanes just prefilled."""
        for i, _, _, _ in served:
            self._finish_if_done(i)

    def _prefill_phase(self) -> list:
        """Collect up to ``prefill_lanes`` slots holding prompt (growing
        their tables, preempting under pool pressure), prefill one chunk
        of each, and seed the slots whose prompt is complete.  Returns
        the served chunks, ``(slot, tokens [chunk], take, offset)``
        each, offset being the slot's length before the chunk."""
        tracer = self._tracer
        with maybe_span(tracer, "serve.prefill.plan"):
            lanes = self._choose_lanes()
            if tracer is not None:
                self._note_lanes(lanes)
            if not lanes:
                return []
            served = []
            tok = np.zeros((self.prefill_lanes, self.chunk), np.int64)
            offs = np.zeros((self.prefill_lanes,), np.int32)
            nval = np.zeros((self.prefill_lanes,), np.int32)
            tabs = np.full((self.prefill_lanes, self.blocks_per_row), -1,
                           np.int32)
            for lane, i in enumerate(lanes):
                prompt = self._slots[i].remaining_prompt
                take = min(self.chunk, len(prompt))
                tok[lane, :take] = prompt[:take]
                offs[lane] = self.cache.lengths[i]
                nval[lane] = take
                tabs[lane] = self.tables[i]
                served.append((i, tok[lane].copy(), take, int(offs[lane])))
                self.prefill_tokens += take
            self.prefill_chunks += len(lanes)
        with maybe_span(tracer, "serve.prefill.step"):
            logits, self.cache = self._prefill(
                self.params, self.cache, torch.from_numpy(tabs),
                torch.from_numpy(tok), torch.from_numpy(offs),
                torch.from_numpy(nval))
        with maybe_span(tracer, "serve.prefill.sample"):
            for lane, i in enumerate(lanes):
                slot = self._slots[i]
                slot.remaining_prompt = slot.remaining_prompt[nval[lane]:]
                self.cache.lengths[i] += int(nval[lane])
                if len(slot.remaining_prompt) == 0:
                    self._note_seeded(i, self._sample_host(logits[lane],
                                                           slot.request))
        return served

    def _choose_lanes(self) -> list[int]:
        """Up to ``prefill_lanes`` slots holding prompt, in slot order,
        each grown to take its next chunk (preempting under pool
        pressure)."""
        lanes: list[int] = []
        for i, slot in enumerate(self._slots):
            if len(lanes) == self.prefill_lanes:
                break
            if slot.request is None or slot.remaining_prompt is None \
                    or len(slot.remaining_prompt) == 0:
                continue
            take = min(self.chunk, len(slot.remaining_prompt))
            upto = int(self.cache.lengths[i]) + take
            while not self._ensure_blocks(i, upto):
                if not self._preempt_youngest():
                    break
                if self._slots[i].request is None:
                    break  # preempted ourselves: lane skipped
            if self._slots[i].request is None or not self._ensure_blocks(
                    i, upto):
                continue
            lanes.append(i)
        # A LATER lane's block pressure may have preempted an EARLIER
        # collected lane (youngest-first victim choice): drop lanes
        # whose slot no longer holds a request.
        return [i for i in lanes
                if self._slots[i].request is not None
                and self._slots[i].remaining_prompt is not None]

    def _decode_phase(self) -> None:
        """Grow every decoding slot's table by the block its next token
        needs (preempting under pool pressure), then one batched decode
        step and its sampling."""
        tracer = self._tracer
        with maybe_span(tracer, "serve.decode.plan"):
            lengths_now = self.cache.lengths.clone()
            for i, slot in enumerate(self._slots):
                if not self._has_pending[i] or slot.request is None:
                    continue
                while not self._ensure_blocks(i, int(lengths_now[i]) + 1):
                    if not self._preempt_youngest():
                        raise RuntimeError(
                            "paged pool exhausted with nothing to preempt")
                    if self._slots[i].request is None:
                        break  # we preempted ourselves; skip this row
        replays = self.decode_graph_replays
        with maybe_span(tracer, "serve.decode.step") as span:
            logits, self.cache = self._decode(
                self.params, self.cache, torch.from_numpy(self.tables),
                torch.from_numpy(self._pending_token),
                torch.from_numpy(self._has_pending))
            if span is not None:
                tracer.annotate(span,
                                graph=self.decode_graph_replays > replays)
        with maybe_span(tracer, "serve.decode.sample"):
            self._take_decoded(logits)
