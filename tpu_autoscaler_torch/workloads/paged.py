"""Paged KV cache + batched prefill: the serving engine's memory system.

The PyTorch counterpart of the JAX package's ``workloads/paged.py``,
single device.  serving.py's SlotKVCache reserves ``slots x max_len``
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
block table.  Elsewhere (CPU tensors, or ``attention="einsum"``) the
rows are gathered into contiguous ``[rows, kv_heads, tpr*bs, head_dim]``
views and attended with the linear engine's einsum.  Prefill always
gathers and runs the einsum, as in the JAX package.

Differences from the JAX package, each for a reason:

- The pool is updated in place (PyTorch runs eagerly); the step
  functions still return the cache, so the call sites read alike.
- ``PagedKVCache.lengths`` lives on the host.  The scheduler reads the
  lengths several times a tick, and the steps need them on the host to
  place their writes; the steps upload them with the tables.
- JAX's scatters send inactive rows, pad lanes and table entries < 0 or
  >= num_blocks to an out-of-range index and let XLA drop the write
  (``mode="drop"``).  PyTorch has no such mode, so the write lists are
  filtered on the host before ``index_put_``.  An inactive decode row
  writes nothing: its slot may be in the middle of its prefill.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_autoscaler_torch.workloads.attention import (
    gather_pool_rows,
    paged_flash_decode,
)
from tpu_autoscaler_torch.workloads.model import (
    ModelConfig,
    _ffn_residual,
    _rmsnorm,
    _rotate,
    _split_qkv,
)
from tpu_autoscaler_torch.workloads.serving import (
    ContinuousBatcher,
    Request,
    _layer,
    _row_rope_tables,
    _slot_cached_attention,
)

__all__ = ["PagedKVCache", "BlockAllocator", "PagedBatcher", "Request",
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


def _token_writes(tables, positions, active, num_blocks: int,
                  block_size: int):
    """Where one decode step writes each row's new token, computed on
    the host: (rows, blocks, offsets), int64.  tables [rows, tpr];
    positions [rows] absolute; active [rows] bool.  Inactive rows, and
    rows whose table has no block there (< 0) or one past the pool,
    write nothing.  A position past the table lands in its last entry,
    as the JAX package's clipped index does."""
    tpr = tables.shape[1]
    positions = positions.long()
    rows = torch.arange(tables.shape[0])
    block = tables[rows, (positions // block_size).clamp(0, tpr - 1)].long()
    keep = active & (block >= 0) & (block < num_blocks)
    return rows[keep], block[keep], (positions % block_size)[keep]


def _scatter_token(pool, new, writes) -> None:
    """Write one token per row into one layer's pool [nb, hkv, bs, hd],
    in place; new [rows, hkv, 1, hd]; writes from :func:`_token_writes`
    (on the pool's device)."""
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


def make_paged_decode_step(cfg: ModelConfig, tokens_per_row: int):
    """Build ``step(params, cache, tables, tokens, active) -> (logits,
    cache)``: one token for every slot, written and read through the
    block tables.  tables: [slots, tokens_per_row // block_size] int32
    and active [slots] bool, on the host; tokens [slots] int.

    Returns logits [slots, vocab] f32 and the cache, its pool updated in
    place and active lengths advanced by 1.  Inactive rows write
    nothing; their logits are computed and ignored."""

    def step(params, cache: PagedKVCache, tables, tokens, active):
        _check_tables(tables, cache, tokens_per_row)
        dev = cache.k.device
        positions = cache.lengths
        # Per-step values every layer shares, computed once: the write
        # lists, the tables and lengths on the device, the rope tables.
        writes = [t.to(dev) for t in _token_writes(
            tables, positions, active, cache.num_blocks, cache.block_size)]
        dev_tables = tables.to(dev)
        dev_positions = positions.to(dev)
        new_len = dev_positions + 1
        x = params["embed"].to(cfg.dtype)[tokens.to(dev)][:, None, :]
        b, s, d = x.shape
        if cfg.rope:
            rope = _row_rope_tables(dev_positions, s, cfg.head_dim,
                                    cfg.rope_theta, cfg.dtype)
        for i in range(cfg.n_layers):
            layer = _layer(params, i)
            k_pool, v_pool = cache.k[i], cache.v[i]
            y = _rmsnorm(x, layer["ln1"])
            q, k, v = _split_qkv(y, layer["qkv"], cfg)
            if cfg.rope:
                q, k = _rotate(q, *rope), _rotate(k, *rope)
            _scatter_token(k_pool, k, writes)
            _scatter_token(v_pool, v, writes)
            attn = _paged_attend(q, k_pool, v_pool, dev_tables, new_len, cfg)
            attn = attn.transpose(1, 2).reshape(b, s, d)
            x = x + attn @ layer["attn_out"].to(cfg.dtype)
            y = _rmsnorm(x, layer["ln2"])
            x = _ffn_residual(x, y, layer, cfg)
        x = _rmsnorm(x, params["ln_f"])
        logits = x @ params["unembed"].to(cfg.dtype)
        cache.lengths += active.to(torch.int32)
        return logits[:, 0].float(), cache

    return step


def make_paged_prefill(cfg: ModelConfig, chunk: int, lanes: int,
                       tokens_per_row: int, return_all_logits: bool = False):
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
    every appended position's logits."""
    h, hkv, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim

    def fill(params, cache: PagedKVCache, tables, tokens, offsets, n_valid):
        _check_tables(tables, cache, tokens_per_row)
        if tokens.shape != (lanes, chunk):
            raise ValueError(f"tokens {tuple(tokens.shape)}: want "
                             f"[{lanes}, {chunk}]")
        dev = cache.k.device
        writes = [t.to(dev) for t in _chunk_writes(
            tables, offsets, n_valid, chunk, cache.num_blocks,
            cache.block_size)]
        dev_tables = tables.to(dev)
        dev_offsets = offsets.to(dev)
        x = params["embed"].to(cfg.dtype)[tokens.to(dev)]  # [lanes, chunk, d]
        b, s, d = x.shape
        # Each lane attends over its own gathered pages: causal within
        # the chunk plus everything before its offset.
        qpos = dev_offsets.long()[:, None] + torch.arange(s, device=dev)
        kpos = torch.arange(tokens_per_row, device=dev)
        visible = kpos[None, None, :] <= qpos[..., None]        # [b, s, T]
        if cfg.attention_window is not None:
            visible &= kpos[None, None, :] > qpos[..., None] \
                - cfg.attention_window
        if cfg.rope:
            rope = _row_rope_tables(dev_offsets, s, hd, cfg.rope_theta,
                                    cfg.dtype)
        for i in range(cfg.n_layers):
            layer = _layer(params, i)
            k_pool, v_pool = cache.k[i], cache.v[i]
            y = _rmsnorm(x, layer["ln1"])
            q, k, v = _split_qkv(y, layer["qkv"], cfg)     # [b, h, s, hd]
            if cfg.rope:
                q, k = _rotate(q, *rope), _rotate(k, *rope)
            _scatter_chunk(k_pool, k, writes)
            _scatter_chunk(v_pool, v, writes)
            k_rows = gather_pool_rows(k_pool, dev_tables)  # [b, hkv, T, hd]
            v_rows = gather_pool_rows(v_pool, dev_tables)
            qg = q.reshape(b, hkv, h // hkv, s, hd)
            scores = torch.einsum("bngqd,bnkd->bngqk", qg,
                                  k_rows) * hd ** -0.5
            scores = torch.where(visible[:, None, None], scores.float(),
                                 -1e30)
            probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
            attn = torch.einsum("bngqk,bnkd->bngqd", probs, v_rows)
            attn = attn.reshape(b, h, s, hd).transpose(1, 2).reshape(b, s, d)
            x = x + attn @ layer["attn_out"].to(cfg.dtype)
            y = _rmsnorm(x, layer["ln2"])
            x = _ffn_residual(x, y, layer, cfg)
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
                 slo_ticks: int | None = None, reqtrace=None):
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
                         ring=False, slo_ticks=slo_ticks, reqtrace=reqtrace)

    def _build_device_state(self, cfg, slots, max_len, chunk, ring) -> None:
        self.allocator = BlockAllocator(self._num_blocks)
        self.tables = np.full((slots, self.blocks_per_row), -1, np.int32)
        self.cache = PagedKVCache.zeros(cfg, self._num_blocks,
                                        self.block_size, slots, self.device)
        self._decode = make_paged_decode_step(cfg, max_len)
        self._prefill = make_paged_prefill(cfg, chunk, self.prefill_lanes,
                                           max_len)

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
        lanes = [i for i in lanes
                 if self._slots[i].request is not None
                 and self._slots[i].remaining_prompt is not None]
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
        logits, self.cache = self._prefill(
            self.params, self.cache, torch.from_numpy(tabs),
            torch.from_numpy(tok), torch.from_numpy(offs),
            torch.from_numpy(nval))
        for lane, i in enumerate(lanes):
            slot = self._slots[i]
            slot.remaining_prompt = slot.remaining_prompt[nval[lane]:]
            self.cache.lengths[i] += int(nval[lane])
            if len(slot.remaining_prompt) == 0:
                self._note_seeded(i, self._sample_host(logits[lane],
                                                       slot.request))
        return served

    def _decode_phase(self) -> None:
        """Grow every decoding slot's table by the block its next token
        needs (preempting under pool pressure), then one batched decode
        step and its sampling."""
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
        logits, self.cache = self._decode(
            self.params, self.cache, torch.from_numpy(self.tables),
            torch.from_numpy(self._pending_token).to(self.device),
            torch.from_numpy(self._has_pending))
        self._take_decoded(logits)
