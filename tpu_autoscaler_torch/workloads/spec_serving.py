"""Speculative decoding inside the continuous-batching paged engine.

The PyTorch counterpart of the JAX package's ``workloads/spec_serving.py``,
on one device or under a mesh (the draft placed and its pool cut like
the target's).  decode.py's speculative generators serve one batch that
shares one cache length, so mixed accept lengths truncate to the batch
minimum.  The paged engine keeps a length PER SLOT, so each sequence
accepts its own number of draft tokens every round:

- the DRAFT model holds a mirrored paged cache (its own pool, tables
  and allocator, the same slot structure); every engine tick it
  proposes up to ``k`` tokens per active slot in k batched decode steps
  (each reads the draft pool through the ``paged_flash_decode`` kernel
  on a CUDA device);
- the TARGET scores every slot's ``[pending, d1..dk]`` block in ONE
  multi-token call (``make_paged_prefill`` with ``return_all_logits``,
  the verification primitive), writing the block into its pool as it
  scores;
- acceptance runs per slot on the host (greedy: argmax match, so the
  output is the target's greedy stream; sampled: min(1, p/q) accept
  and a residual resample, both distributions warped by the request's
  temperature/top-k/top-p), drawing from ``np.random.default_rng(seed)``
  as the JAX engine does;
- the cache "rewind" is free: per-slot lengths advance by the emitted
  count, and rejected draft writes beyond the new length are overwritten
  before they can become visible; the draft cache replays its one
  missing token on full acceptance.

Per round a slot emits between 1 and k+1 tokens for ONE target pass.
The engine reports ``target_pass_ratio`` (verify passes per decoded
token; plain decode is 1.0) and ``accept_rate``.

As in the port's paged engine, cache lengths live on the host and are
updated in place (the JAX engine rebuilds its ``PagedKVCache``).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_autoscaler_torch.workloads.model import (
    Mesh,
    ModelConfig,
    cast_params,
    place_params,
)
from tpu_autoscaler_torch.workloads.paged import (
    BlockAllocator,
    PagedBatcher,
    make_paged_decode_step,
    make_paged_prefill,
)
from tpu_autoscaler_torch.workloads.serving import Request

__all__ = ["SpeculativePagedBatcher", "Request"]


def _np_warp(logits: np.ndarray, temperature: float, top_k, top_p):
    """numpy twin of decode._warp_logits (host-side accept math must
    use the SAME warping the device samplers use)."""
    scaled = logits.astype(np.float64) / temperature
    if top_k is not None:
        kth = np.partition(scaled, -top_k)[-top_k]
        scaled = np.where(scaled < kth, -np.inf, scaled)
    if top_p is not None:
        order = np.argsort(scaled)[::-1]
        sorted_l = scaled[order]
        exp = np.exp(sorted_l - sorted_l[0])
        probs = exp / exp.sum()
        cum = np.cumsum(probs)
        keep = (cum - probs) < top_p
        cutoff = sorted_l[np.sum(keep) - 1]
        scaled = np.where(scaled < cutoff, -np.inf, scaled)
    return scaled


def _np_probs(logits: np.ndarray, temperature: float, top_k, top_p):
    warped = _np_warp(logits, temperature, top_k, top_p)
    warped = warped - warped.max()
    e = np.exp(warped)
    return e / e.sum()


class SpeculativePagedBatcher(PagedBatcher):
    """PagedBatcher whose decode phase is draft-propose / target-verify.

    ``draft_params``/``draft_cfg``: the cheap proposer (same vocab;
    typically fewer layers).  ``k``: draft tokens per round (capped per
    slot by its remaining budget, so the last round degenerates to a
    plain decode step and cache bounds are never exceeded; must be
    < chunk so the block-accounting slack still covers the verify
    look-ahead).  ``seed``: the host generator of the sampled accept
    math.
    """

    def __init__(self, params, cfg: ModelConfig, draft_params,
                 draft_cfg: ModelConfig | None = None, *, k: int = 4,
                 slots: int = 4, max_len: int = 256,
                 block_size: int = 16, num_blocks: int | None = None,
                 chunk: int = 32, prefill_lanes: int = 2, device=None,
                 generator: torch.Generator | None = None, seed: int = 0,
                 slo_ticks: int | None = None, reqtrace=None,
                 mesh: Mesh | None = None, tracer=None):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if k >= chunk:
            raise ValueError(
                f"k ({k}) must be < chunk ({chunk}): the accounting "
                "slack and the draft replay call are chunk-sized")
        self.k = k
        self.draft_cfg = draft_cfg if draft_cfg is not None else cfg
        if self.draft_cfg.vocab != cfg.vocab:
            raise ValueError(
                f"draft vocab {self.draft_cfg.vocab} != target vocab "
                f"{cfg.vocab}")
        self._draft_params_in = draft_params
        self._spec_rng = np.random.default_rng(seed)
        self.verify_passes = 0
        self.drafted_tokens = 0
        self.accepted_tokens = 0
        super().__init__(params, cfg, slots=slots, max_len=max_len,
                         block_size=block_size, num_blocks=num_blocks,
                         chunk=chunk, prefill_lanes=prefill_lanes,
                         device=device, generator=generator,
                         slo_ticks=slo_ticks, reqtrace=reqtrace, mesh=mesh,
                         tracer=tracer)

    def _trace_finish_attrs(self, req) -> dict:
        """Speculative economics on the request's root span: the
        engine-wide accept rate / pass ratio as of this completion (the
        decode span already carries its batched tick count, so a
        slow-decode tail can be told apart from a cold draft)."""
        return {"accept_rate": round(self.accept_rate, 4),
                "target_pass_ratio": round(self.target_pass_ratio, 4)}

    # ---- device state ---------------------------------------------------

    def _build_device_state(self, cfg, slots, max_len, chunk, ring) -> None:
        super()._build_device_state(cfg, slots, max_len, chunk, ring)
        dcfg, mesh = self.draft_cfg, self.mesh
        # Under a mesh the draft is placed like the target, and its
        # pool cut like the target's (the JAX engine's draft
        # re-placement).
        self.draft_params = (
            cast_params(self._draft_params_in, dcfg.dtype, self.device)
            if mesh is None else
            place_params(mesh, dcfg, self._draft_params_in))
        self.d_allocator = BlockAllocator(self._num_blocks)
        self.d_tables = np.full((slots, self.blocks_per_row), -1, np.int32)
        self.d_cache = self._pool(dcfg, self.draft_params)
        self._d_decode = make_paged_decode_step(dcfg, max_len, mesh)
        self._d_prefill = make_paged_prefill(dcfg, chunk,
                                             self.prefill_lanes, max_len,
                                             mesh=mesh)
        # Draft replay: per-slot short appends after full acceptance.
        self._d_replay = make_paged_prefill(dcfg, chunk, slots, max_len,
                                            mesh=mesh)
        self._verify = make_paged_prefill(cfg, self.k + 1, slots, max_len,
                                          return_all_logits=True, mesh=mesh)

    # ---- draft block management ----------------------------------------

    def _d_ensure_blocks(self, i: int, upto_tokens: int) -> bool:
        need = -(-upto_tokens // self.block_size)
        row = self.d_tables[i]
        have = int((row >= 0).sum())
        while have < need:
            b = self.d_allocator.alloc()
            if b is None:
                return False
            row[have] = b
            have += 1
        return True

    def _release_slot(self, i: int) -> None:
        super()._release_slot(i)
        self.d_allocator.free(self.d_tables[i][self.d_tables[i] >= 0])
        self.d_tables[i] = -1
        self.d_cache.lengths[i] = 0

    def _kv_usage(self) -> tuple[int, int]:
        """Target pool plus the mirrored draft pool: both are real
        device-memory pressure the KV-occupancy signal should see."""
        t_used, t_cap = super()._kv_usage()
        return (t_used + self.d_allocator.used_blocks * self.block_size,
                t_cap + self.d_allocator.num_blocks * self.block_size)

    def check_accounting(self) -> None:
        super().check_accounting()
        live = self.live_tokens()
        used = self.d_allocator.used_blocks * self.block_size
        live_seqs = sum(1 for s in self._slots if s.request is not None)
        slack = live_seqs * (self.block_size + self.chunk)
        if used > live + slack:
            raise AssertionError(
                f"draft paged accounting violated: {used} for {live} live "
                f"(+{slack})")

    # ---- prefill mirror -------------------------------------------------

    def _after_prefill(self, served: list) -> None:
        """Replay the target's prefill chunks into the draft cache (the
        draft must hold the same prefix to propose from), BEFORE
        completion checks can release the slots."""
        live = [(i, buf, take, off) for i, buf, take, off in served
                if self._slots[i].request is not None]
        for i, _, _, off in live:
            d_len = int(self.d_cache.lengths[i])
            if d_len != off:
                raise AssertionError(
                    f"draft cache desynced on slot {i}: {d_len} != {off}")
        ok_lanes = []
        for i, buf, take, off in live:
            while not self._d_ensure_blocks(i, off + take):
                if not self._preempt_youngest():
                    break
                if self._slots[i].request is None:
                    break
            if self._slots[i].request is None:
                continue
            if self._d_ensure_blocks(i, off + take):
                ok_lanes.append((i, buf, take, off))
            else:
                # The target got its chunk but the draft cannot: the
                # caches would desync, so the slot goes back to the
                # queue (a fresh prefill re-enters both together).
                self._preempt_slot(i)
        # A LATER lane's pressure may have preempted an EARLIER
        # collected lane: advancing a freed slot's draft length would
        # desync its next occupant.
        ok_lanes = [(i, buf, take, off) for i, buf, take, off in ok_lanes
                    if self._slots[i].request is not None]
        if ok_lanes:
            tok = np.zeros((self.prefill_lanes, self.chunk), np.int64)
            offs = np.zeros((self.prefill_lanes,), np.int32)
            nval = np.zeros((self.prefill_lanes,), np.int32)
            tabs = np.full((self.prefill_lanes, self.blocks_per_row), -1,
                           np.int32)
            for lane, (i, buf, take, off) in enumerate(ok_lanes):
                tok[lane] = buf
                offs[lane] = off
                nval[lane] = take
                tabs[lane] = self.d_tables[i]
            _, self.d_cache = self._d_prefill(
                self.draft_params, self.d_cache, torch.from_numpy(tabs),
                torch.from_numpy(tok), torch.from_numpy(offs),
                torch.from_numpy(nval))
            for i, _, take, _ in ok_lanes:
                self.d_cache.lengths[i] += take
        self._prefill_finish(served)

    # ---- the speculative decode phase ----------------------------------

    def _decode_phase(self) -> None:
        n_slots = len(self._slots)
        k = self.k
        # Per-slot draft budget: never overrun the request's remaining
        # token budget (k_eff=0 degenerates to a plain decode step).
        k_eff = np.zeros((n_slots,), np.int32)
        for i, slot in enumerate(self._slots):
            if not self._has_pending[i] or slot.request is None:
                continue
            remaining = slot.request.max_new_tokens - len(
                slot.request.generated)
            k_eff[i] = max(0, min(k, remaining - 1))

        # Block reservations: the target writes k_eff+1; the draft's
        # coverage includes the +1 replay position too, since on full
        # acceptance the replay writes at d_len+k_eff, which may start a
        # new block: without the reservation that write would be
        # dropped and the draft would attend over garbage there.
        lengths = self.cache.lengths.numpy().copy()
        d_lengths = self.d_cache.lengths.numpy().copy()
        for i, slot in enumerate(self._slots):
            if not self._has_pending[i] or slot.request is None:
                continue
            while not (self._ensure_blocks(
                    i, int(lengths[i]) + int(k_eff[i]) + 1)
                    and self._d_ensure_blocks(
                        i, int(d_lengths[i]) + int(k_eff[i]) + 1)):
                if not self._preempt_youngest():
                    raise RuntimeError(
                        "paged pool exhausted with nothing to preempt")
                if self._slots[i].request is None:
                    break
        active = np.array([
            bool(self._has_pending[i])
            and self._slots[i].request is not None
            for i in range(n_slots)])
        if not active.any():
            return
        lengths = self.cache.lengths.numpy().copy()
        d_lengths = self.d_cache.lengths.numpy().copy()
        if not (d_lengths[active] == lengths[active]).all():
            raise AssertionError("draft/target cache desync before verify")

        reqs = [s.request for s in self._slots]

        # ---- the draft proposes up to k tokens per slot ----
        drafts = np.zeros((k, n_slots), np.int64)
        # Draft distributions are needed only for sampled rows' accept
        # ratios: pure-greedy traffic never allocates the buffer.
        any_sampled = any(
            active[i] and reqs[i].temperature != 0.0
            for i in range(n_slots))
        qs = np.zeros((k, n_slots, self.cfg.vocab if any_sampled else 0),
                      np.float64)
        tok = self._pending_token.copy()
        d_tables = torch.from_numpy(self.d_tables)
        for r in range(k):
            round_active = active & (r < k_eff)
            if not round_active.any():
                break
            dlogits, self.d_cache = self._d_decode(
                self.draft_params, self.d_cache, d_tables,
                torch.from_numpy(tok), torch.from_numpy(round_active))
            dl = dlogits.cpu().numpy()
            for i in range(n_slots):
                if not round_active[i]:
                    continue
                req = reqs[i]
                if req.temperature == 0.0:
                    tok[i] = int(np.argmax(dl[i]))
                else:
                    q = _np_probs(dl[i], req.temperature, req.top_k,
                                  req.top_p)
                    qs[r, i] = q
                    tok[i] = int(self._spec_rng.choice(len(q), p=q))
                drafts[r, i] = tok[i]
                self.drafted_tokens += 1

        # ---- one target pass scores [pending, d1..dk] per slot ----
        ver_tok = np.zeros((n_slots, k + 1), np.int64)
        ver_tok[:, 0] = self._pending_token
        ver_tok[:, 1:] = drafts.T
        nval = np.where(active, k_eff + 1, 0).astype(np.int32)
        vlogits, self.cache = self._verify(
            self.params, self.cache, torch.from_numpy(self.tables),
            torch.from_numpy(ver_tok), torch.from_numpy(lengths),
            torch.from_numpy(nval))
        T = vlogits.cpu().numpy()                  # [slots, k+1, vocab]
        self.verify_passes += 1

        # ---- per-slot accept / emit / advance ----
        replay: list[tuple[int, int, int]] = []    # (slot, token, offset)
        for i in range(n_slots):
            if not active[i]:
                continue
            req = reqs[i]
            ke = int(k_eff[i])
            emitted, n_acc = self._accept_row(T[i], drafts[:, i],
                                              qs[:, i], req, ke)
            # eos truncation: stop at the first eos emitted.
            if req.eos_id is not None:
                for j, t in enumerate(emitted):
                    if t == req.eos_id:
                        emitted = emitted[:j + 1]
                        break
            # Accepted-token accounting AFTER truncation: drafts past
            # the eos were never used.
            self.accepted_tokens += min(n_acc, len(emitted))
            req.generated.extend(emitted)
            self.decode_tokens += len(emitted)
            m = len(emitted)
            # Cache advance: the pending token committed (+1) plus the
            # m-1 emitted tokens before the new pending: len + m.
            self.cache.lengths[i] = int(lengths[i]) + m
            self._pending_token[i] = emitted[-1]
            # The draft cache holds [pending, d1..d_{ke-1}] past its old
            # length: valid up to old+min(ke, m); the next pending
            # writes at old+m, so replay the gap (at most one token, on
            # full acceptance).
            target_new = int(lengths[i]) + m
            d_new = min(int(d_lengths[i]) + min(ke, m), target_new)
            self.d_cache.lengths[i] = d_new
            if d_new < target_new:
                # Missing exactly one token: position len+m-1, whose
                # content is ver_tok[m-1] (the pending token when
                # k_eff=0, else the last accepted draft).
                if target_new - d_new != 1:
                    raise AssertionError(
                        f"draft replay of {target_new - d_new} tokens on "
                        f"slot {i}")
                replay.append((i, int(ver_tok[i, m - 1]), d_new))

        if replay:
            tokb = np.zeros((n_slots, self.chunk), np.int64)
            offs = np.zeros((n_slots,), np.int32)
            nvalr = np.zeros((n_slots,), np.int32)
            for i, t, off in replay:
                tokb[i, 0] = t
                offs[i] = off
                nvalr[i] = 1
            _, self.d_cache = self._d_replay(
                self.draft_params, self.d_cache, d_tables,
                torch.from_numpy(tokb), torch.from_numpy(offs),
                torch.from_numpy(nvalr))
            for i, _, _ in replay:
                self.d_cache.lengths[i] += 1

        for i in range(n_slots):
            if active[i]:
                self._finish_if_done(i)

    def _accept_row(self, T, drafts_i, qs_i, req, k_eff):
        """One slot's accept/emit decision.  T: [k+1, vocab] target
        logits (T[j] = next-token distribution after pending, d1..dj);
        drafts_i: [k]; qs_i: [k, vocab] warped draft probs (sampled
        rows only).  Returns (emitted tokens, n_accepted)."""
        if req.temperature == 0.0:
            emitted = []
            for j in range(k_eff):
                t = int(np.argmax(T[j]))
                emitted.append(t)
                if t != int(drafts_i[j]):
                    return emitted, j
            emitted.append(int(np.argmax(T[k_eff])))
            return emitted, k_eff
        emitted = []
        for j in range(k_eff):
            p = _np_probs(T[j], req.temperature, req.top_k, req.top_p)
            d = int(drafts_i[j])
            q = qs_i[j]
            if self._spec_rng.uniform() * q[d] < p[d]:
                emitted.append(d)
                continue
            residual = np.maximum(p - q, 0.0)
            rs = residual.sum()
            # rs == 0 can only arise when acceptance was certain (p <= q
            # everywhere means p == q); the p fallback keeps choice()
            # total.
            residual = residual / rs if rs > 0 else p
            emitted.append(int(self._spec_rng.choice(
                len(residual), p=residual)))
            return emitted, j
        p = _np_probs(T[k_eff], req.temperature, req.top_k, req.top_p)
        emitted.append(int(self._spec_rng.choice(len(p), p=p)))
        return emitted, k_eff

    @property
    def target_pass_ratio(self) -> float:
        """Target forward passes per decoded token (plain decode: 1.0;
        the speculative win at decode-bound scale)."""
        return self.verify_passes / max(1, self.decode_tokens)

    @property
    def accept_rate(self) -> float:
        return self.accepted_tokens / max(1, self.drafted_tokens)
