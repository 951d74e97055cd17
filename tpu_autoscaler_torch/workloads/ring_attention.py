"""Ring attention on PyTorch: sequence-parallel causal attention over a
list of devices, one per rank.

The counterpart of the JAX package's ``workloads/ring_attention.py``.
The JAX code shards the sequence over a mesh axis inside ``shard_map``
and rotates K/V blocks with ``ppermute``.  Here one process holds the
sequence-parallel axis as a list of devices: rank r's shard lives on
``devices[r]``, and a hop hands the visiting K/V block to the next rank
with ``.to(devices[r + 1])``, a peer copy where the ranks sit on
different cards and nothing where they share one (the counterpart of
the JAX package's virtual devices).  Each rank folds the blocks it sees
into an online-softmax carry (m, l, acc), so no [s, s] score matrix
exists anywhere.

Keys may carry fewer heads than queries (GQA/MQA), and ``window=w``
(causal only) keeps each query's w most recent keys, with hops wholly
outside the window skipped.  ``_hop_mode`` and ``_ring_driver`` are the
one schedule both merges run: the einsum merge (``_ring_attn_local``,
f32 and differentiable by autograd) and the kernel merge
(``ring_flash_step``, K5), whose backward is a second ring of
``ring_flash_bwd_step`` (K6) from the forward's saved lse.
"""

from __future__ import annotations

import torch

from tpu_autoscaler_torch.workloads.attention import (
    _delta,
    _validate_attention_args,
    ring_flash_bwd_step,
    ring_flash_step,
    ring_hop_mask,
)

NEG_INF = -1e30


def _hop_mode(src: int, my_idx: int, s_loc: int, causal: bool,
              window) -> tuple[int, int]:
    """(mode, offset) for the hop whose visiting K/V block originated at
    rank ``src``: mode 0 = invisible (skip the merge entirely), 1 =
    partially masked (apply the causal/window mask), 2 = fully visible.
    offset = global(q block start) - global(k block start) =
    (my - src)·s_loc, the single number the element-level mask needs.

    Causality hides src > my.  A window additionally hides blocks whose
    NEWEST key is already >= window behind this block's OLDEST query
    (offset - (s_loc-1) >= w), and forces masking on the diag block and
    on any block the window cuts through (offset + s_loc - 1 >= w)."""
    offset = (my_idx - src) * s_loc
    if not causal:
        return 2, offset  # window requires causal (validated)
    skip = src > my_idx
    needs_mask = offset == 0
    if window is not None:
        skip |= offset - (s_loc - 1) >= window
        needs_mask |= offset + s_loc - 1 >= window
    return (0 if skip else 1 if needs_mask else 2), offset


def _rotate(blocks: list, devices: list) -> list:
    """One hop around the ring: rank r receives rank r - 1's block."""
    world = len(devices)
    return [blocks[(r - 1) % world].to(devices[r]) for r in range(world)]


def _ring_driver(qs, ks, vs, devices, *, causal: bool, window, merge):
    """The ring schedule, shared by the einsum and the kernel merges.

    ``merge(r, k_t, v_t, m, l, acc, offset=, masked=)`` folds one
    visiting K/V block into rank r's online-softmax carry; the driver
    owns everything else (which block each rank holds at each hop, the
    hop-visibility dispatch, where invisible hops are SKIPPED, not
    masked, the rotation, the carry's start and the final
    normalisation), so the two merges cannot drift apart on schedule or
    numerics.

    Returns per rank (out [b, h, s_loc, d] in q's dtype, lse [b, h,
    s_loc, 1] f32): the log-sum-exp the backward ring needs."""
    world = len(devices)
    b, h, s_loc, d = qs[0].shape
    carries = [(torch.full((b, h, s_loc, 1), NEG_INF, dtype=torch.float32,
                           device=dev),
                torch.zeros((b, h, s_loc, 1), dtype=torch.float32,
                            device=dev),
                torch.zeros((b, h, s_loc, d), dtype=torch.float32,
                            device=dev)) for dev in devices]
    k_t, v_t = list(ks), list(vs)
    for t in range(world):
        for r in range(world):
            # Rank r holds the block that originated at rank r - t.
            mode, offset = _hop_mode((r - t) % world, r, s_loc, causal,
                                     window)
            if mode:
                carries[r] = merge(r, k_t[r], v_t[r], *carries[r],
                                   offset=offset, masked=mode == 1)
        if t < world - 1:
            k_t, v_t = _rotate(k_t, devices), _rotate(v_t, devices)
    outs, lses = [], []
    for q, (m, l, acc) in zip(qs, carries):
        l_safe = l.clamp_min(1e-30)
        outs.append((acc / l_safe).to(q.dtype))
        lses.append(m + torch.log(l_safe))
    return outs, lses


def _ring_attn_local(qs, ks, vs, devices, *, causal: bool, window):
    """The ring with the einsum merge: f32 scores (q scaled by d^-0.5
    first), the f32 grouped einsum (K/V never repeated for GQA), the
    mask of :func:`~attention.ring_hop_mask`; differentiable end to end
    by autograd, the rotations included."""
    b, h, s_loc, d = qs[0].shape
    hkv = ks[0].shape[1]
    g = h // hkv
    qf5 = [(q.float() * d ** -0.5).reshape(b, hkv, g, s_loc, d) for q in qs]

    def merge(r, k_t, v_t, m, l, acc, *, offset, masked):
        scores = torch.einsum("bngqd,bnkd->bngqk", qf5[r],
                              k_t.float()).reshape(b, h, s_loc, -1)
        if masked:
            keep = ring_hop_mask(s_loc, scores.shape[-1], offset, window,
                                 scores.device)
            scores = torch.where(keep, scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        p = torch.exp(scores - m_new)
        correction = torch.exp(m - m_new)
        l_new = l * correction + p.sum(dim=-1, keepdim=True)
        pv = torch.einsum("bngqk,bnkd->bngqd",
                          p.reshape(b, hkv, g, s_loc, -1),
                          v_t.float()).reshape(b, h, s_loc, d)
        return m_new, l_new, acc * correction + pv

    return _ring_driver(qs, ks, vs, devices, causal=causal, window=window,
                        merge=merge)


def _ring_attn_local_kernel(qs, ks, vs, devices, *, causal: bool, window):
    """The same ring schedule with each hop's merge in ``ring_flash_step``
    (K5 on CUDA tensors, its plain version on CPU tensors): the JAX
    package's ``_ring_attn_local_pallas``."""
    def merge(r, k_t, v_t, m, l, acc, *, offset, masked):
        return ring_flash_step(qs[r], k_t, v_t, m, l, acc, offset=offset,
                               masked=masked, window=window)

    return _ring_driver(qs, ks, vs, devices, causal=causal, window=window,
                        merge=merge)


def _ring_bwd_local_kernel(qs, ks, vs, dos, lses, deltas, devices, *,
                           causal: bool, window):
    """The backward ring (the JAX package's ``_ring_bwd_local_pallas``):
    the same hop schedule run once more, each hop's dq/dk/dv from
    ``ring_flash_bwd_step`` (K6 on CUDA tensors) rebuilding P from the
    forward's saved lse, not from a forward recompute.  dq accumulates on
    its rank; dk/dv accumulate in f32 buffers that rotate WITH their K/V
    block, so after ``world`` hops each block's gradient is home."""
    world = len(devices)
    b, h, s_loc, d = qs[0].shape
    hkv = ks[0].shape[1]

    def zeros(heads, dev):
        return torch.zeros((b, heads, s_loc, d), dtype=torch.float32,
                           device=dev)

    dqs = [zeros(h, dev) for dev in devices]
    dk_t = [zeros(hkv, dev) for dev in devices]
    dv_t = [zeros(hkv, dev) for dev in devices]
    k_t, v_t = list(ks), list(vs)
    for t in range(world):
        for r in range(world):
            mode, offset = _hop_mode((r - t) % world, r, s_loc, causal,
                                     window)
            if not mode:
                continue
            dq_add, dk_add, dv_add = ring_flash_bwd_step(
                qs[r], k_t[r], v_t[r], dos[r], lses[r], deltas[r],
                offset=offset, masked=mode == 1, window=window)
            dqs[r] += dq_add
            dk_t[r] += dk_add
            dv_t[r] += dv_add
        if t < world - 1:
            k_t, v_t = _rotate(k_t, devices), _rotate(v_t, devices)
        dk_t, dv_t = _rotate(dk_t, devices), _rotate(dv_t, devices)
    return ([dq.to(q.dtype) for dq, q in zip(dqs, qs)],
            [dk.to(k.dtype) for dk, k in zip(dk_t, ks)],
            [dv.to(v.dtype) for dv, v in zip(dv_t, vs)])


class _RingAttention(torch.autograd.Function):
    """The JAX package's ``custom_vjp`` around the kernel ring, over all
    ranks at once: the forward runs the K5 ring and saves each rank's q,
    k, v, out and f32 lse; the backward computes delta = rowsum(do * out)
    and runs the K6 ring on exactly those tensors.  Arguments after
    (devices, causal, window) are the ranks' q shards, then k, then v."""

    @staticmethod
    def forward(ctx, devices, causal, window, *shards):
        world = len(devices)
        qs, ks, vs = (list(shards[i * world:(i + 1) * world])
                      for i in range(3))
        outs, lses = _ring_attn_local_kernel(qs, ks, vs, devices,
                                             causal=causal, window=window)
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        ctx.devices, ctx.causal, ctx.window = devices, causal, window
        return tuple(outs)

    @staticmethod
    def backward(ctx, *douts):
        world = len(ctx.devices)
        saved = ctx.saved_tensors
        qs, ks, vs, outs, lses = (list(saved[i * world:(i + 1) * world])
                                  for i in range(5))
        dos = [torch.zeros_like(o) if do is None else do.contiguous()
               for do, o in zip(douts, outs)]
        deltas = [_delta(o, do) for o, do in zip(outs, dos)]
        dqs, dks, dvs = _ring_bwd_local_kernel(
            qs, ks, vs, dos, lses, deltas, ctx.devices, causal=ctx.causal,
            window=ctx.window)
        return (None, None, None, *dqs, *dks, *dvs)


def make_local_ring_attention(devices, *, causal: bool = True,
                              window: int | None = None):
    """The kernel ring for a caller that already holds the shards (the
    SP train step embeds it in a full model step): ``attn(qs, ks, vs) ->
    outs``, lists with one [b, h, s_loc, d] (k/v: [b, kv_heads, s_loc,
    d]) shard per rank on its device, differentiable through one
    ``torch.autograd.Function`` whose backward is the K6 ring.

    Validates like the JAX function: window requires causal at build
    time (``_hop_mode`` treats causal=False as fully visible and would
    silently ignore the window), and the shapes of each rank's shards
    at every call."""
    if window is not None and (not causal or window < 1):
        raise ValueError(
            f"window={window} requires causal=True and window >= 1")
    devices = list(devices)

    def attn(qs, ks, vs):
        if not len(qs) == len(ks) == len(vs) == len(devices):
            raise ValueError(f"one q, k and v shard per rank: {len(devices)}"
                             f" ranks, got {len(qs)}, {len(ks)}, {len(vs)}")
        for q, k, v in zip(qs, ks, vs):
            _validate_attention_args(q, k, v, causal, window)
        shards = [t.contiguous() for t in (*qs, *ks, *vs)]
        return list(_RingAttention.apply(devices, causal, window, *shards))

    return attn


def _shard(t: torch.Tensor, devices: list) -> list:
    """[b, h, s, d] cut into len(devices) sequence shards, shard r moved
    to devices[r]."""
    return [c.to(dev) for c, dev in zip(t.chunk(len(devices), dim=2),
                                        devices)]


def make_ring_attention(devices, causal: bool = True, impl: str = "einsum",
                        window: int | None = None):
    """A ring-attention callable on GLOBAL q [b, h, s, d] and k, v [b,
    kv_heads, s, d]: the sequence is cut into one shard per rank of
    ``devices`` (rank r on ``devices[r]``; repeat a device to put several
    ranks on it), run through the ring, and the output concatenated on
    q's device.

    ``kv_heads`` may divide ``h`` (GQA; MQA at 1).  ``window=w``
    (requires causal) is sliding-window attention with out-of-window hops
    skipped.

    ``impl``:

    - ``"einsum"`` (default): f32 per-hop math, differentiable end to end
      through the ring by autograd.
    - ``"pallas"`` (the JAX name, kept so a JAX call carries over): each
      hop's merge is ``ring_flash_step`` (K5, the CUDA kernel on CUDA
      shards, its plain version on CPU shards), and the backward is a
      second ring of ``ring_flash_bwd_step`` (K6) rebuilding P from the
      saved log-sum-exp: the recompute-p flash backward, not a forward
      recompute."""
    if impl not in {"einsum", "pallas"}:
        raise ValueError(f"unknown ring attention impl {impl!r}")
    devices = [torch.device(dev) for dev in devices]
    local = (make_local_ring_attention(devices, causal=causal, window=window)
             if impl == "pallas" else None)

    def attn(q, k, v):
        _validate_attention_args(q, k, v, causal, window)
        if q.shape[2] % len(devices):
            raise ValueError(
                f"sequence length {q.shape[2]} must divide by the ring's "
                f"{len(devices)} ranks")
        qs, ks, vs = (_shard(t, devices) for t in (q, k, v))
        if local is None:
            outs = _ring_attn_local(qs, ks, vs, devices, causal=causal,
                                    window=window)[0]
        else:
            outs = local(qs, ks, vs)
        return torch.cat([o.to(q.device) for o in outs], dim=2)

    return attn
