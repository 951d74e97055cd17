"""Ulysses-style sequence parallelism on PyTorch: an all-to-all of the
rank lists, then local flash attention over the full sequence.

The counterpart of the JAX package's ``workloads/ulysses.py``, the
second sequence-parallel strategy beside the ring
(``ring_attention.py``).  The JAX code re-shards [b, h, s/sp, d]
activations to [b, h/sp, s, d] with one ``all_to_all``, runs the
single-device attention at full sequence on its heads, and restores the
sequence sharding with a second ``all_to_all``.  Here the ranks are a
list of devices in one process, so the all-to-all is a regrouping of
the rank lists: rank r takes heads [r·h/P, (r+1)·h/P) of every rank's
sequence shard, moved with ``.to(devices[r])``.

Constraint: the head counts must divide by the number of ranks (h % sp
== 0 and, for GQA, kv_heads % sp == 0).  The ring has no such
constraint; that is the structural reason to keep both.
"""

from __future__ import annotations

import torch

from tpu_autoscaler_torch.workloads.attention import (
    _validate_attention_args,
    flash_attention,
    reference_attention,
)
from tpu_autoscaler_torch.workloads.ring_attention import _shard


def _ulysses_local(qs, ks, vs, devices, *, causal: bool,
                   window: int | None, impl: str):
    """The ranks' sequence shards (q [b, h, s_loc, d]; k/v [b, hkv,
    s_loc, d], rank r's on ``devices[r]``) through the all-to-all, local
    attention over the full sequence on each rank's heads, and the
    inverse all-to-all: returns each rank's output shard [b, h, s_loc,
    d].  ``impl="pallas"`` attends with ``flash_attention`` (K1 forward
    and K2 backward on CUDA tensors, their plain versions on CPU
    tensors), ``"einsum"`` with :func:`~attention.reference_attention`
    (f32 scores, softmax and PV, as the JAX package's einsum branch)."""
    world = len(devices)

    def to_heads(shards):
        n = shards[0].shape[1] // world
        return [torch.cat([s[:, r * n:(r + 1) * n].to(devices[r])
                           for s in shards], dim=2) for r in range(world)]

    outs = []
    for q, k, v in zip(to_heads(qs), to_heads(ks), to_heads(vs)):
        if impl == "pallas":
            outs.append(flash_attention(q.contiguous(), k.contiguous(),
                                        v.contiguous(), causal=causal,
                                        window=window))
        else:
            outs.append(reference_attention(q, k, v, causal=causal,
                                            window=window))
    s_loc = qs[0].shape[2]
    return [torch.cat([o[:, :, j * s_loc:(j + 1) * s_loc].to(devices[j])
                       for o in outs], dim=1) for j in range(world)]


def make_ulysses_attention(devices, causal: bool = True,
                           window: int | None = None, impl: str = "pallas"):
    """An all-to-all sequence-parallel attention callable on GLOBAL q
    [b, h, s, d] and k, v [b, kv_heads, s, d], with the contract of
    ``make_ring_attention``: the sequence is cut into one shard per rank
    of ``devices``, and the output concatenated on q's device.  GQA
    layouts pass through to the local attention.

    ``impl="pallas"`` (default, the JAX name) attends locally with
    ``flash_attention``: differentiable end to end, since both the
    Function and the regrouping have gradients.  ``impl="einsum"`` with
    ``reference_attention``."""
    if impl not in {"einsum", "pallas"}:
        raise ValueError(f"unknown ulysses attention impl {impl!r}")
    devices = [torch.device(dev) for dev in devices]
    sp = len(devices)

    def attn(q, k, v):
        # The global shapes' rules hold per rank once the head counts
        # divide sp.
        _validate_attention_args(q, k, v, causal, window)
        h, hkv = q.shape[1], k.shape[1]
        if h % sp or hkv % sp:
            raise ValueError(
                f"ulysses needs heads divisible by the 'sp' axis (size "
                f"{sp}): got {h} q heads / {hkv} kv heads — use ring "
                f"attention for indivisible head counts")
        if q.shape[2] % sp:
            raise ValueError(f"sequence length {q.shape[2]} must divide by "
                             f"the 'sp' axis (size {sp})")
        qs, ks, vs = (_shard(t, devices) for t in (q, k, v))
        outs = _ulysses_local(qs, ks, vs, devices, causal=causal,
                              window=window, impl=impl)
        return torch.cat([o.to(q.device) for o in outs], dim=2)

    return attn
