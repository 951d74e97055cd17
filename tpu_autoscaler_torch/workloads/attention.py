"""Attention kernels: ``flash_attention`` (the whole-sequence forward
and its backward), the one-token ``flash_decode`` and
``paged_flash_decode``, the paged chunked prefill
``paged_flash_prefill``, and the ring-attention hop ``ring_flash_step``
and its backward ``ring_flash_bwd_step``, as CUDA kernels beside their
plain PyTorch versions, and the build that makes them.

``flash_attention`` keeps the signature and the layout of the JAX
package's ``workloads/attention.py::flash_attention``: q ``[b, h, s,
d]`` and k/v ``[b, kv_heads, s, d]``, causal by default, with an
optional sliding window; ``flash_attention_forward`` also returns the
f32 log-sum-exp ``[b, h, s, 1]``.  Inputs that require grad go through
one ``torch.autograd.Function`` whose backward is
``flash_attention_backward`` (the JAX ``_backward_pallas``: a dq kernel
and a dk/dv kernel that sums over the GQA group).  The kernels pick
their own tiles, so the JAX ``block_q``/``block_k`` are not part of the
signature.
``flash_decode`` keeps the signature and the layout of the JAX
package's ``workloads/attention.py::flash_decode``: q ``[b, h, 1, d]``
(the new token's queries, already rotated), caches ``[b, kv_heads,
max_len, d]`` with the new k/v already written, and ``length`` a scalar
or a per-row ``[b]`` count of filled positions.  ``paged_flash_decode``
keeps those of the JAX ``paged_flash_decode``: the same q, one layer's
block pools ``[num_blocks, kv_heads, block_size, d]``, per-row block
tables ``[slots, tpr]`` (-1 = no block) and lengths ``[slots]``.
``paged_flash_prefill`` has no JAX counterpart (the JAX package's
paged prefill gathers each lane's pages and runs an einsum): each
lane's chunk of queries ``[lanes, h, chunk, d]`` attends over its pages
of the same pools through ``tables [lanes, tpr]`` from its ``offsets``,
with ``n_valid`` real rows a lane and its padding rows as the JAX
prefill's einsum makes them.  ``paged_token_write`` is no attention: it
writes one decode step's new k/v of every slot into one layer's pools,
each row deciding on the device whether it writes (the JAX package's
dropping scatter), so the paged decode step keeps one shape.
``ring_flash_step`` and ``ring_flash_bwd_step`` keep those of the JAX
functions of the same names, less ``block_q`` and ``interpret``: one
rank's q against a visiting K/V block at a host-int ``offset``, merged
into (or differentiating) the f32 online-softmax carry.  On
CUDA tensors each launches its hand-written Hopper kernel (``csrc/``);
on CPU tensors it runs its plain PyTorch version.  There is no fallback
from one to the other: a CUDA tensor a kernel does not take raises.

Head dims: the kernels are built for KERNEL_HEAD_DIMS and take any
head_dim up to 256.  The whole-activation kernels (flash_attention, its
backward and the ring hops) run a head_dim outside the set zero-padded to
the next built width with the true scale (:func:`call_padded`); the
decode kernels and the paged prefill read the cache at its true width (a
padded copy would rewrite the cache every step).  In bf16,
flash_attention, its backward, the ring hops and the paged prefill run
on the tensor cores (wgmma + TMA, one forward tile and one pair of
backward tiles shared between the whole-sequence, the ring and the paged
prefill kernels); the decode kernels split each row's keys over a
thread-block cluster and run their bf16 products on ``mma.sync``; every
kernel in f32 runs on CUDA-core FMA.

The kernels are compiled by ``nvcc`` for ``sm_90a`` into shared
libraries with a plain C interface, at first use, under
``build/torch_kernels/`` of the checkout, and loaded with ``ctypes``.
Nothing here imports or builds anything at module import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

NEG_INF = -1e30

#: head_dim values every kernel is instantiated for; a call takes any
#: head_dim up to the last.
KERNEL_HEAD_DIMS = (32, 64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches per wrapper: each wrapper adds one where it launches
#: its kernel and nowhere else.  Callers zero and read them to show
#: that a path ran through the kernels.
LAUNCHES: dict[str, int] = {"flash_attention": 0,
                             "flash_attention_bwd_dq": 0,
                             "flash_attention_bwd_dkv": 0,
                             "flash_decode": 0, "paged_flash_decode": 0,
                             "ring_flash_step": 0, "ring_flash_bwd_dq": 0,
                             "ring_flash_bwd_dkv": 0,
                             "paged_flash_prefill": 0,
                             "paged_token_write": 0}

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
# C entry -> its source; entries of one source share its library.
KERNEL_SOURCES = {"flash_attention": CSRC / "flash_attention.cu",
                  "flash_attention_bwd_dq": CSRC / "flash_attention_bwd.cu",
                  "flash_attention_bwd_dkv": CSRC / "flash_attention_bwd.cu",
                  "flash_decode": CSRC / "flash_decode.cu",
                  "paged_flash_decode": CSRC / "paged_flash_decode.cu",
                  "ring_flash_step": CSRC / "ring_flash_step.cu",
                  "ring_flash_bwd_dq": CSRC / "ring_flash_bwd.cu",
                  "ring_flash_bwd_dkv": CSRC / "ring_flash_bwd.cu",
                  "paged_flash_prefill": CSRC / "paged_flash_prefill.cu",
                  "paged_token_write": CSRC / "paged_token_write.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Each library exports a C function of each entry's name: pointers
# (and the stream) as c_void_p, so ctypes never cuts them to 32 bits;
# the ints are followed by the float scale, then the device and stream.
_ARGTYPES = {name: [ctypes.c_void_p] * ptrs + [ctypes.c_int] * ints
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
             for name, ptrs, ints in (
                 ("flash_attention", 5, 8),
                 ("flash_attention_bwd_dq", 7, 8),
                 ("flash_attention_bwd_dkv", 8, 8),
                 ("flash_decode", 5, 8),
                 ("paged_flash_decode", 6, 9),
                 ("ring_flash_step", 9, 10),
                 ("ring_flash_bwd_dq", 7, 10),
                 ("ring_flash_bwd_dkv", 8, 10),
                 ("paged_flash_prefill", 7, 10),
                 ("paged_token_write", 7, 11))}
_LIBS: dict[Path, ctypes.CDLL] = {}
_ENTRIES: dict[str, object] = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def library_path(name: str) -> Path:
    """Where kernel entry ``name``'s library lives: named after its
    source and keyed by the hash of that source, the headers it may
    include (every ``csrc/*.cuh``) and the flags, so an edited source or
    header is rebuilt, never reused."""
    source = KERNEL_SOURCES[name]
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}-{digest.hexdigest()[:16]}.so"


def build_kernels(names=None) -> dict[str, dict]:
    """Compile the library of every named kernel entry that is not built
    yet, one ``nvcc`` per source, all started together.  Returns per
    source stem the build seconds (0.0 when already built) and the
    compiler's output (``-Xptxas -v`` register and shared-memory
    report).  Raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    outs = {library_path(name): KERNEL_SOURCES[name]
            for name in names or KERNEL_SOURCES}
    procs = {}
    t0 = time.perf_counter()
    for out, source in outs.items():
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        procs[out] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp)
    report = {source.stem: {"seconds": 0.0, "log": ""}
              for source in outs.values()}
    failed = []
    for out, (proc, tmp) in procs.items():
        stem = outs[out].stem
        log, _ = proc.communicate()
        report[stem] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{stem} (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return report


def _entry(name: str):
    """Kernel entry ``name`` as a typed ctypes function, its library
    built and loaded at first use."""
    fn = _ENTRIES.get(name)
    if fn is None:
        path = library_path(name)
        lib = _LIBS.get(path)
        if lib is None:
            if not path.exists():
                build_kernels([name])
            lib = _LIBS[path] = ctypes.CDLL(str(path))
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _ENTRIES[name] = fn
    return fn


def _row_lengths(length, b: int, device) -> torch.Tensor:
    """A scalar or [b] length as a contiguous [b] int32 tensor."""
    lengths = torch.as_tensor(length, dtype=torch.int32, device=device)
    return lengths.reshape(-1).expand(b).contiguous()


def _check_args(q, k_cache, v_cache, window, ring) -> None:
    b, h, sq, d = q.shape
    if sq != 1:
        raise ValueError(f"flash_decode is single-token (sq=1); got {sq}")
    if ring and window is None:
        raise ValueError("ring=True requires a window")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if k_cache.shape != v_cache.shape:
        raise ValueError(
            f"k/v shape mismatch: {k_cache.shape} vs {v_cache.shape}")
    if k_cache.dim() != 4 or k_cache.shape[0] != b \
            or k_cache.shape[3] != d or h % k_cache.shape[1]:
        raise ValueError(
            f"cache {tuple(k_cache.shape)} does not fit q "
            f"{tuple(q.shape)}: want [b, kv_heads, max_len, d] with "
            f"kv_heads dividing the query heads")


def _scale_of(q, scale):
    """The score scale: ``scale`` when given, else d^-0.5 of q's width."""
    return q.shape[-1] ** -0.5 if scale is None else scale


def _masked_decode(q, k_rows, v_rows, visible, scale=None):
    """The kernels' math in one pass over contiguous rows: q [b, h, 1,
    d], k/v rows [b, hkv, n, d], visible [b, n] bool.  f32 scores scaled
    after the dot (by ``scale``, default d^-0.5), f32 softmax with P
    cast to v's dtype before PV, f32 accumulation, output in q's dtype.
    A row with no visible key yields zeros."""
    b, h, _, d = q.shape
    hkv = k_rows.shape[1]
    qg = q.reshape(b, hkv, h // hkv, d).float()
    scores = torch.einsum("bngd,bnkd->bngk", qg, k_rows.float()) \
        * _scale_of(q, scale)
    visible = visible[:, None, None, :]
    scores = scores.masked_fill(~visible, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(visible, torch.exp(scores - m), 0.0)
    l_sum = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bngk,bnkd->bngd", p.to(v_rows.dtype).float(),
                       v_rows.float())
    out = acc / l_sum.clamp_min(1e-30)
    return out.to(q.dtype).reshape(b, h, 1, d)


def flash_decode_reference(q, k_cache, v_cache, length, *,
                           window: int | None = None, ring: bool = False,
                           scale: float | None = None):
    """The plain PyTorch version of the flash_decode kernel: the same
    math in one pass (:func:`_masked_decode`); ``scale`` multiplies the
    scores (default d^-0.5)."""
    _check_args(q, k_cache, v_cache, window, ring)
    b = q.shape[0]
    max_len = k_cache.shape[2]
    lengths = _row_lengths(length, b, q.device).long()
    qpos = (lengths - 1)[:, None]                           # [b, 1]
    slot = torch.arange(max_len, device=q.device)[None, :]
    if ring:
        # Slot j holds the largest position p = j (mod width) with
        # p <= qpos; torch.remainder is a floor-mod like jnp.mod.
        k_pos = qpos - torch.remainder(qpos - slot, max_len)
        visible = (k_pos >= 0) & (k_pos <= qpos) & (k_pos > qpos - window)
    else:
        visible = slot <= qpos
        if window is not None:
            visible &= slot > qpos - window
    return _masked_decode(q, k_cache, v_cache, visible, scale)


def _check_kernel_tensors(name: str, q, tensors: dict) -> None:
    """What every kernel needs of its CUDA tensors: q's device and
    dtype (bf16 or f32), a head_dim of at most 256 (the widest in
    KERNEL_HEAD_DIMS), contiguous and 16-byte aligned."""
    d = q.shape[-1]
    for tname, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{tname} on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{tname} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name} kernel takes bf16 or f32, got {q.dtype}")
    if not 1 <= d <= KERNEL_HEAD_DIMS[-1]:
        raise ValueError(f"{name} kernel takes head_dim 1 to "
                         f"{KERNEL_HEAD_DIMS[-1]}, got {d}")
    for tname, t in {"q": q, **tensors}.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel needs a contiguous {tname}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} kernel needs {tname} aligned to 16 "
                             f"bytes")


def _launch(name: str, q, *args) -> None:
    """Call kernel ``name``'s C entry on q's device and current stream;
    raise if the launch was refused, count it otherwise."""
    rc = _entry(name)(*args, q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def kernel_width(d: int) -> int:
    """The built head_dim a d-wide call runs at: the least of
    KERNEL_HEAD_DIMS that holds d."""
    for width in KERNEL_HEAD_DIMS:
        if d <= width:
            return width
    raise ValueError(f"the kernels take head_dim up to "
                     f"{KERNEL_HEAD_DIMS[-1]}, got {d}")


def pad_head_dim(t, width: int):
    """t zero-padded along its last dim to ``width`` (t itself when it
    is already that wide)."""
    d = t.shape[-1]
    return t if d == width else torch.nn.functional.pad(t, (0, width - d))


def call_padded(fn, args, pad, **kw):
    """``fn(*args, scale=d**-0.5, **kw)`` run at head_dim
    ``kernel_width(d)``: the args at the indices in ``pad`` (the ones
    whose last dim is the head_dim d) are zero-padded to that width, the
    true scale is passed, and every output that wide is sliced back to
    d.  Zero columns change no dot product and give zero output columns,
    so the result is the d-wide function; the cost is a copy of the
    padded tensors when d is not a built width.  The whole-activation
    wrappers run their kernels through it."""
    d = args[pad[0]].shape[-1]
    width = kernel_width(d)
    out = fn(*(pad_head_dim(a, width) if i in pad else a
               for i, a in enumerate(args)), scale=d ** -0.5, **kw)

    def cut(t):
        return t[..., :d].contiguous() if width != d \
            and t.shape[-1] == width else t

    return tuple(cut(t) for t in out) if isinstance(out, tuple) else cut(out)


def _on_cuda(name: str, q) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (run the plain version); any other device raises."""
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, not {q.device}")
    return q.device.type == "cuda"


def _validate_attention_args(q, k, v, causal, window) -> None:
    """The JAX package's checks, with its errors: the kernel would
    otherwise read out of range or give a silently wrong output."""
    if q.shape[1] % k.shape[1]:
        raise ValueError(
            f"query heads ({q.shape[1]}) must be a multiple of kv heads "
            f"({k.shape[1]})")
    if k.shape != v.shape:
        raise ValueError(f"k/v shape mismatch: {k.shape} vs {v.shape}")
    if window is not None and (not causal or window < 1):
        raise ValueError(
            f"window={window} requires causal=True and window >= 1")
    if (q.shape[0], q.shape[2], q.shape[3]) != (
            k.shape[0], k.shape[2], k.shape[3]):
        raise ValueError(
            f"q and k/v must share batch, seq and head_dim; got q "
            f"{tuple(q.shape)} vs kv {tuple(k.shape)}")


def causal_band_mask(s: int, window: int | None = None,
                     device=None) -> torch.Tensor:
    """[s, s] boolean mask: key visible iff q - window < k <= q.  The
    dense counterpart of the kernel's mask, shared by the einsum paths
    and the plain version so the window has one definition."""
    mask = torch.ones((s, s), dtype=torch.bool, device=device).tril()
    if window is not None:
        pos = torch.arange(s, device=device)
        mask &= (pos[:, None] - pos[None, :]) < window
    return mask


def flash_attention_reference(q, k, v, *, causal: bool = True,
                              window: int | None = None,
                              scale: float | None = None):
    """The plain PyTorch version of the flash_attention kernel, with its
    numerics in one pass: f32 scores scaled by ``scale`` (default
    d^-0.5) after the dot,
    masked entries at -1e30, f32 softmax, P cast to v's dtype before PV
    with f32 accumulation, out = acc / l in q's dtype and lse = m +
    log(l) in f32.  Returns (out [b, h, s, d], lse [b, h, s, 1])."""
    _validate_attention_args(q, k, v, causal, window)
    b, h, s, d = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, h // hkv, s, d).float()
    scores = torch.einsum("bngqd,bnkd->bngqk", qg, k.float()) \
        * _scale_of(q, scale)
    if causal:
        scores = scores.masked_fill(
            ~causal_band_mask(s, window, q.device), NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l_sum = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bngqk,bnkd->bngqd", p.to(v.dtype).float(),
                       v.float())
    out = (acc / l_sum).to(q.dtype).reshape(b, h, s, d)
    return out, (m + torch.log(l_sum)).reshape(b, h, s, 1)


def reference_attention(q, k, v, *, causal: bool = True,
                        window: int | None = None):
    """Plain einsum attention, the JAX package's numerics oracle: the
    GQA repeat materialised, f32 scores times d^-0.5, keys outside the
    band at -1e30, an f32 softmax and an f32 PV, the output cast to q's
    dtype.  Unlike :func:`flash_attention_reference` (the kernel's
    plain version) P is not cast to v's dtype before PV, and no lse is
    returned."""
    if k.shape[1] != q.shape[1]:
        rep = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    d = q.shape[-1]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        * d ** -0.5
    if causal:
        scores = torch.where(
            causal_band_mask(scores.shape[-1], window, q.device), scores,
            NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)


def _attention_forward(q, k, v, causal: bool, window):
    """Out and lse without a graph: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if not _on_cuda("flash_attention", q):
        return flash_attention_reference(q, k, v, causal=causal,
                                         window=window)
    _check_kernel_tensors("flash_attention", q, {"k": k, "v": v})
    return call_padded(_attention_kernel, (q, k, v), (0, 1, 2),
                       causal=causal, window=window)


def _attention_kernel(q, k, v, *, causal, window, scale):
    """Launch the flash_attention kernel (inputs checked, head_dim
    built)."""
    b, h, s, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s, 1), dtype=torch.float32, device=q.device)
    _launch("flash_attention", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, h, k.shape[1], s, d,
            _DTYPE_CODES[q.dtype], int(causal), window or 0, scale)
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """The JAX package's ``custom_vjp`` pair: K1's forward, saving q, k,
    v, out and the lse it wrote; the backward launches K2 on exactly
    those tensors (CPU tensors run both plain versions)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = _attention_forward(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, lse, dout.contiguous(), causal=ctx.causal,
            window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention_forward(q, k, v, *, causal: bool = True,
                            window: int | None = None):
    """Fused attention over a whole sequence (see module doc): returns
    (out [b, h, s, d] in q's dtype, lse [b, h, s, 1] f32).

    CPU tensors run :func:`flash_attention_reference`.  CUDA tensors
    launch the kernel (bf16 on the tensor cores or f32, head_dim up to
    256, any s, contiguous) or raise.  When an input requires grad the
    call goes through :class:`_FlashAttention`, whose backward is
    :func:`flash_attention_backward`; the lse carries no gradient."""
    _validate_attention_args(q, k, v, causal, window)
    if q.requires_grad or k.requires_grad or v.requires_grad:
        return _FlashAttention.apply(q, k, v, causal, window)
    return _attention_forward(q, k, v, causal, window)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None):
    """q [batch, heads, seq, head_dim]; k, v [batch, kv_heads, seq,
    head_dim] with heads % kv_heads == 0 -> output shaped like q.
    ``window=w`` (requires causal): each query sees only the w most
    recent keys including itself.  :func:`flash_attention_forward`
    without the lse; differentiable in q, k and v."""
    return flash_attention_forward(q, k, v, causal=causal, window=window)[0]


def make_sharded_flash_attention(mesh, *, causal: bool = True,
                                 window: int | None = None):
    """K1 forward and K2 backward per shard of a mesh held in one
    process (``model.Mesh``): the JAX package's shard_map wrapper.
    Attention is embarrassingly parallel over batch and heads, so
    ``attn(qs, ks, vs) -> outs`` takes one shard per rank of the mesh,
    in rank order, each on its rank's device and already cut: q [b', h',
    s, d], k/v [b', hkv', s, d] with whole KV-head groups (on the
    training mesh b/dp and h/tp, hkv/tp), and runs
    :func:`flash_attention` on each: no collectives."""

    def attn(qs, ks, vs):
        if not len(qs) == len(ks) == len(vs) == mesh.size:
            raise ValueError(
                f"need one q, k and v shard per rank of the {mesh.size}-rank "
                f"mesh, got {len(qs)}, {len(ks)}, {len(vs)}")
        if len({(tuple(q.shape), tuple(k.shape)) for q, k in zip(qs, ks)}) > 1:
            raise ValueError("every rank's shard must have one shape")
        return [flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                causal=causal, window=window)
                for q, k, v in zip(qs, ks, vs)]

    return attn


def _check_backward_args(q, o, lse, do) -> None:
    b, h, s, _ = q.shape
    for name, t in (("out", o), ("do", do)):
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} must match q "
                             f"{tuple(q.shape)}")
    if tuple(lse.shape) != (b, h, s, 1) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be f32 [{b}, {h}, {s}, 1] (the "
                         f"forward's), got {lse.dtype} {tuple(lse.shape)}")


def _delta(o, do):
    """delta = rowsum(do * out) in f32, [b, h, s, 1]: outside the
    kernels, as the JAX package computes it outside Pallas."""
    return (do.float() * o.float()).sum(dim=-1, keepdim=True)


def flash_attention_backward_reference(q, k, v, o, lse, do, *,
                                       causal: bool = True,
                                       window: int | None = None,
                                       scale: float | None = None):
    """The plain PyTorch version of the backward kernels, with their
    numerics in one pass: f32 scores scaled by ``scale`` (default
    d^-0.5) after the dot,
    masked entries at -1e30, P = exp(s - lse), dP = do.v^T and delta =
    rowsum(do * o) in f32, dS = P * (dP - delta); dv = sum P.to(do's
    dtype)^T do, dk = sum dS.to(q's dtype)^T q * scale (over the GQA
    group too), dq = dS.to(k's dtype) k * scale; f32 sums, outputs in
    the inputs' dtypes.  Returns (dq, dk, dv)."""
    _validate_attention_args(q, k, v, causal, window)
    _check_backward_args(q, o, lse, do)
    b, h, s, d = q.shape
    hkv = k.shape[1]
    scale = _scale_of(q, scale)

    def grouped(t):
        return t.reshape(b, hkv, h // hkv, s, t.shape[-1])

    qg, dog = grouped(q).float(), grouped(do).float()
    scores = torch.einsum("bngqd,bnkd->bngqk", qg, k.float()) * scale
    if causal:
        scores = scores.masked_fill(
            ~causal_band_mask(s, window, q.device), NEG_INF)
    p = torch.exp(scores - grouped(lse))
    dp = torch.einsum("bngqd,bnkd->bngqk", dog, v.float())
    ds = p * (dp - grouped(_delta(o, do)))
    dv = torch.einsum("bngqk,bngqd->bnkd", p.to(do.dtype).float(), dog)
    dk = torch.einsum("bngqk,bngqd->bnkd", ds.to(q.dtype).float(),
                      qg) * scale
    dq = torch.einsum("bngqk,bnkd->bngqd", ds.to(k.dtype).float(),
                      k.float()) * scale
    return (dq.to(q.dtype).reshape(b, h, s, d), dk.to(k.dtype),
            dv.to(v.dtype))


def _bwd_dq(q, k, v, do, lse, delta, causal, window, scale=None):
    """Launch the dq kernel (inputs checked by the caller, head_dim
    built; ``scale`` default d^-0.5)."""
    b, h, s, d = q.shape
    dq = torch.empty_like(q)
    _launch("flash_attention_bwd_dq", q, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), b, h, k.shape[1], s, d, _DTYPE_CODES[q.dtype],
            int(causal), window or 0, _scale_of(q, scale))
    return dq


def _bwd_dkv(q, k, v, do, lse, delta, causal, window, scale=None):
    """Launch the dk/dv kernel (inputs checked by the caller, head_dim
    built; ``scale`` default d^-0.5)."""
    b, h, s, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_attention_bwd_dkv", q, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, h, k.shape[1], s, d,
            _DTYPE_CODES[q.dtype], int(causal), window or 0,
            _scale_of(q, scale))
    return dk, dv


def _bwd_kernels(q, k, v, do, lse, delta, *, causal, window, scale):
    """Both backward kernels: (dq, dk, dv)."""
    args = (q, k, v, do, lse, delta, causal, window, scale)
    return (_bwd_dq(*args), *_bwd_dkv(*args))


def flash_attention_backward(q, k, v, o, lse, do, *, causal: bool = True,
                             window: int | None = None):
    """The gradients (dq, dk, dv) of ``flash_attention`` given the
    forward's inputs, its output ``o`` and lse, and the output's
    gradient ``do``.  dk and dv sum over every query head of each KV
    head's group.

    CPU tensors run :func:`flash_attention_backward_reference`.  CUDA
    tensors launch the dq and the dk/dv kernels on the lse the forward
    wrote (bf16 on the tensor cores, each gradient rounded once from its
    f32 sum, or f32; head_dim up to 256, any s, contiguous) or raise."""
    _validate_attention_args(q, k, v, causal, window)
    _check_backward_args(q, o, lse, do)
    if not _on_cuda("flash_attention_backward", q):
        return flash_attention_backward_reference(
            q, k, v, o, lse, do, causal=causal, window=window)
    _check_kernel_tensors("flash_attention_backward", q,
                          {"k": k, "v": v, "out": o, "do": do})
    if lse.device != q.device or not lse.is_contiguous():
        raise ValueError("flash_attention_backward kernel needs a "
                         "contiguous f32 lse on q's device")
    return call_padded(_bwd_kernels, (q, k, v, do, lse, _delta(o, do)),
                       (0, 1, 2, 3), causal=causal, window=window)


def _check_ring_args(q, k_t, v_t, window) -> None:
    """What a ring hop needs of its shapes: q [b, h, sq, d] against a
    visiting block k_t/v_t [b, hkv, sk, d] with hkv dividing h."""
    if q.dim() != 4 or k_t.dim() != 4:
        raise ValueError(f"ring hop wants q [b, h, sq, d] and k/v [b, hkv, "
                         f"sk, d]; got {tuple(q.shape)}, {tuple(k_t.shape)}")
    if k_t.shape != v_t.shape:
        raise ValueError(f"k/v shape mismatch: {k_t.shape} vs {v_t.shape}")
    if q.shape[1] % k_t.shape[1]:
        raise ValueError(
            f"query heads ({q.shape[1]}) must be a multiple of kv heads "
            f"({k_t.shape[1]})")
    if (q.shape[0], q.shape[3]) != (k_t.shape[0], k_t.shape[3]):
        raise ValueError(f"q and k/v must share batch and head_dim; got q "
                         f"{tuple(q.shape)} vs kv {tuple(k_t.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def _check_rows(q, rows: dict) -> None:
    """Each named tensor is f32 and shaped [b, h, sq, 1] (a per-row
    statistic) or like q (acc)."""
    b, h, sq, d = q.shape
    for name, t in rows.items():
        want = (b, h, sq, d) if name == "acc" else (b, h, sq, 1)
        if tuple(t.shape) != want or t.dtype != torch.float32:
            raise ValueError(f"{name} must be f32 {list(want)}, got "
                             f"{t.dtype} {list(t.shape)}")


def _check_kernel_rows(name: str, q, rows: dict) -> None:
    """The f32 carry or statistics a ring kernel reads: on q's device and
    contiguous."""
    for tname, t in rows.items():
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} kernel needs a contiguous {tname} on "
                             f"q's device")


def ring_hop_mask(sq: int, sk: int, offset: int, window: int | None,
                  device=None) -> torch.Tensor:
    """[sq, sk] bool mask of a masked ring hop: key k visible to query
    row i iff 0 <= offset + i - k (< window), where offset is
    global(q block start) - global(k block start).  The single
    definition of the hop mask (the JAX package's ``_rel_mask``),
    shared by the einsum merge and the plain versions of K5 and K6."""
    rel = (offset + torch.arange(sq, device=device)[:, None]
           - torch.arange(sk, device=device)[None, :])
    keep = rel >= 0
    if window is not None:
        keep &= rel < window
    return keep


def ring_flash_step_reference(q, k_t, v_t, m, l, acc, *, offset: int,
                              masked: bool, window: int | None = None,
                              scale: float | None = None):
    """The plain PyTorch version of the ring_flash_step kernel, with its
    numerics in one pass: f32 scores scaled by ``scale`` (default
    d^-0.5) after the dot,
    masked entries at -1e30, then ``_online_softmax_merge``: m' = max(m,
    max s), P = exp(s - m'), l' = l exp(m - m') + sum P, acc' = acc
    exp(m - m') + P.to(v's dtype) v with f32 sums.  A row that sees no
    key while its m is -1e30 takes P = 1 for every key, as the JAX kernel
    does.  Returns fresh (m', l', acc')."""
    _check_ring_args(q, k_t, v_t, window)
    _check_rows(q, {"m": m, "l": l, "acc": acc})
    b, h, sq, d = q.shape
    hkv, sk = k_t.shape[1], k_t.shape[2]
    g = h // hkv
    qg = q.reshape(b, hkv, g, sq, d).float()
    scores = torch.einsum("bngqd,bnkd->bngqk", qg, k_t.float()) \
        * _scale_of(q, scale)
    if masked:
        scores = scores.masked_fill(
            ~ring_hop_mask(sq, sk, offset, window, q.device), NEG_INF)
    scores = scores.reshape(b, h, sq, sk)
    m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
    p = torch.exp(scores - m_new)
    corr = torch.exp(m - m_new)
    pv = torch.einsum("bngqk,bnkd->bngqd",
                      p.to(v_t.dtype).float().reshape(b, hkv, g, sq, sk),
                      v_t.float()).reshape(b, h, sq, d)
    return (m_new, l * corr + p.sum(dim=-1, keepdim=True),
            acc * corr + pv)


def ring_flash_step(q, k_t, v_t, m, l, acc, *, offset: int, masked: bool,
                    window: int | None = None):
    """Merge one visiting K/V block into a ring rank's online-softmax
    carry (the JAX package's ``ring_flash_step``).

    q [b, h, sq, d] (the rank's queries); k_t, v_t [b, hkv, sk, d] (the
    visiting block, hkv dividing h); m, l [b, h, sq, 1] and acc [b, h,
    sq, d] f32; ``offset`` = global(q block start) - global(k block
    start), read only when ``masked`` (key k visible to row i iff 0 <=
    offset + i - k, and < ``window`` when given).  Returns the merged
    (m, l, acc) as fresh tensors: the carry passed in is not written.

    CPU tensors run :func:`ring_flash_step_reference`.  CUDA tensors
    launch the kernel (bf16 on the tensor cores or f32, head_dim up to
    256, any sq and sk, contiguous) or raise."""
    _check_ring_args(q, k_t, v_t, window)
    _check_rows(q, {"m": m, "l": l, "acc": acc})
    if not _on_cuda("ring_flash_step", q):
        return ring_flash_step_reference(q, k_t, v_t, m, l, acc,
                                         offset=offset, masked=masked,
                                         window=window)
    if not -2 ** 31 < offset < 2 ** 31:
        raise ValueError(f"ring_flash_step kernel takes an int32 offset, "
                         f"got {offset}")
    _check_kernel_tensors("ring_flash_step", q, {"k_t": k_t, "v_t": v_t})
    _check_kernel_rows("ring_flash_step", q, {"m": m, "l": l, "acc": acc})
    return call_padded(_ring_step_kernel, (q, k_t, v_t, m, l, acc),
                       (0, 1, 2, 5), offset=offset, masked=masked,
                       window=window)


def _ring_step_kernel(q, k_t, v_t, m, l, acc, *, offset, masked, window,
                      scale):
    """Launch the ring_flash_step kernel (inputs checked, head_dim
    built) into fresh (m, l, acc)."""
    b, h, sq, d = q.shape
    hkv, sk = k_t.shape[1], k_t.shape[2]
    m_out, l_out, acc_out = (torch.empty_like(t) for t in (m, l, acc))
    _launch("ring_flash_step", q, q.data_ptr(), k_t.data_ptr(),
            v_t.data_ptr(), m.data_ptr(), l.data_ptr(), acc.data_ptr(),
            m_out.data_ptr(), l_out.data_ptr(), acc_out.data_ptr(), b, h, hkv,
            sq, sk, d, _DTYPE_CODES[q.dtype], int(offset), int(masked),
            window or 0, scale)
    return m_out, l_out, acc_out


def _check_hop_backward_args(q, do, lse, delta) -> None:
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} must match q "
                         f"{tuple(q.shape)}")
    _check_rows(q, {"lse": lse, "delta": delta})


def ring_flash_bwd_step_reference(q, k_t, v_t, do, lse, delta, *,
                                  offset: int, masked: bool,
                                  window: int | None = None,
                                  scale: float | None = None):
    """The plain PyTorch version of the ring_flash_bwd kernels, with their
    numerics in one pass: f32 scores scaled by ``scale`` (default
    d^-0.5) after the dot, P =
    exp(s - lse) (0 outside the hop's mask), dP = do.v^T, dS = P * (dP -
    delta); dv_add = sum P.to(do's dtype)^T do, dk_add = sum dS.to(q's
    dtype)^T q * scale (over the GQA group too), dq_add = dS.to(k's
    dtype) k * scale; f32 sums and f32 outputs.  Returns (dq_add [b, h,
    sq, d], dk_add, dv_add [b, hkv, sk, d])."""
    _check_ring_args(q, k_t, v_t, window)
    _check_hop_backward_args(q, do, lse, delta)
    b, h, sq, d = q.shape
    hkv, sk = k_t.shape[1], k_t.shape[2]
    scale = _scale_of(q, scale)

    def grouped(t):
        return t.reshape(b, hkv, h // hkv, sq, t.shape[-1])

    qg, dog = grouped(q).float(), grouped(do).float()
    scores = torch.einsum("bngqd,bnkd->bngqk", qg, k_t.float()) * scale
    p = torch.exp(scores - grouped(lse))
    if masked:
        p = torch.where(ring_hop_mask(sq, sk, offset, window, q.device), p,
                        0.0)
    dp = torch.einsum("bngqd,bnkd->bngqk", dog, v_t.float())
    ds = p * (dp - grouped(delta))
    dv = torch.einsum("bngqk,bngqd->bnkd", p.to(do.dtype).float(), dog)
    dk = torch.einsum("bngqk,bngqd->bnkd", ds.to(q.dtype).float(),
                      qg) * scale
    dq = torch.einsum("bngqk,bnkd->bngqd", ds.to(k_t.dtype).float(),
                      k_t.float()) * scale
    return dq.reshape(b, h, sq, d), dk, dv


def _ring_bwd_dq(q, k_t, v_t, do, lse, delta, offset, masked, window,
                 scale=None):
    """Launch the hop's dq kernel (inputs checked by the caller, head_dim
    built; ``scale`` default d^-0.5)."""
    b, h, sq, d = q.shape
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _launch("ring_flash_bwd_dq", q, q.data_ptr(), k_t.data_ptr(),
            v_t.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), b, h, k_t.shape[1], sq, k_t.shape[2], d,
            _DTYPE_CODES[q.dtype], int(offset), int(masked), window or 0,
            _scale_of(q, scale))
    return dq


def _ring_bwd_dkv(q, k_t, v_t, do, lse, delta, offset, masked, window,
                  scale=None):
    """Launch the hop's dk/dv kernel (inputs checked by the caller,
    head_dim built; ``scale`` default d^-0.5)."""
    b, h, sq, d = q.shape
    dk = torch.empty(k_t.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(k_t.shape, dtype=torch.float32, device=q.device)
    _launch("ring_flash_bwd_dkv", q, q.data_ptr(), k_t.data_ptr(),
            v_t.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, h, k_t.shape[1], sq,
            k_t.shape[2], d, _DTYPE_CODES[q.dtype], int(offset), int(masked),
            window or 0, _scale_of(q, scale))
    return dk, dv


def _ring_bwd_kernels(q, k_t, v_t, do, lse, delta, *, offset, masked,
                      window, scale):
    """Both hop backward kernels: (dq_add, dk_add, dv_add)."""
    args = (q, k_t, v_t, do, lse, delta, offset, masked, window, scale)
    return (_ring_bwd_dq(*args), *_ring_bwd_dkv(*args))


def ring_flash_bwd_step(q, k_t, v_t, do, lse, delta, *, offset: int,
                        masked: bool, window: int | None = None):
    """One backward ring hop (the JAX package's ``ring_flash_bwd_step``):
    given the rank's q, do [b, h, sq, d], the forward ring's f32 lse and
    delta = rowsum(do * out) [b, h, sq, 1], and the visiting k_t, v_t
    [b, hkv, sk, d], returns the f32 (dq_add [b, h, sq, d], dk_add,
    dv_add [b, hkv, sk, d]) this hop adds to the rank's dq and to the
    dk/dv buffers travelling with the block.  ``offset``, ``masked`` and
    ``window`` as in :func:`ring_flash_step`.

    CPU tensors run :func:`ring_flash_bwd_step_reference`.  CUDA tensors
    launch the dq and the dk/dv kernels (bf16 on the tensor cores or
    f32, head_dim up to 256, any sq and sk, contiguous) or raise."""
    _check_ring_args(q, k_t, v_t, window)
    _check_hop_backward_args(q, do, lse, delta)
    if not _on_cuda("ring_flash_bwd_step", q):
        return ring_flash_bwd_step_reference(
            q, k_t, v_t, do, lse, delta, offset=offset, masked=masked,
            window=window)
    if not -2 ** 31 < offset < 2 ** 31:
        raise ValueError(f"ring_flash_bwd_step kernels take an int32 "
                         f"offset, got {offset}")
    _check_kernel_tensors("ring_flash_bwd_step", q,
                          {"k_t": k_t, "v_t": v_t, "do": do})
    _check_kernel_rows("ring_flash_bwd_step", q,
                       {"lse": lse, "delta": delta})
    return call_padded(_ring_bwd_kernels, (q, k_t, v_t, do, lse, delta),
                       (0, 1, 2, 3), offset=offset, masked=masked,
                       window=window)


def flash_decode(q, k_cache, v_cache, length, *, window: int | None = None,
                 ring: bool = False):
    """Fused cached attention for one decode step (see module doc).

    ``ring=True`` (requires ``window``): the cache is the serving ring
    layout over its max_len width — each slot's absolute position is
    recovered from the row's logical length, which may exceed the
    width.  Returns [b, h, 1, d] in q's dtype.

    CPU tensors run :func:`flash_decode_reference`.  CUDA tensors
    launch the kernel (bf16 or f32, head_dim up to 256 read at its true
    width, any GQA group, contiguous) or raise."""
    _check_args(q, k_cache, v_cache, window, ring)
    if not _on_cuda("flash_decode", q):
        return flash_decode_reference(q, k_cache, v_cache, length,
                                      window=window, ring=ring)
    b, h, _, d = q.shape
    hkv, max_len = k_cache.shape[1], k_cache.shape[2]
    lengths = _row_lengths(length, b, q.device)
    _check_kernel_tensors("flash_decode", q,
                          {"k_cache": k_cache, "v_cache": v_cache})
    out = torch.empty_like(q)
    _launch("flash_decode", q, q.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), lengths.data_ptr(), out.data_ptr(), b, h,
            hkv, max_len, d, _DTYPE_CODES[q.dtype], window or 0, int(ring),
            d ** -0.5)
    return out


def _check_paged_args(q, k_pool, v_pool, tables, lengths, window) -> None:
    slots, h, sq, d = q.shape
    if sq != 1:
        raise ValueError(
            f"paged_flash_decode is single-token (sq=1); got {sq}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if k_pool.shape != v_pool.shape:
        raise ValueError(
            f"k/v pool shape mismatch: {k_pool.shape} vs {v_pool.shape}")
    if k_pool.dim() != 4 or k_pool.shape[3] != d or h % k_pool.shape[1]:
        raise ValueError(
            f"pool {tuple(k_pool.shape)} does not fit q {tuple(q.shape)}: "
            f"want [num_blocks, kv_heads, block_size, d] with kv_heads "
            f"dividing the query heads")
    if tables.dim() != 2 or tables.shape[0] != slots:
        raise ValueError(f"tables {tuple(tables.shape)} do not fit "
                         f"{slots} slots: want [slots, tpr]")
    if tuple(lengths.shape) != (slots,):
        raise ValueError(f"lengths {tuple(lengths.shape)}: want "
                         f"[{slots}]")


def paged_flash_decode_reference(q, k_pool, v_pool, tables, lengths, *,
                                 window: int | None = None,
                                 scale: float | None = None):
    """The plain PyTorch version of the paged_flash_decode kernel.

    The kernel's table semantics, which differ from gathering the rows
    and attending over them: a table entry < 0 hides its whole block,
    even below the row's length; an entry >= num_blocks is clamped to
    num_blocks - 1 and read.  Key position p is visible when
    p <= length - 1 (and p > length - 1 - window) and its block is
    live; a row with no visible key yields zeros.  ``scale`` multiplies
    the scores (default d^-0.5)."""
    lengths = torch.as_tensor(lengths, device=q.device)
    tables = torch.as_tensor(tables, device=q.device)
    _check_paged_args(q, k_pool, v_pool, tables, lengths, window)
    bs = k_pool.shape[2]
    k_rows = gather_pool_rows(k_pool, tables)
    v_rows = gather_pool_rows(v_pool, tables)
    qpos = (lengths.long() - 1)[:, None]
    kpos = torch.arange(k_rows.shape[2], device=q.device)[None, :]
    visible = (kpos <= qpos) & (tables >= 0).repeat_interleave(bs, dim=1)
    if window is not None:
        visible &= kpos > qpos - window
    return _masked_decode(q, k_rows, v_rows, visible, scale)


def gather_pool_rows(pool, tables):
    """One layer's pool [nb, hkv, bs, d] read through [rows, tpr] block
    tables as contiguous rows [rows, hkv, tpr*bs, d] (the JAX package's
    ``paged._gather_rows``).  Entries are clamped to [0, nb - 1]: -1
    reads block 0, whose keys the caller must mask."""
    rows, tpr = tables.shape
    nb, hkv, bs, d = pool.shape
    safe = tables.long().clamp(0, nb - 1)
    return pool[safe].permute(0, 2, 1, 3, 4).reshape(rows, hkv, tpr * bs, d)


def paged_flash_decode(q, k_pool, v_pool, tables, lengths, *,
                       window: int | None = None):
    """Fused cached attention for one decode step over a PAGED cache:
    each row's keys are read in place from the block pool through its
    block table, with no gathered copy.  Returns [slots, h, 1, d] in q's
    dtype.

    CPU tensors run :func:`paged_flash_decode_reference`.  CUDA tensors
    launch the kernel (bf16 or f32, head_dim up to 256 read at its true
    width, any GQA group, any block size, contiguous pools) or raise;
    tables and lengths are taken as int32 on q's device."""
    lengths = torch.as_tensor(lengths, device=q.device)
    tables = torch.as_tensor(tables, device=q.device)
    _check_paged_args(q, k_pool, v_pool, tables, lengths, window)
    if not _on_cuda("paged_flash_decode", q):
        return paged_flash_decode_reference(q, k_pool, v_pool, tables,
                                            lengths, window=window)
    slots, h, _, d = q.shape
    nb, hkv, bs, _ = k_pool.shape
    tpr = tables.shape[1]
    if tpr * bs >= 2 ** 31:
        raise ValueError(f"paged_flash_decode kernel indexes positions "
                         f"with int32; tpr * block_size = {tpr * bs}")
    _check_kernel_tensors("paged_flash_decode", q,
                          {"k_pool": k_pool, "v_pool": v_pool})
    tables = tables.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    _launch("paged_flash_decode", q, q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), tables.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), slots, h, hkv, nb, bs, tpr, d,
            _DTYPE_CODES[q.dtype], window or 0, d ** -0.5)
    return out


def paged_token_writes(tables, positions, active, num_blocks: int,
                       block_size: int):
    """Where one decode step writes each row's new token: (rows, blocks,
    offsets) int64 on the tables' device.  tables [rows, tpr]; positions
    [rows] absolute; active [rows] bool.  Inactive rows, and rows whose
    table has no block there (< 0) or one past the pool, write nothing.
    A position past the table lands in its last entry, as the JAX
    package's clipped index does."""
    tpr = tables.shape[1]
    positions = positions.long()
    rows = torch.arange(tables.shape[0], device=tables.device)
    block = tables[rows, (positions // block_size).clamp(0, tpr - 1)].long()
    keep = active & (block >= 0) & (block < num_blocks)
    return rows[keep], block[keep], (positions % block_size)[keep]


def paged_token_write_reference(k_pool, v_pool, k_new, v_new, tables,
                                positions, active) -> None:
    """The plain PyTorch version of the paged_token_write kernel: the
    rows :func:`paged_token_writes` keeps write their new k/v in place."""
    rows, blocks, offsets = paged_token_writes(
        tables, positions, active, k_pool.shape[0], k_pool.shape[2])
    k_pool[blocks, :, offsets] = k_new[rows, :, 0]
    v_pool[blocks, :, offsets] = v_new[rows, :, 0]


def paged_token_write(k_pool, v_pool, k_new, v_new, tables, positions,
                      active) -> None:
    """One decode step's new keys and values, k_new / v_new [slots, hkv,
    1, d], written in place into one layer's pools [nb, hkv, bs, d]:
    row r at position positions[r] into its table's block there (see
    :func:`paged_token_writes` for the rows that write nothing).  Every
    slot is taken and each decides on the device, so the launch has one
    shape whatever the rows hold.

    CPU tensors run :func:`paged_token_write_reference`.  CUDA tensors
    launch the kernel (2- or 4-byte elements, contiguous pools, k/v with
    unit stride along d) or raise; tables and positions int32 and
    active bool, on the pools' device."""
    if k_new.shape != v_new.shape or k_pool.shape != v_pool.shape \
            or k_new.dim() != 4 or k_new.shape[2] != 1 \
            or k_new.shape[1] != k_pool.shape[1] \
            or k_new.shape[3] != k_pool.shape[3]:
        raise ValueError(f"new k/v {tuple(k_new.shape)} do not fit pools "
                         f"{tuple(k_pool.shape)}: want [slots, hkv, 1, d] "
                         f"and [nb, hkv, bs, d]")
    slots, hkv, _, d = k_new.shape
    if tables.dim() != 2 or tables.shape[0] != slots \
            or tuple(positions.shape) != (slots,) \
            or tuple(active.shape) != (slots,):
        raise ValueError(f"tables {tuple(tables.shape)}, positions "
                         f"{tuple(positions.shape)} and active "
                         f"{tuple(active.shape)} do not fit {slots} slots")
    if not _on_cuda("paged_token_write", k_new):
        return paged_token_write_reference(k_pool, v_pool, k_new, v_new,
                                           tables, positions, active)
    for name, t in {"v_new": v_new, "k_pool": k_pool, "v_pool": v_pool,
                    "tables": tables, "positions": positions,
                    "active": active}.items():
        if t.device != k_new.device:
            raise ValueError(f"{name} on {t.device}, k_new on "
                             f"{k_new.device}")
    if {v_new.dtype, k_pool.dtype, v_pool.dtype} != {k_new.dtype} \
            or k_new.element_size() not in (2, 4):
        raise ValueError("paged_token_write kernel takes one element type "
                         "of 2 or 4 bytes for new k/v and the pools")
    if (tables.dtype, positions.dtype, active.dtype) != (
            torch.int32, torch.int32, torch.bool) \
            or not tables.is_contiguous() or not positions.is_contiguous() \
            or not active.is_contiguous():
        raise ValueError("paged_token_write kernel takes contiguous int32 "
                         "tables and positions and bool active")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()
            and k_new.stride(3) == 1 and v_new.stride(3) == 1):
        raise ValueError("paged_token_write kernel needs contiguous pools "
                         "and new k/v with unit stride along d")
    nb, _, bs, _ = k_pool.shape
    _launch("paged_token_write", k_new, k_new.data_ptr(), v_new.data_ptr(),
            k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
            positions.data_ptr(), active.data_ptr(), slots, hkv, nb, bs,
            tables.shape[1], d, k_new.element_size(), k_new.stride(0),
            k_new.stride(1), v_new.stride(0), v_new.stride(1), 0.0)


def _check_prefill_args(q, k_pool, v_pool, tables, offsets, n_valid,
                        window) -> None:
    """What a paged prefill needs of its shapes: K4's pool and table
    checks for q [lanes, h, chunk, d], plus offsets and n_valid of
    length lanes, and (where n_valid is on the host, so reading it costs
    no sync) 0 <= n_valid <= chunk."""
    if q.dim() != 4:
        raise ValueError(f"paged_flash_prefill wants q [lanes, h, chunk, "
                         f"d]; got {tuple(q.shape)}")
    lanes, h, chunk, d = q.shape
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if k_pool.shape != v_pool.shape:
        raise ValueError(
            f"k/v pool shape mismatch: {k_pool.shape} vs {v_pool.shape}")
    if k_pool.dim() != 4 or k_pool.shape[3] != d or h % k_pool.shape[1]:
        raise ValueError(
            f"pool {tuple(k_pool.shape)} does not fit q {tuple(q.shape)}: "
            f"want [num_blocks, kv_heads, block_size, d] with kv_heads "
            f"dividing the query heads")
    if tables.dim() != 2 or tables.shape[0] != lanes:
        raise ValueError(f"tables {tuple(tables.shape)} do not fit "
                         f"{lanes} lanes: want [lanes, tpr]")
    for name, t in (("offsets", offsets), ("n_valid", n_valid)):
        if tuple(t.shape) != (lanes,):
            raise ValueError(f"{name} {tuple(t.shape)}: want [{lanes}]")
    if n_valid.device.type == "cpu" and bool(
            ((n_valid < 0) | (n_valid > chunk)).any()):
        raise ValueError(f"n_valid {n_valid.tolist()} must lie in "
                         f"[0, chunk={chunk}]")


def _check_prefill_kernel(q, k_pool, v_pool, tables) -> None:
    """What the paged_flash_prefill kernel needs beyond the shapes: the
    tensors every kernel needs (:func:`_check_kernel_tensors`), rows of
    whole 16-byte vectors, int32 positions, and in bf16 a block size
    whose pages are whole TMA boxes of its key tiles (a multiple of 8
    that divides the 64-key tile, 32 at head_dim over 128, or is a
    multiple of it)."""
    d = q.shape[-1]
    bs = k_pool.shape[2]
    _check_kernel_tensors("paged_flash_prefill", q,
                          {"k_pool": k_pool, "v_pool": v_pool})
    if d * q.element_size() % 16:
        raise ValueError(f"paged_flash_prefill kernel reads rows of whole "
                         f"16-byte vectors; head_dim {d} in {q.dtype} is not")
    if tables.shape[1] * bs + q.shape[2] >= 2 ** 31:
        raise ValueError(f"paged_flash_prefill kernel indexes positions "
                         f"with int32; tpr * block_size = "
                         f"{tables.shape[1] * bs}")
    if q.dtype == torch.bfloat16:
        tile = 32 if d > 128 else 64
        if bs % 8 or (tile % bs and bs % tile):
            raise ValueError(
                f"paged_flash_prefill kernel takes a block size that is a "
                f"multiple of 8 and divides {tile} or is divided by it at "
                f"head_dim {d}; got {bs}")


def paged_flash_prefill_reference(q, k_pool, v_pool, tables, offsets,
                                  n_valid, *, window: int | None = None,
                                  scale: float | None = None):
    """The plain PyTorch version of the paged_flash_prefill kernel.

    Lane b's query row i sits at position p = offsets[b] + i and sees key
    position j when j <= p (and is within ``window`` of it) and j <
    tpr * block_size.  j's page is its table entry, clamped to [0,
    num_blocks - 1] as :func:`gather_pool_rows` clamps it.  A real row
    (i < n_valid[b]) does not see a dead page's keys (an entry < 0, K4's
    table semantics), and as j <= p it sees none at or past the lane's
    end.  The padding rows (i >= n_valid[b]) are the gathered einsum's
    (the JAX prefill's): every key j <= p, a dead page read as block 0;
    an MoE layer routes their tokens in the lane's capacity pool.  Rows
    that see no key are zeros.  The kernel's numerics: f32 scores times
    ``scale`` (default d^-0.5), f32 softmax, P cast to v's dtype before
    PV with f32 sums, the output in q's dtype.  Returns [lanes, h, chunk,
    d]."""
    tables = torch.as_tensor(tables, device=q.device)
    offsets = torch.as_tensor(offsets, device=q.device)
    n_valid = torch.as_tensor(n_valid, device=q.device)
    _check_prefill_args(q, k_pool, v_pool, tables, offsets, n_valid, window)
    lanes, h, chunk, d = q.shape
    hkv, bs = k_pool.shape[1], k_pool.shape[2]
    dev = q.device
    kpos = torch.arange(tables.shape[1] * bs, device=dev)
    rows = torch.arange(chunk, device=dev)
    qpos = (offsets.long()[:, None] + rows)[..., None]      # [lanes, s, 1]
    dead = (tables.long() < 0).repeat_interleave(bs, dim=1)[:, None, :]
    pad = (rows[None, :] >= n_valid.long()[:, None])[..., None]
    visible = (kpos <= qpos) & (pad | ~dead)                # [lanes, s, T]
    if window is not None:
        visible &= kpos > qpos - window
    k_rows = gather_pool_rows(k_pool, tables).float()
    v_rows = gather_pool_rows(v_pool, tables).float()
    qg = q.reshape(lanes, hkv, h // hkv, chunk, d).float()
    scores = torch.einsum("bngqd,bnkd->bngqk", qg, k_rows) \
        * _scale_of(q, scale)
    visible = visible[:, None, None]
    scores = scores.masked_fill(~visible, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(visible, torch.exp(scores - m), 0.0)
    l_sum = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bngqk,bnkd->bngqd", p.to(v_pool.dtype).float(),
                       v_rows)
    out = acc / l_sum.clamp_min(1e-30)
    return out.to(q.dtype).reshape(lanes, h, chunk, d)


def paged_flash_prefill(q, k_pool, v_pool, tables, offsets, n_valid, *,
                        window: int | None = None):
    """Each lane's chunk of queries over its pages of a PAGED cache, read
    in place through its block table with no gathered copy (see module
    doc; :func:`paged_flash_prefill_reference` for the function).  q
    [lanes, h, chunk, d]; pools [num_blocks, kv_heads, block_size, d];
    tables [lanes, tpr]; offsets [lanes] (each lane's length before the
    chunk, its keys already written) and n_valid [lanes] (its real rows;
    the padding rows after them are attended as the gathered einsum
    attends them).  Returns [lanes, h, chunk, d] in q's dtype.

    CPU tensors run the plain version.  CUDA tensors launch the kernel
    (bf16 on the tensor cores, at a block size that is a multiple of 8
    and divides 64 or is divided by it, 32 at head_dim over 128; or f32;
    a head_dim up to 256 whose rows are whole 16-byte vectors, read at
    its true width; any GQA group; contiguous pools) or raise; tables,
    offsets and n_valid are taken as int32 on q's device, and there
    n_valid is clamped to [0, chunk] rather than checked."""
    tables = torch.as_tensor(tables, device=q.device)
    offsets = torch.as_tensor(offsets, device=q.device)
    n_valid = torch.as_tensor(n_valid, device=q.device)
    _check_prefill_args(q, k_pool, v_pool, tables, offsets, n_valid, window)
    if not _on_cuda("paged_flash_prefill", q):
        return paged_flash_prefill_reference(q, k_pool, v_pool, tables,
                                             offsets, n_valid, window=window)
    _check_prefill_kernel(q, k_pool, v_pool, tables)
    lanes, h, chunk, d = q.shape
    nb, hkv, bs, _ = k_pool.shape
    tpr = tables.shape[1]
    tables = tables.to(torch.int32).contiguous()
    offsets = offsets.to(torch.int32).contiguous()
    n_valid = n_valid.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    _launch("paged_flash_prefill", q, q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), tables.data_ptr(), offsets.data_ptr(),
            n_valid.data_ptr(), out.data_ptr(), lanes, h, hkv, chunk, nb, bs,
            tpr, d, _DTYPE_CODES[q.dtype], window or 0, d ** -0.5)
    return out
