"""Attention kernels: the prompt's ``flash_attention`` forward and the
one-token ``flash_decode`` and ``paged_flash_decode``, as CUDA kernels
beside their plain PyTorch versions, and the build that makes them.

``flash_attention`` keeps the signature and the layout of the JAX
package's ``workloads/attention.py::flash_attention``: q ``[b, h, s,
d]`` and k/v ``[b, kv_heads, s, d]``, causal by default, with an
optional sliding window; ``flash_attention_forward`` also returns the
f32 log-sum-exp ``[b, h, s, 1]``.  The kernel picks its own tiles, so
the JAX ``block_q``/``block_k`` are not part of the signature.
``flash_decode`` keeps the signature and the layout of the JAX
package's ``workloads/attention.py::flash_decode``: q ``[b, h, 1, d]``
(the new token's queries, already rotated), caches ``[b, kv_heads,
max_len, d]`` with the new k/v already written, and ``length`` a scalar
or a per-row ``[b]`` count of filled positions.  ``paged_flash_decode``
keeps those of the JAX ``paged_flash_decode``: the same q, one layer's
block pools ``[num_blocks, kv_heads, block_size, d]``, per-row block
tables ``[slots, tpr]`` (-1 = no block) and lengths ``[slots]``.  On
CUDA tensors each launches its hand-written Hopper kernel (``csrc/``);
on CPU tensors it runs its plain PyTorch version.  There is no fallback
from one to the other: a CUDA tensor a kernel does not take raises.

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

#: head_dim values every kernel is instantiated for.
KERNEL_HEAD_DIMS = (32, 64, 128, 256)
#: The decode kernels run one warp per query head of a GQA group.
MAX_GROUP = 32
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches per wrapper: each wrapper adds one where it launches
#: its kernel and nowhere else.  Callers zero and read them to show
#: that a path ran through the kernels.
LAUNCHES: dict[str, int] = {"flash_attention": 0, "flash_decode": 0,
                             "paged_flash_decode": 0}

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
KERNEL_SOURCES = {"flash_attention": CSRC / "flash_attention.cu",
                  "flash_decode": CSRC / "flash_decode.cu",
                  "paged_flash_decode": CSRC / "paged_flash_decode.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Each library exports one C function of the kernel's name: pointers
# (and the stream) as c_void_p, so ctypes never cuts them to 32 bits.
_ARGTYPES = {
    "flash_attention": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
    + [ctypes.c_void_p],
    "flash_decode": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
    + [ctypes.c_void_p],
    "paged_flash_decode": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
    + [ctypes.c_void_p]}
_LIBS: dict[str, ctypes.CDLL] = {}


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
    """Where kernel ``name``'s library lives: keyed by the hash of its
    source, the headers it may include (every ``csrc/*.cuh``) and the
    flags, so an edited source or header is rebuilt, never reused."""
    digest = hashlib.sha256(KERNEL_SOURCES[name].read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_kernels(names=None) -> dict[str, dict]:
    """Compile every named kernel that is not built yet, one ``nvcc``
    per source, all started together.  Returns per kernel the build
    seconds (0.0 when already built) and the compiler's output
    (``-Xptxas -v`` register and shared-memory report).  Raises if any
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names or KERNEL_SOURCES:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(KERNEL_SOURCES[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    report = {name: {"seconds": 0.0, "log": ""}
              for name in names or KERNEL_SOURCES}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return report


def _library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_kernels([name])
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


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


def _masked_decode(q, k_rows, v_rows, visible):
    """The kernels' math in one pass over contiguous rows: q [b, h, 1,
    d], k/v rows [b, hkv, n, d], visible [b, n] bool.  f32 scores scaled
    after the dot, f32 softmax with P cast to v's dtype before PV, f32
    accumulation, output in q's dtype.  A row with no visible key
    yields zeros."""
    b, h, _, d = q.shape
    hkv = k_rows.shape[1]
    qg = q.reshape(b, hkv, h // hkv, d).float()
    scores = torch.einsum("bngd,bnkd->bngk", qg, k_rows.float()) * d ** -0.5
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
                           window: int | None = None, ring: bool = False):
    """The plain PyTorch version of the flash_decode kernel: the same
    math in one pass (:func:`_masked_decode`)."""
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
    return _masked_decode(q, k_cache, v_cache, visible)


def _check_kernel_tensors(name: str, q, tensors: dict,
                          group: int | None = None) -> None:
    """What every kernel needs of its CUDA tensors: q's device and
    dtype (bf16 or f32), a head_dim in KERNEL_HEAD_DIMS, at most
    MAX_GROUP query heads per KV head (``group``, for the decode
    kernels), contiguous and 16-byte aligned."""
    d = q.shape[-1]
    for tname, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{tname} on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{tname} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name} kernel takes bf16 or f32, got {q.dtype}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name} kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    if group is not None and group > MAX_GROUP:
        raise ValueError(f"{name} kernel takes at most {MAX_GROUP} query "
                         f"heads per KV head, got {group}")
    for tname, t in {"q": q, **tensors}.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel needs a contiguous {tname}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} kernel needs {tname} aligned to 16 "
                             f"bytes")


def _launch(name: str, q, *args) -> None:
    """Call kernel ``name``'s C entry on q's device and current stream;
    raise if the launch was refused, count it otherwise."""
    fn = getattr(_library(name), name)
    rc = fn(*args, q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


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
                              window: int | None = None):
    """The plain PyTorch version of the flash_attention kernel, with its
    numerics in one pass: f32 scores scaled by d^-0.5 after the dot,
    masked entries at -1e30, f32 softmax, P cast to v's dtype before PV
    with f32 accumulation, out = acc / l in q's dtype and lse = m +
    log(l) in f32.  Returns (out [b, h, s, d], lse [b, h, s, 1])."""
    _validate_attention_args(q, k, v, causal, window)
    b, h, s, d = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, h // hkv, s, d).float()
    scores = torch.einsum("bngqd,bnkd->bngqk", qg, k.float()) * d ** -0.5
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


def flash_attention_forward(q, k, v, *, causal: bool = True,
                            window: int | None = None):
    """Fused attention over a whole sequence (see module doc): returns
    (out [b, h, s, d] in q's dtype, lse [b, h, s, 1] f32).

    CPU tensors run :func:`flash_attention_reference`.  CUDA tensors
    launch the kernel (bf16 or f32, head_dim 32, 64, 128 or 256, any s,
    contiguous) or raise.  Inputs that require grad raise: the kernel
    has no backward until K2 lands with the trainer (ROADMAP.md, slice
    4)."""
    _validate_attention_args(q, k, v, causal, window)
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "flash_attention has no backward yet: K2 lands with the "
            "trainer (ROADMAP.md, slice 4)")
    if not _on_cuda("flash_attention", q):
        return flash_attention_reference(q, k, v, causal=causal,
                                         window=window)
    b, h, s, d = q.shape
    _check_kernel_tensors("flash_attention", q, {"k": k, "v": v})
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s, 1), dtype=torch.float32, device=q.device)
    _launch("flash_attention", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, h, k.shape[1], s, d,
            _DTYPE_CODES[q.dtype], int(causal), window or 0)
    return out, lse


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None):
    """q [batch, heads, seq, head_dim]; k, v [batch, kv_heads, seq,
    head_dim] with heads % kv_heads == 0 -> output shaped like q.
    ``window=w`` (requires causal): each query sees only the w most
    recent keys including itself.  :func:`flash_attention_forward`
    without the lse."""
    return flash_attention_forward(q, k, v, causal=causal, window=window)[0]


def flash_decode(q, k_cache, v_cache, length, *, window: int | None = None,
                 ring: bool = False):
    """Fused cached attention for one decode step (see module doc).

    ``ring=True`` (requires ``window``): the cache is the serving ring
    layout over its max_len width — each slot's absolute position is
    recovered from the row's logical length, which may exceed the
    width.  Returns [b, h, 1, d] in q's dtype.

    CPU tensors run :func:`flash_decode_reference`.  CUDA tensors
    launch the kernel (bf16 or f32, head_dim 32, 64, 128 or 256, at most
    32 query heads per KV head, contiguous) or raise."""
    _check_args(q, k_cache, v_cache, window, ring)
    if not _on_cuda("flash_decode", q):
        return flash_decode_reference(q, k_cache, v_cache, length,
                                      window=window, ring=ring)
    b, h, _, d = q.shape
    hkv, max_len = k_cache.shape[1], k_cache.shape[2]
    lengths = _row_lengths(length, b, q.device)
    _check_kernel_tensors("flash_decode", q,
                          {"k_cache": k_cache, "v_cache": v_cache}, h // hkv)
    out = torch.empty_like(q)
    _launch("flash_decode", q, q.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), lengths.data_ptr(), out.data_ptr(), b, h,
            hkv, max_len, d, _DTYPE_CODES[q.dtype], window or 0, int(ring))
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
                                 window: int | None = None):
    """The plain PyTorch version of the paged_flash_decode kernel.

    The kernel's table semantics, which differ from gathering the rows
    and attending over them: a table entry < 0 hides its whole block,
    even below the row's length; an entry >= num_blocks is clamped to
    num_blocks - 1 and read.  Key position p is visible when
    p <= length - 1 (and p > length - 1 - window) and its block is
    live; a row with no visible key yields zeros."""
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
    return _masked_decode(q, k_rows, v_rows, visible)


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
    launch the kernel (bf16 or f32, head_dim 32, 64, 128 or 256, at
    most 32 query heads per KV head, any block size, contiguous pools)
    or raise; tables and lengths are taken as int32 on q's device."""
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
                          {"k_pool": k_pool, "v_pool": v_pool}, h // hkv)
    tables = tables.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    _launch("paged_flash_decode", q, q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), tables.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), slots, h, hkv, nb, bs, tpr, d,
            _DTYPE_CODES[q.dtype], window or 0)
    return out
