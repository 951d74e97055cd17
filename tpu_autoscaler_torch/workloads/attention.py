"""Cached attention for one decode step: the ``flash_decode`` CUDA
kernel, its plain PyTorch version, and the build that makes the kernel.

``flash_decode`` keeps the signature and the layout of the JAX
package's ``workloads/attention.py::flash_decode``: q ``[b, h, 1, d]``
(the new token's queries, already rotated), caches ``[b, kv_heads,
max_len, d]`` with the new k/v already written, and ``length`` a scalar
or a per-row ``[b]`` count of filled positions.  On CUDA tensors it
launches the hand-written Hopper kernel in ``csrc/flash_decode.cu``; on
CPU tensors it runs ``flash_decode_reference``, the same function in
plain PyTorch.  There is no fallback from one to the other: a CUDA
tensor the kernel does not take raises.

The kernel is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, under ``build/torch_kernels/``
of the checkout, and loaded with ``ctypes``.  Nothing here imports or
builds anything at module import.
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

#: head_dim values the kernel is instantiated for.
KERNEL_HEAD_DIMS = (64, 128)
#: The kernel runs one warp per query head of a GQA group.
MAX_GROUP = 32
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches per wrapper: each wrapper adds one where it launches
#: its kernel and nowhere else.  Callers zero and read them to show
#: that a path ran through the kernels.
LAUNCHES: dict[str, int] = {"flash_decode": 0}

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
KERNEL_SOURCES = {"flash_decode": CSRC / "flash_decode.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Each library exports one C function of the kernel's name: pointers
# (and the stream) as c_void_p, so ctypes never cuts them to 32 bits.
_ARGTYPES = {"flash_decode": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
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
    source and flags, so an edited source is rebuilt, never reused."""
    digest = hashlib.sha256(KERNEL_SOURCES[name].read_bytes())
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


def flash_decode_reference(q, k_cache, v_cache, length, *,
                           window: int | None = None, ring: bool = False):
    """The plain PyTorch version of the kernel: the same math in one
    pass.  f32 scores scaled after the dot, f32 softmax with P cast to
    v's dtype before PV, f32 accumulation, output in q's dtype.  A row
    with no visible key (length 0) yields zeros."""
    _check_args(q, k_cache, v_cache, window, ring)
    b, h, _, d = q.shape
    hkv, max_len = k_cache.shape[1], k_cache.shape[2]
    lengths = _row_lengths(length, b, q.device).long()
    qg = q.reshape(b, hkv, h // hkv, d).float()
    scores = torch.einsum("bngd,bnkd->bngk", qg,
                          k_cache.float()) * d ** -0.5
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
    visible = visible[:, None, None, :]
    scores = scores.masked_fill(~visible, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(visible, torch.exp(scores - m), 0.0)
    l_sum = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bngk,bnkd->bngd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    out = acc / l_sum.clamp_min(1e-30)
    return out.to(q.dtype).reshape(b, h, 1, d)


def flash_decode(q, k_cache, v_cache, length, *, window: int | None = None,
                 ring: bool = False):
    """Fused cached attention for one decode step (see module doc).

    ``ring=True`` (requires ``window``): the cache is the serving ring
    layout over its max_len width — each slot's absolute position is
    recovered from the row's logical length, which may exceed the
    width.  Returns [b, h, 1, d] in q's dtype.

    CPU tensors run :func:`flash_decode_reference`.  CUDA tensors
    launch the kernel (bf16 or f32, head_dim 64 or 128, at most 32
    query heads per KV head, contiguous) or raise."""
    _check_args(q, k_cache, v_cache, window, ring)
    if q.device.type == "cpu":
        return flash_decode_reference(q, k_cache, v_cache, length,
                                      window=window, ring=ring)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on cuda or cpu, not "
                         f"{q.device}")
    b, h, _, d = q.shape
    hkv, max_len = k_cache.shape[1], k_cache.shape[2]
    lengths = _row_lengths(length, b, q.device)
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_decode kernel takes bf16 or f32, got "
                         f"{q.dtype}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_decode kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    if h // hkv > MAX_GROUP:
        raise ValueError(f"flash_decode kernel takes at most {MAX_GROUP} "
                         f"query heads per KV head, got {h // hkv}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if not t.is_contiguous():
            raise ValueError(f"flash_decode kernel needs a contiguous "
                             f"{name}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_decode kernel needs {name} aligned "
                             f"to 16 bytes")
    out = torch.empty_like(q)
    fn = _library("flash_decode").flash_decode
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), b, h, hkv, max_len, d,
            _DTYPE_CODES[q.dtype], window or 0, int(ring), q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES["flash_decode"] += 1
    return out
