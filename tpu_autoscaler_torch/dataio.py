"""Token-shard data loading for the port's trainer.

The counterpart of the JAX package's ``tpu_autoscaler/dataio.py``: binary
uint32 token shards served as [batch, seq+1] next-token windows.  Two
engines with bit-identical output, their code copied from the JAX
package's:

- ``NativeTokenLoader`` — the C++ loader (``csrc/tokenloader.cpp``, a
  copy of the JAX package's ``native/tokenloader.cpp``): mmap'd shard,
  one background thread filling the next step's batch while the device
  runs the current one.  Built at first use with the system C++
  compiler into ``build/torch_native/`` of the checkout (the file name
  carries a hash of the source and flags, so an edited source is
  rebuilt, never reused), and loaded with ``ctypes``.
- ``PyTokenLoader`` — pure numpy fallback (no compiler needed), same
  stateless splitmix64 sampling.

Sampling is a pure function of (seed, step, row), so checkpoint resume
replays the exact stream with no loader state to persist, and the
stream is the JAX trainer's row for row.  ``open_token_loader`` takes
the native engine when it builds and the numpy one otherwise, and logs
its choice once per process.  Nothing here builds or loads anything at
import.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

log = logging.getLogger(__name__)

_PKG = Path(__file__).resolve().parent
LOADER_SOURCE = _PKG / "csrc" / "tokenloader.cpp"
BUILD_DIR = _PKG.parent / "build" / "torch_native"
# native/Makefile's flags.
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared")
_lib_lock = threading.Lock()
# "lib": the loaded library, or None when it cannot be built or loaded.
_lib_state: dict = {}

_MASK = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    """Bit-identical twin of tokenloader.cpp::splitmix64."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return (x ^ (x >> 31)) & _MASK


def row_offset(seed: int, step: int, row: int, span: int) -> int:
    """Start offset of (step, row) — THE sampling rule, shared verbatim
    with the native loader (tokenloader.cpp::row_offset)."""
    return _splitmix64(seed ^ _splitmix64(step ^ _splitmix64(row))) % span


def write_token_file(path: str, tokens: np.ndarray) -> None:
    """Write a uint32 token shard (little-endian, the loaders' format)."""
    np.asarray(tokens, dtype="<u4").tofile(path)


def loader_library_path() -> Path:
    """Where the native loader's library lives: named after the hash of
    its source and the compiler flags."""
    digest = hashlib.sha256(LOADER_SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libtokenloader-{digest.hexdigest()[:16]}.so"


def build_loader() -> Path:
    """Compile the native loader with ``g++`` unless it is built
    already: into a temporary file renamed into place, so processes
    building at once never load a half-written library.  Returns its path;
    raises RuntimeError without a compiler or when the build fails."""
    out = loader_library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(LOADER_SOURCE),
           "-lpthread"]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} exited {res.returncode}:\n"
                           f"{res.stderr}")
    os.replace(tmp, out)
    return out


def _configure_tokenloader(lib: ctypes.CDLL) -> None:
    lib.tl_open.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                            ctypes.c_int64, ctypes.c_uint64]
    lib.tl_open.restype = ctypes.c_int64
    lib.tl_next.argtypes = [ctypes.c_int64, ctypes.c_int64,
                            ctypes.POINTER(ctypes.c_uint32)]
    lib.tl_next.restype = ctypes.c_int
    lib.tl_prefetch.argtypes = [ctypes.c_int64, ctypes.c_int64]
    lib.tl_prefetch.restype = ctypes.c_int
    lib.tl_n_tokens.argtypes = [ctypes.c_int64]
    lib.tl_n_tokens.restype = ctypes.c_int64
    lib.tl_close.argtypes = [ctypes.c_int64]
    lib.tl_close.restype = ctypes.c_int


def _load_lib() -> ctypes.CDLL | None:
    """The native loader's library, built and loaded at first use, or
    None when that fails (the verdict is kept for the process and
    logged once)."""
    with _lib_lock:
        if "lib" not in _lib_state:
            try:
                path = build_loader()
                lib = ctypes.CDLL(str(path))
                _configure_tokenloader(lib)
            except (RuntimeError, OSError, AttributeError) as e:
                _lib_state["lib"] = None
                log.info("token loader: numpy engine (the native loader "
                         "is unavailable: %s)", e)
            else:
                _lib_state["lib"] = lib
                log.info("token loader: native engine (%s)", path)
        return _lib_state["lib"]


def native_available() -> bool:
    """True when the native loader builds and loads here."""
    return _load_lib() is not None


class PyTokenLoader:
    """Numpy reference engine (and no-toolchain fallback)."""

    def __init__(self, path: str, batch: int, window: int, seed: int = 0):
        if window < 2 or batch < 1:
            raise ValueError("window must be >= 2 and batch >= 1")
        self._tokens = np.memmap(path, dtype="<u4", mode="r")
        if self._tokens.size < window:
            raise ValueError(
                f"shard {path} has {self._tokens.size} tokens, need at "
                f"least one window of {window}")
        self.batch, self.window, self.seed = batch, window, seed
        self.n_tokens = int(self._tokens.size)

    def next(self, step: int) -> np.ndarray:
        span = self.n_tokens - self.window + 1
        out = np.empty((self.batch, self.window), np.uint32)
        for r in range(self.batch):
            off = row_offset(self.seed, step, r, span)
            out[r] = self._tokens[off:off + self.window]
        return out

    def close(self) -> None:
        self._tokens = None


class NativeTokenLoader:
    """ctypes front end of the C++ loader; raises if unavailable."""

    def __init__(self, path: str, batch: int, window: int, seed: int = 0):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("native token loader unavailable")
        handle = lib.tl_open(path.encode(), window, batch, seed)
        if handle < 0:
            raise ValueError(
                f"tl_open({path!r}) failed with code {handle} (missing "
                f"file, or shard shorter than one window of {window})")
        self._lib, self._handle = lib, handle
        self.batch, self.window = batch, window
        self.n_tokens = int(lib.tl_n_tokens(handle))

    def next(self, step: int) -> np.ndarray:
        out = np.empty((self.batch, self.window), np.uint32)
        rc = self._lib.tl_next(
            self._handle, step,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
        if rc != 0:
            raise RuntimeError(f"tl_next failed rc={rc}")
        # Overlap the NEXT step's fill with the device step.
        self._lib.tl_prefetch(self._handle, step + 1)
        return out

    def close(self) -> None:
        if self._handle is not None:
            self._lib.tl_close(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover — best-effort cleanup
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass


def open_token_loader(path: str, batch: int, window: int, seed: int = 0):
    """Native when the toolchain allows, numpy otherwise — identical
    streams either way."""
    try:
        return NativeTokenLoader(path, batch, window, seed)
    except RuntimeError:
        return PyTokenLoader(path, batch, window, seed)
