"""Token-shard data loading for the port's trainer.

The counterpart of the JAX package's ``tpu_autoscaler/dataio.py``: binary
uint32 token shards served as [batch, seq+1] next-token windows, with
the code of its numpy engine copied verbatim.  Sampling is a pure
function of (seed, step, row) (splitmix64), so checkpoint resume replays
the exact stream with no loader state to persist, and the stream is the
JAX trainer's row for row.

The native C++ loader (``NativeTokenLoader``, with background prefetch)
is not ported yet: ``open_token_loader`` returns the numpy engine, whose
stream is bit-identical to it.
"""

from __future__ import annotations

import numpy as np

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


def open_token_loader(path: str, batch: int, window: int, seed: int = 0):
    """The numpy engine: the native loader is not ported yet, and the
    two give identical streams."""
    return PyTokenLoader(path, batch, window, seed)
