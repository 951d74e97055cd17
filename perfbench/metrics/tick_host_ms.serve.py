"""The scheduler's own host time a tick: the mean over the window's
ticks of the program's ``serve.tick`` span less its
``serve.prefill.step``, ``serve.decode.step`` and ``serve.sync`` spans
(admission, lane choice, block growth, the host arrays, sampling's
bookkeeping, the stats).  Moves ``serve_tokens_per_s``."""

from perfbench import spans


def read(record):
    split = spans.tick_split(record)
    return None if split is None else split["host"]
