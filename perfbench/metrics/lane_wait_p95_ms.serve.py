"""The 95th percentile over the requests seeded in the window of their
lane wait: the wall time of the ticks in which each held unprefilled
prompt without a prefill lane (the ``lane_wait_s`` of the program's
``serve.request.prefill`` spans).  Moves ``serve_tokens_per_s``."""

from perfbench import spans


def read(record):
    return spans.lane_wait_p95_ms(record)
