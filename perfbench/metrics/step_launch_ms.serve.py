"""Host time a tick spends issuing the model step: the mean over the
window's ticks of the program's ``serve.prefill.step`` and
``serve.decode.step`` spans summed (the Python of the step functions
and their launches; the device runs behind them).  Moves
``serve_tokens_per_s``."""

from perfbench import spans


def read(record):
    split = spans.tick_split(record)
    return None if split is None else split["launch"]
