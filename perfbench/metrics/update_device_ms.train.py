"""Device ms a step of the work launched under the program's
``train.update`` span (``Optimizer.update`` and ``apply_updates``),
over the profiled steps.  Moves ``train_tokens_per_s``."""

from perfbench import spans


def read(record):
    return spans.device_ms(record, "train.update")
