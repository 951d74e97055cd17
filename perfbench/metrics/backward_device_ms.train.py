"""Device ms a step of the work launched under the program's
``train.backward`` span (``torch.autograd.grad``, remat's recompute
included; launched from the autograd engine's thread), over the
profiled steps.  Moves ``train_tokens_per_s``."""

from perfbench import spans


def read(record):
    return spans.device_ms(record, "train.backward")
