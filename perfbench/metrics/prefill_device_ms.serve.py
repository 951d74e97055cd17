"""Device ms a call of the work launched under the program's
``serve.prefill.step`` span (its ``serve.prefill.inputs`` included),
over the profiled ticks.  Moves ``serve_tokens_per_s``."""

from perfbench import spans


def read(record):
    return spans.device_ms(record, "serve.prefill.step",
                           "serve.prefill.inputs")
