"""Device ms a call of the work launched under the program's
``serve.decode.step`` span (its ``serve.decode.inputs`` included), over
the profiled ticks; against ``decode_step_ms.serve`` it says how much
of a call the device works.  Moves ``serve_tokens_per_s``."""

from perfbench import spans


def read(record):
    return spans.device_ms(record, "serve.decode.step", "serve.decode.inputs")
