"""Observability for the port: the span tracer (``trace``), the flight
recorder (``recorder``, with ``trace_gaps``) and incident bundles
(``blackbox``), which the request-trace sampler
(``serving/reqtrace.py``) builds on.  Copies of the JAX package's
modules of the same names, code verbatim with imports rewritten; a path
under ``tpu_autoscaler/`` in their comments names the JAX package's
tooling."""
