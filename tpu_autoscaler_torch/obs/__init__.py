"""Observability for the port: the span tracer (``trace``), which the
serving engines and the train step open spans on and the request-trace
sampler (``serving/reqtrace.py``) builds on, and the flight recorder
(``recorder``, with ``trace_gaps`` and the ``SpanTotals`` sink).  They
began as copies of the JAX package's modules of the same names; a path
under ``tpu_autoscaler/`` in their comments names the JAX package's
tooling."""
