"""Serving signal export for the port: the engine's stats recorder
(``stats``), the drain receipt (``drain``) and the request-trace
sampler (``reqtrace``), kept as copies of the JAX package's
numpy-only modules."""
