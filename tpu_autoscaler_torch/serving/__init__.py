"""Serving signal export for the port: the engine's stats recorder
(``stats``) and the drain receipt (``drain``), kept as copies of the
JAX package's numpy-only modules."""
