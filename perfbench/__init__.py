"""The benchmark of ``tpu_autoscaler_torch`` on an NVIDIA GPU.

``perfbench/run.py`` runs one cell of ``BENCHMARK.json`` once.  Every
configuration (``configs/<name>.json``), traffic mix
(``traffic/<name>.json``) and per-layer metric (``metrics/<name>.py``)
is a file of its own, found by the name ``BENCHMARK.json`` gives it; a
mix names the driver that runs it (``drivers/<driver>.py``).  The plain
reference that decides ``correct`` is in ``reference/``; it imports
nothing of the program.
"""
