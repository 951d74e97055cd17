"""PyTorch/CUDA port of the in-tree serving workload.

``tpu_autoscaler_torch`` mirrors the layout and names of the JAX
package's ``workloads/`` and ``serving/`` modules so each module's
counterpart is easy to find, and holds them to the JAX package's
numbers in ``tests/test_torch_*.py``.  It imports ``torch``, numpy and
click, never ``jax`` and nothing of ``tpu_autoscaler``: what it needs
from framework-free modules there, it keeps as its own copy.

The decode step's cache read is a hand-written CUDA kernel for Hopper
(``csrc/flash_decode.cu``), built with ``nvcc`` at first use.  Entry
points run on ``cuda`` unless the caller asks for ``cpu``.
"""
