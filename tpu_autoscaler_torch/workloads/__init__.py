"""The in-tree transformer workload on PyTorch: model, cached attention
(with the ``flash_decode`` CUDA kernel), the continuous-batching engine
and its ``serve`` CLI."""
