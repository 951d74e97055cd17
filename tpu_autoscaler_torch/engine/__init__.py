"""The fit engine's batch shape scorer on PyTorch (``jaxfit``)."""
