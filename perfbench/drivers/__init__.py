"""Drivers: one per kind of traffic (``serve``, ``train``).  A mix file
names its driver; ``run(cell, ...)`` builds the program, warms it up,
measures the window and checks what it produced."""
