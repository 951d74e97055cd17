"""Per-layer metric readers, one file each (``<name>.py`` with
``read(record)``), and the yardstick they share (``_arith``)."""
