"""Per-layer metrics: one reader each, ``metrics/<name>.py`` with
``read(trace, counts) -> float | None``; a quantity split by the end-to-end
metric it moves (``<name>.<part>``) has the one reader ``metrics/<name>.py``.
``trace`` is the traced window (``portbench.trace.Trace``), ``counts`` the
cell's work per call (``calls/<kind>.py: counts``).  A reader that finds
nothing to read returns None, and the harness leaves the metric out of the
line."""
