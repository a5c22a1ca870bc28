"""Per-layer metric readers, one file a metric, found by the metric's name.

Each defines ``read(run) -> float | None``: ``run`` is the traced run's
record (``benchmark.run.RunRecord``). A reader that finds nothing to read
returns None, and the metric is left out of the result line.
"""
