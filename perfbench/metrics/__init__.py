"""Per-layer metric readers: ``read(ctx) -> float | dict | None``; None
leaves the metric out of the line. The reader of a metric named in
BENCHMARK.json is ``<name>.py``, or, where there is none, the file named
by the part of the name before its first dot, so that metrics of one
definition (``idle_share.rollout``, ``idle_share.train``) share it."""
