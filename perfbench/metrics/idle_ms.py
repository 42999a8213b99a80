"""Idle time of the card a step in the span pass's gaps that began while
the layer's span was the innermost one open on the host's main thread
(``perfbench/spans.py``), in ms/step. The layer is the part of the metric's
name after ``idle_ms.``. Extra: ``host_ms_per_step``, the span's own host
time (less its children's)."""

from perfbench.spans import reading


def read(ctx):
    got = reading(ctx, __name__, "idle_ms")
    if got is None:
        return None
    layer, steps = got
    return {"value": 1e3 * layer["idle_s"] / steps,
            "host_ms_per_step": 1e3 * layer["host_s"] / steps}
