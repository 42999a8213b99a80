"""Device time a step of the kernels, copies and sets that the span pass
(``perfbench/spans.py``) attributes to one layer, in ms/step: those
launched while the layer's span was the innermost one open. The layer is
the part of the metric's name after ``device_ms.``. Extra:
``launches_per_step``."""

from perfbench.spans import reading


def read(ctx):
    got = reading(ctx, __name__, "device_ms")
    if got is None:
        return None
    layer, steps = got
    return {"value": 1e3 * layer["device_s"] / steps,
            "launches_per_step": layer["launches"] / steps}
