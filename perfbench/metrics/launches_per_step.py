"""Device kernels launched in the traced window ÷ steps traced (fleet steps,
or train steps)."""


def read(ctx):
    trace = ctx["trace"]
    if not trace or not trace["launches"]:
        return None
    return trace["launches"] / (ctx["calls"] * ctx["facts"]["steps_per_call"])
