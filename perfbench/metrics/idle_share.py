"""Share of the traced window in which no kernel, copy or set ran on the
card, in %: 1 − busy ÷ window (torch.profiler, CUPTI)."""


def read(ctx):
    trace = ctx["trace"]
    if not trace or trace["busy_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / ctx["window_s"])
