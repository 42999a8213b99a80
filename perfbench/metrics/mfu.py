"""A whole step's share of the card's bf16 peak, in %: the FLOPs of one
unit of the cell's work (an env-step's policy forward, or an image's
forward and backward; ``FlopCounterMode`` at set-up, on a copy of the
model) × units traced ÷ the traced window ÷ (peak × cards)."""


def read(ctx):
    flops = ctx["facts"].get("flops_per_unit")
    if not flops or not ctx["trace"]:
        return None
    return 100.0 * flops * ctx["units"] / ctx["window_s"] / (
        ctx["peaks"]["bf16_flops"] * ctx["chips"])
