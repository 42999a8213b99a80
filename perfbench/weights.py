"""Seeded weights and inputs that the benchmark hands to both the port and
the plain reference."""

from __future__ import annotations

import math

import torch

# std of a standard normal clamped to [-2, 2], which the draws are divided by
_CLAMPED_STD = 0.8796256610342398


def make_weights(shapes: dict, seed: int, device) -> dict:
    """{name: (shape, init)} → {name: float32 tensor on ``device``}, drawn
    in one call from a generator on the device seeded with ``seed``. An
    ``init`` that is a number is a fan-in: a normal clamped to ±2 standard
    deviations with standard deviation sqrt(1 / fan-in) (flax's
    lecun_normal, near enough); None is a zero bias; "ln_weight" ones and
    "ln_bias" zeros; ("normal", std) a plain normal."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    drawn = [(n, s, i) for n, (s, i) in shapes.items()
             if isinstance(i, (int, tuple))]
    total = sum(math.prod(s) for _, s, _ in drawn)
    buf = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for name, (shape, init) in shapes.items():
        if isinstance(init, (int, tuple)):
            n = math.prod(shape)
            piece = buf[off:off + n].view(shape)
            off += n
            if isinstance(init, tuple):
                out[name] = piece * float(init[1])
            else:
                out[name] = piece.clamp(-2.0, 2.0) * (math.sqrt(1.0 / init) / _CLAMPED_STD)
        elif init == "ln_weight":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out
