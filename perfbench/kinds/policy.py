"""A configuration's policy on both sides: the port's module built from the
configuration file, and the plain reference's forward, sharing one dict of
seeded weights."""

from __future__ import annotations

import copy

import torch

from perfbench.reference.models import ARCHS
from perfbench.weights import make_weights


def build(cfg: dict, seed: int, dev: torch.device):
    """→ (the port's model on ``dev`` with the seeded weights, the weights
    dict, reference forward ``f(weights, x, precision)``)."""
    from carla_imitation_learning_tpu_torch import models

    shapes_fn, forward = ARCHS[cfg["reference"]["arch"]]
    sizes = cfg["reference"]["sizes"]
    weights = make_weights(shapes_fn(**sizes), seed, dev)
    port_cls = getattr(models, cfg["port"]["class"])
    model = port_cls(**cfg["port"]["kwargs"], dtype=getattr(torch, cfg["compute_dtype"])).to(dev)
    model.load_state_dict(weights, strict=True)

    def reference(w, x, precision="fp32"):
        return forward(w, x, precision=precision, **sizes)

    return model, weights, reference


def flops(model: torch.nn.Module, x_shape: tuple, backward: bool) -> float:
    """FLOPs of one forward (and backward) of a copy of ``model`` on a zero
    input of ``x_shape``, counted by ``FlopCounterMode`` on the meta device
    (shapes only, nothing runs)."""
    from torch.utils.flop_counter import FlopCounterMode

    meta = copy.deepcopy(model).to("meta")
    x = torch.zeros(x_shape, device="meta")
    with FlopCounterMode(display=False) as counter:
        if backward:
            meta(x).float().sum().backward()
        else:
            with torch.no_grad():
                meta(x)
    return float(counter.get_total_flops())
