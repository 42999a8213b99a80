"""Loss functions (the JAX package's ``training/losses.py``), as functions
of ``(model, batch, generator=None) -> (loss, metrics)`` with the metrics
as device tensors.

BC: mean softmax cross-entropy on the 9-way logits, in float32 at least.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax CE with integer labels, on logits of at least float32
    (float64 logits of a reference run stay float64)."""
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    return F.cross_entropy(logits, labels.to(torch.int64))


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).to(torch.float32).mean()


def bc_loss_fn(model, batch, generator: torch.Generator | None = None):
    x, y = batch
    logits = model(x)
    loss = cross_entropy(logits, y)
    return loss, {"loss": loss.detach(), "accuracy": accuracy(logits.detach(), y)}
