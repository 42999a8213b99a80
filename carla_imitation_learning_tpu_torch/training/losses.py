"""Loss functions (the JAX package's ``training/losses.py``), as functions
of ``(model, batch, generator=None) -> (loss, metrics)`` with the metrics
as device tensors.

BC: mean softmax cross-entropy on the 9-way logits, in float32 at least;
continuous BC: weighted MSE on (steer, accel); CIL: cross-entropy of the
active branch plus a weighted MSE of the speed head.
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


def continuous_bc_loss_fn(steer_weight: float = 1.0, accel_weight: float = 0.5):
    """Regression BC for ``ContinuousPolicyCNN``: ``steer_weight`` · MSE of
    the steer plus ``accel_weight`` · MSE of the acceleration, on a batch
    ``(x, y)`` with y (B, 2) float (``DeviceDataset(continuous_labels=...)``)."""

    def loss_fn(model, batch, generator: torch.Generator | None = None):
        x, y = batch
        pred = model(x)
        pred = pred.to(torch.promote_types(pred.dtype, torch.float32))
        err2 = (pred - y) ** 2
        steer_mse, accel_mse = err2[:, 0].mean(), err2[:, 1].mean()
        loss = steer_weight * steer_mse + accel_weight * accel_mse
        pred = pred.detach()
        return loss, {"loss": loss.detach(), "steer_mse": steer_mse.detach(),
                      "accel_mse": accel_mse.detach(),
                      "steer_mae": (pred[:, 0] - y[:, 0]).abs().mean(),
                      "accel_mae": (pred[:, 1] - y[:, 1]).abs().mean()}

    return loss_fn


def cil_loss_fn(speed_weight: float = 0.1):
    """``BranchedCILPolicy`` on a batch ``(frames, speed, command, y)``
    (``DeviceDataset(cil=True)``): CE of the active branch plus
    ``speed_weight`` · MSE of the predicted speed."""

    def loss_fn(model, batch, generator: torch.Generator | None = None):
        frames, speed, command, y = batch
        logits, pred_speed = model(frames, speed, command)
        action_loss = cross_entropy(logits, y)
        speed_loss = ((pred_speed - speed) ** 2).mean()
        loss = action_loss + speed_weight * speed_loss
        return loss, {"loss": loss.detach(), "action_loss": action_loss.detach(),
                      "speed_loss": speed_loss.detach(),
                      "accuracy": accuracy(logits.detach(), y)}

    return loss_fn
