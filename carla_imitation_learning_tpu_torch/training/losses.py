"""Loss functions (the JAX package's ``training/losses.py``), as functions
of ``(model, batch, generator=None) -> (loss, metrics)`` with the metrics
as device tensors.

BC: mean softmax cross-entropy on the 9-way logits, in float32 at least
(with on-the-fly augmentation in ``bc_augmented_loss_fn``); continuous BC:
weighted MSE on (steer, accel); CIL: cross-entropy of the active branch
plus a weighted MSE of the speed head; dual-stream BC; the VAE's
alpha · MSE + beta · KL; the aux multi-task loss (recon, traffic, action,
and per-pixel seg CE with its mIoU); the world model's image and latent
terms (MSE or MS-SSIM); sequence BC of the recurrent policy. The metric
names are the JAX package's.
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


def kl_divergence(mu: torch.Tensor, log_var: torch.Tensor) -> torch.Tensor:
    """(−0.5 · Σ_z(1 + log σ² − μ² − σ²)), mean over the batch."""
    return (-0.5 * (1 + log_var - mu ** 2 - torch.exp(log_var)).sum(dim=1)).mean()


def bc_augmented_loss_fn(crop: bool = True, flip: bool = True, jitter: bool = True,
                         noise: bool = True):
    """BC loss behind ``ops.augment.augment_batch`` (crop-resize, flip with
    the steer relabel, brightness/contrast, noise), drawn from the step's
    generator; evaluation passes none, so it sees the frames as they are."""
    from carla_imitation_learning_tpu_torch.ops.augment import augment_batch

    def loss_fn(model, batch, generator: torch.Generator | None = None):
        x, y = batch
        if generator is not None:   # a data-parallel rank draws for the global batch
            x, y = augment_batch(generator, x, y, crop=crop, flip=flip, jitter=jitter,
                                 noise=noise, draw_shard=getattr(model, "draw_shard", None))
        return bc_loss_fn(model, (x, y))

    return loss_fn


def dual_stream_loss_fn(model, batch, generator: torch.Generator | None = None):
    """``DualStreamCNN`` on a batch ``(x_raw, x_seg, y)``."""
    x, x_seg, y = batch
    logits = model(x, x_seg)
    loss = cross_entropy(logits, y)
    return loss, {"loss": loss.detach(), "accuracy": accuracy(logits.detach(), y)}


def vae_loss_fn(alpha: float = 0.75, beta: float = 0.1):
    """``alpha`` · MSE(recon, x) + ``beta`` · KL on a batch of images (or a
    tuple whose first entry is the images); the train step's generator
    draws the reparameterisation noise, evaluation uses z = mu."""

    def loss_fn(model, batch, generator: torch.Generator | None = None):
        x = batch[0] if isinstance(batch, tuple) else batch
        recon, mu, log_var = model(x, generator)
        recon_loss = ((x.to(recon.dtype) - recon) ** 2).mean()
        kl = kl_divergence(mu, log_var)
        loss = alpha * recon_loss + beta * kl
        return loss, {"loss": loss.detach(), "recon_loss": recon_loss.detach(),
                      "kl_loss": kl.detach()}

    return loss_fn


def _aux_terms(frames, y, recon, traffic_logits, action_logits):
    recon_loss = ((frames.to(recon.dtype) - recon) ** 2).mean()
    return (recon_loss, cross_entropy(traffic_logits, y[:, 0]),
            cross_entropy(action_logits, y[:, 1]))


def aux_loss_fn(recon_weight: float = 0.0, traffic_weight: float = 0.0,
                action_weight: float = 1.0):
    """``AuxNet`` on a batch ``((frames, sensor), y)`` with y (B, 2) =
    (traffic light, action): the weighted recon MSE, traffic CE and action
    CE (the reference keeps only the action term, hence the defaults)."""

    def loss_fn(model, batch, generator: torch.Generator | None = None):
        (frames, sensor), y = batch
        recon, traffic_logits, action_logits = model(frames, sensor)
        recon_loss, traffic_loss, action_loss = _aux_terms(
            frames, y, recon, traffic_logits, action_logits)
        loss = (recon_weight * recon_loss + traffic_weight * traffic_loss
                + action_weight * action_loss)
        return loss, {"loss": loss.detach(), "image_recons_loss": recon_loss.detach(),
                      "traffic_loss": traffic_loss.detach(),
                      "autopilot_action_loss": action_loss.detach(),
                      "accuracy": accuracy(action_logits.detach(), y[:, 1])}

    return loss_fn


def mean_iou(seg_logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean intersection-over-union over the classes present (union > 0):
    seg_logits (B, H, W, C), labels (B, H, W) int → float32 scalar."""
    n_classes = seg_logits.shape[-1]
    classes = torch.arange(n_classes, device=labels.device)
    pred = seg_logits.argmax(-1)[..., None] == classes
    true = labels.to(torch.int64)[..., None] == classes
    dims = tuple(range(pred.dim() - 1))
    inter = (pred & true).sum(dims).to(torch.float32)
    union = (pred | true).sum(dims).to(torch.float32)
    present = union > 0
    ious = torch.where(present, inter / union.clamp(min=1), 0.0)
    return ious.sum() / present.sum().clamp(min=1).to(torch.float32)


def aux_seg_loss_fn(recon_weight: float = 0.0, traffic_weight: float = 0.0,
                    action_weight: float = 1.0, seg_weight: float = 0.5):
    """``AuxNet`` with its seg decoder on a batch ``((frames, sensor), y,
    seg_labels (B, H, W))`` (``AuxSegDataset``): the ``aux_loss_fn`` terms
    plus ``seg_weight`` · per-pixel CE, with the mIoU as a metric."""

    def loss_fn(model, batch, generator: torch.Generator | None = None):
        (frames, sensor), y, seg_y = batch
        recon, traffic_logits, action_logits, seg_logits = model(frames, sensor)
        recon_loss, traffic_loss, action_loss = _aux_terms(
            frames, y, recon, traffic_logits, action_logits)
        n_cls = seg_logits.shape[-1]
        seg_loss = cross_entropy(seg_logits.reshape(-1, n_cls), seg_y.reshape(-1))
        loss = (recon_weight * recon_loss + traffic_weight * traffic_loss
                + action_weight * action_loss + seg_weight * seg_loss)
        return loss, {"loss": loss.detach(), "image_recons_loss": recon_loss.detach(),
                      "traffic_loss": traffic_loss.detach(),
                      "autopilot_action_loss": action_loss.detach(),
                      "seg_loss": seg_loss.detach(),
                      "seg_miou": mean_iou(seg_logits.detach(), seg_y),
                      "accuracy": accuracy(action_logits.detach(), y[:, 1])}

    return loss_fn


def world_model_loss_fn(recon_weight: float = 1.0, latent_weight: float = 1.0,
                        pred_image_weight: float = 1.0, image_loss: str = "mse"):
    """``LatentWorldModel`` on a batch ``(frames (B, T, H, W, C), actions)``
    (``SequenceDataset``): reconstruction, latent prediction against the
    detached next latents, and predicted-image terms; the image terms are
    MSE or, with ``image_loss="ms_ssim"``, 1 − MS-SSIM over the B · T
    frames."""
    from carla_imitation_learning_tpu_torch.ops.ssim import ms_ssim_loss

    def image_term(a, b):
        if image_loss == "ms_ssim":
            return ms_ssim_loss(a.flatten(0, 1), b.flatten(0, 1))
        wide = torch.promote_types(a.dtype, torch.float32)
        return ((a.to(wide) - b.to(wide)) ** 2).mean()

    def loss_fn(model, batch, generator: torch.Generator | None = None):
        frames, actions = batch
        recon, z, z_pred, frames_pred = model(frames, actions)
        recon_loss = image_term(recon, frames)
        latent_loss = ((z_pred - z[:, 1:].detach()) ** 2).mean()
        pred_image_loss = image_term(frames_pred, frames[:, 1:])
        loss = (recon_weight * recon_loss + latent_weight * latent_loss
                + pred_image_weight * pred_image_loss)
        return loss, {"loss": loss.detach(), "recon_loss": recon_loss.detach(),
                      "latent_pred_loss": latent_loss.detach(),
                      "image_pred_loss": pred_image_loss.detach()}

    return loss_fn


def rnn_bc_loss_fn(model, batch, generator: torch.Generator | None = None):
    """Sequence BC for ``RecurrentPolicy`` on ``(frames_seq (B, T, H, W, C),
    actions_seq (B, T))``: mean CE over every step of every sequence."""
    frames_seq, actions_seq = batch
    logits, _ = model(frames_seq)
    loss = cross_entropy(logits.flatten(0, 1), actions_seq.reshape(-1))
    return loss, {"loss": loss.detach(), "accuracy": accuracy(logits.detach(), actions_seq)}
