"""Image augmentation for the BC batches (the JAX package's ``ops/augment.py``):
a crop at a fixed 0.85 scale with per-image offsets, resized back
bilinearly; brightness/contrast jitter; Gaussian noise; a horizontal flip
with the matching steer relabel. Plain torch ops on (B, H, W, C) stacks.

Each op comes in two forms: ``random_*`` draws from a ``torch.Generator``
(on the generator's device, then moved to the batch's), and the plain form
takes its draws as tensors, so the same draws can be fed to both packages.
``augment_batch`` composes them in the JAX package's order: flip, crop,
jitter, noise.

The resize is ``F.interpolate(mode="bilinear", align_corners=False,
antialias=False)``. At 0.85 it upsamples, where ``jax.image.resize``'s
triangle kernel samples the same two neighbours with the same weights;
at the borders JAX renormalises the weights of the taps inside the image
and torch clamps the coordinate, which both give the edge pixel.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

CROP_SCALE = 0.85


def _uniform(generator: torch.Generator, shape: tuple, lo: float, hi: float) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return lo + (hi - lo) * u


def draw_flip(generator: torch.Generator, batch: int) -> torch.Tensor:
    return torch.rand(batch, generator=generator, device=generator.device) < 0.5


def draw_offsets(generator: torch.Generator, x: torch.Tensor, scale: float = CROP_SCALE):
    """Per-image crop offsets (y0, x0), each uniform over the valid range."""
    B, H, W, _ = x.shape
    ch, cw = crop_size(H, W, scale)
    g = generator.device
    return (torch.randint(0, H - ch + 1, (B,), generator=generator, device=g),
            torch.randint(0, W - cw + 1, (B,), generator=generator, device=g))


def draw_jitter(generator: torch.Generator, batch: int, brightness: float = 0.15,
                contrast: float = 0.15):
    """Brightness b in ±brightness and contrast c in 1 ± contrast, (B, 1, 1, 1)."""
    shape = (batch, 1, 1, 1)
    return (_uniform(generator, shape, -brightness, brightness),
            _uniform(generator, shape, 1 - contrast, 1 + contrast))


def draw_eps(generator: torch.Generator, x: torch.Tensor) -> torch.Tensor:
    return torch.randn(x.shape, generator=generator, device=generator.device)


def brightness_contrast(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """clip((x − mean) · c + mean + b, 0, 1) with the mean per image and
    b, c (B, 1, 1, 1)."""
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    b, c = b.to(x.device, x.dtype), c.to(x.device, x.dtype)
    return torch.clamp((x - mean) * c + mean + b, 0.0, 1.0)


def random_brightness_contrast(generator: torch.Generator, x: torch.Tensor,
                               brightness: float = 0.15, contrast: float = 0.15):
    return brightness_contrast(x, *draw_jitter(generator, x.shape[0], brightness, contrast))


def add_noise(x: torch.Tensor, eps: torch.Tensor, sigma: float = 0.02) -> torch.Tensor:
    """clip(x + sigma · eps, 0, 1) with eps standard normal, x's shape."""
    return torch.clamp(x + sigma * eps.to(x.device, x.dtype), 0.0, 1.0)


def random_noise(generator: torch.Generator, x: torch.Tensor, sigma: float = 0.02):
    return add_noise(x, draw_eps(generator, x), sigma)


def crop_size(h: int, w: int, scale: float = CROP_SCALE) -> tuple[int, int]:
    """One crop size for the whole batch (the shapes stay static)."""
    return int(h * scale), int(w * scale)


def crop_resize(x: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                scale: float = CROP_SCALE) -> torch.Tensor:
    """Crop each image at its (y0, x0) to ``crop_size`` and resize it back
    to (H, W) bilinearly."""
    B, H, W, _ = x.shape
    ch, cw = crop_size(H, W, scale)
    dev = x.device
    rows = y0.to(dev, torch.int64)[:, None] + torch.arange(ch, device=dev)
    cols = x0.to(dev, torch.int64)[:, None] + torch.arange(cw, device=dev)
    crops = x[torch.arange(B, device=dev)[:, None, None], rows[:, :, None], cols[:, None, :]]
    out = F.interpolate(crops.permute(0, 3, 1, 2), size=(H, W), mode="bilinear",
                        align_corners=False, antialias=False)
    return out.permute(0, 2, 3, 1)


def random_crop_resize(generator: torch.Generator, x: torch.Tensor,
                       scale: float = CROP_SCALE) -> torch.Tensor:
    return crop_resize(x, *draw_offsets(generator, x, scale), scale)


def hflip_with_labels(x: torch.Tensor, actions: torch.Tensor, flip: torch.Tensor):
    """Mirror the images where ``flip`` (B,) bool, and relabel their actions
    (class = acc · 3 + steer, steer 0 left, 1 straight, 2 right) to
    acc · 3 + (2 − steer)."""
    flip = flip.to(x.device, torch.bool)
    x_f = torch.where(flip[:, None, None, None], torch.flip(x, dims=(2,)), x)
    acc, steer = actions // 3, actions % 3
    return x_f, acc * 3 + torch.where(flip, 2 - steer, steer)


def random_hflip_with_labels(generator: torch.Generator, x: torch.Tensor,
                             actions: torch.Tensor):
    return hflip_with_labels(x, actions, draw_flip(generator, x.shape[0]))


@dataclasses.dataclass
class AugmentDraws:
    """One batch's draws: flip (B,) bool, crop offsets y0, x0 (B,) int,
    brightness b and contrast c (B, 1, 1, 1), noise eps (B, H, W, C); an
    op that is off leaves its draws None."""

    flip: torch.Tensor | None = None
    y0: torch.Tensor | None = None
    x0: torch.Tensor | None = None
    b: torch.Tensor | None = None
    c: torch.Tensor | None = None
    eps: torch.Tensor | None = None


def augment_draws(generator: torch.Generator, x: torch.Tensor, crop: bool = True,
                  flip: bool = True, jitter: bool = True, noise: bool = True) -> AugmentDraws:
    """Every draw ``augment_batch`` needs for the batch ``x``, on the
    generator's device."""
    d = AugmentDraws()
    if flip:
        d.flip = draw_flip(generator, x.shape[0])
    if crop:
        d.y0, d.x0 = draw_offsets(generator, x)
    if jitter:
        d.b, d.c = draw_jitter(generator, x.shape[0])
    if noise:
        d.eps = draw_eps(generator, x)
    return d


def augment_with(draws: AugmentDraws, x: torch.Tensor, actions: torch.Tensor):
    """The composed augmentation on given draws: flip, crop, jitter, noise,
    each where its draws are present → (x, actions)."""
    if draws.flip is not None:
        x, actions = hflip_with_labels(x, actions, draws.flip)
    if draws.y0 is not None:
        x = crop_resize(x, draws.y0, draws.x0)
    if draws.b is not None:
        x = brightness_contrast(x, draws.b, draws.c)
    if draws.eps is not None:
        x = add_noise(x, draws.eps)
    return x, actions


def augment_batch(generator: torch.Generator, x: torch.Tensor, actions: torch.Tensor,
                  crop: bool = True, flip: bool = True, jitter: bool = True,
                  noise: bool = True):
    """Composed augmentation of a BC batch from ``generator``'s draws."""
    return augment_with(augment_draws(generator, x, crop, flip, jitter, noise), x, actions)
