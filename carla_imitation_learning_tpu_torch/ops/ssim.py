"""SSIM and MS-SSIM image similarity (the JAX package's ``ops/ssim.py``).

A separable 11-tap Gaussian blur (sigma 1.5) as two depthwise VALID
convolutions, the standard constants k1 = 0.01 and k2 = 0.03, and the Wang
et al. MS-SSIM power weights. Images are (B, H, W, C) in [0, max_val];
everything is computed in float32 (float64 images of a reference run stay
float64).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gaussian_kernel(size: int = 11, sigma: float = 1.5, device: torch.device | None = None,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    x = torch.arange(size, dtype=dtype, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def _blur(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Separable blur of an NCHW map: a (k, 1) then a (1, k) depthwise
    VALID convolution."""
    k, c = kernel.shape[0], x.shape[1]
    x = F.conv2d(x, kernel.view(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    return F.conv2d(x, kernel.view(1, 1, 1, k).expand(c, 1, 1, k), groups=c)


def ssim(x: torch.Tensor, y: torch.Tensor, max_val: float = 1.0,
         kernel_size: int = 11, sigma: float = 1.5):
    """(mean SSIM, mean contrast-structure term) over (B, H, W, C) batches;
    SSIM is in [−1, 1], 1 for identical images."""
    dt = torch.promote_types(x.dtype, torch.float32)
    x = x.to(dt).permute(0, 3, 1, 2)
    y = y.to(dt).permute(0, 3, 1, 2)
    kernel = _gaussian_kernel(kernel_size, sigma, x.device, dt)
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2

    mu_x, mu_y = _blur(x, kernel), _blur(y, kernel)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_x = _blur(x * x, kernel) - mu_xx
    sigma_y = _blur(y * y, kernel) - mu_yy
    sigma_xy = _blur(x * y, kernel) - mu_xy

    lum = (2 * mu_xy + c1) / (mu_xx + mu_yy + c1)
    cs = (2 * sigma_xy + c2) / (sigma_x + sigma_y + c2)
    return (lum * cs).mean(), cs.mean()


def _downsample2(x: torch.Tensor) -> torch.Tensor:
    """2× average pool of (B, H, W, C), an odd last row or column dropped."""
    b, h, w, c = x.shape
    return x[:, :h - h % 2, :w - w % 2, :].reshape(
        b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


def ms_ssim(x: torch.Tensor, y: torch.Tensor, max_val: float = 1.0,
            levels: int | None = None) -> torch.Tensor:
    """Multi-scale SSIM. Level i needs min(H, W) // 2^i ≥ 11, so the level
    count shrinks for small images (at most 5), and the weights of the
    levels kept are renormalised to sum to 1."""
    max_levels = 1
    hw = min(x.shape[1], x.shape[2])
    while max_levels < 5 and hw // (2 ** max_levels) >= 11:
        max_levels += 1
    n = min(levels or max_levels, max_levels)
    weights = torch.tensor(_MSSSIM_WEIGHTS[:n], dtype=torch.promote_types(x.dtype, torch.float32),
                           device=x.device)
    weights = weights / weights.sum()

    vals = []
    for i in range(n):
        s, cs = ssim(x, y, max_val)
        vals.append(s if i == n - 1 else cs)
        if i < n - 1:
            x, y = _downsample2(x), _downsample2(y)
    return torch.prod(torch.clamp(torch.stack(vals), min=1e-6) ** weights)


def ms_ssim_loss(x: torch.Tensor, y: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    return 1.0 - ms_ssim(x, y, max_val)
