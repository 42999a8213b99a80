"""Plain grayscale z-buffer with the rollout camera's shading rules.

What the closed loop's frame must show, per pixel: of the triangles that
pass the scene's cull (valid, nearest depth below ``far``, and, with a
level of detail, a screen box at least ``lod_px`` wide or tall), the
nearest one whose three sign-normalised edge functions are all positive
at the pixel centre and whose depth there is beyond ``near``; its
luminance dimmed by ``1 / (1 + 0.004 z)``. Pixels that no triangle
covers, or whose nearest depth is ``far`` or more, show the sky's
vertical luminance gradient. Exact float32 depths, no bands, no lists.
"""

from __future__ import annotations

import torch

LUMA_W = (0.299, 0.587, 0.114)
SKY_TOP = (0.35, 0.55, 0.85)
SKY_HORIZON = (0.75, 0.85, 0.95)


def sky_luma(height: int, device) -> torch.Tensor:
    """(H, 1) luminance of the sky's vertical gradient."""
    top = sum(w * c for w, c in zip(LUMA_W, SKY_TOP))
    hor = sum(w * c for w, c in zip(LUMA_W, SKY_HORIZON))
    t = torch.arange(height, dtype=torch.float32, device=device) / max(height - 1, 1)
    return (top * (1.0 - t) + hor * t)[:, None]


def rasterize_gray(edges, znum, colors, valid, bbox, zmin, height: int, width: int,
                   near: float = 0.5, far: float = 300.0, lod_px: float = 0.0,
                   chunk: int = 32, dtype=torch.float32):
    """edges (B, T, 3, 3), znum (B, T, 3), colors (B, T, 3), valid (B, T),
    bbox (B, T, 4), zmin (B, T) → (gray (B, H, W) in [0, 1], covering
    (B,) int64: the (triangle, pixel) pairs that pass the inside and depth
    tests). ``dtype`` is the precision of the edge and depth arithmetic."""
    B, T = valid.shape
    dev = edges.device
    keep = valid & (zmin < far)
    if lod_px > 0.0:
        keep = keep & ((bbox[..., 1] - bbox[..., 0] >= lod_px)
                       | (bbox[..., 3] - bbox[..., 2] >= lod_px))
    lum = colors[..., 0] * LUMA_W[0] + colors[..., 1] * LUMA_W[1] + colors[..., 2] * LUMA_W[2]
    px = (torch.arange(width, dtype=dtype, device=dev) + 0.5)[None, :]
    py = (torch.arange(height, dtype=dtype, device=dev) + 0.5)[:, None]
    edges, znum = edges.to(dtype), znum.to(dtype)
    zbuf = torch.full((B, height, width), float("inf"), device=dev)
    lbuf = torch.zeros((B, height, width), device=dev)
    covering = torch.zeros(B, dtype=torch.int64, device=dev)
    for c0 in range(0, T, chunk):
        sl = slice(c0, min(c0 + chunk, T))
        e = edges[:, sl, :, :, None, None]                        # (B, C, 3, 3, 1, 1)
        ev = e[:, :, :, 0] * px + e[:, :, :, 1] * py + e[:, :, :, 2]   # (B, C, 3, H, W)
        zn = znum[:, sl, :, None, None]
        z = (zn[:, :, 0] * px + zn[:, :, 1] * py + zn[:, :, 2]) / ev.sum(2)
        ok = (ev.amin(2) > 0) & (z > near) & keep[:, sl, None, None]
        covering += ok.sum((1, 2, 3))
        zm = torch.where(ok, z.to(torch.float32), float("inf"))
        zc, win = zm.min(1)                                       # (B, H, W)
        lc = torch.gather(lum[:, sl], 1, win.reshape(B, -1)).reshape(B, height, width)
        better = zc < zbuf
        zbuf = torch.where(better, zc, zbuf)
        lbuf = torch.where(better, lc, lbuf)
    hit = zbuf < far
    lit = lbuf / (1.0 + 0.004 * torch.where(hit, zbuf, 0.0))
    return torch.where(hit, lit, sky_luma(height, dev)), covering
