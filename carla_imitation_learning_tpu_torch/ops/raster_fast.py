"""Fast grayscale band rasterizer for policy rollouts: kernel B of the port.

Same band skeleton as ops/raster.py, with the rollout kernel's shortcuts:

- a packed int32 key ``(bits(z) & ~0xFFF) | luma12`` per candidate, so
  visibility is one running ``min`` (no z-buffer, no semantic plane);
- depth ``z = znum · rcp(den)``;
- the inside test ``min(e0, e1, e2) > 0`` (edges are sign-normalized at
  projection time);
- exact corner culling in the band lists (``tile_lists_fast``): a triangle
  is dropped from a band when one of its edge functions is negative over
  the whole band rectangle.

On a CUDA tensor ``fast_bands`` launches the hand-written kernel
``csrc/raster_fast.cu``; on a CPU tensor it runs ``fast_bands_plain``, the
same function in plain PyTorch over the same bands, lists and keys. The
JAX package's kernel takes an approximate reciprocal; both versions here
take the IEEE one (``__frcp_rn`` / ``torch.reciprocal``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from carla_imitation_learning_tpu_torch.ops import cuda_lib
from carla_imitation_learning_tpu_torch.ops.raster import (
    PLAIN_BUDGET, TILE_ROWS, LaunchCount, band_rows, luma,
)
from carla_imitation_learning_tpu_torch.render.camera import TriangleSetup
from carla_imitation_learning_tpu_torch.render.plain_raster import SKY_HORIZON, SKY_TOP
from carla_imitation_learning_tpu_torch.render.weather import visibility_far

LUMA_BITS = 12
LUMA_MASK = (1 << LUMA_BITS) - 1
KEY_MASK = ~LUMA_MASK  # keeps sign + exponent + 11 mantissa bits of the depth
MISS_KEY = 0x7FFFFFFF
FAST_PACK_WIDTH = 13   # 9 edge + 3 znum + 1 luma key
FAST_UNROLL = 2        # list entries per loop body (the kernel walks pairs)

FAST_KERNEL = LaunchCount()


def pack_key_const(z: float) -> int:
    """int32 key of a positive depth with zero luma bits."""
    return int(np.float32(z).view(np.int32)) & KEY_MASK


def _sky_luma(rgb) -> float:
    return float(np.asarray(rgb, np.float32) @ np.asarray((0.299, 0.587, 0.114), np.float32))


SKY_TOP_L = _sky_luma(SKY_TOP)
SKY_HOR_L = _sky_luma(SKY_HORIZON)


def pack_setup_fast(setup: TriangleSetup) -> torch.Tensor:
    """TriangleSetup → (B, 13, T) f32 coefficient-major table: edge rows,
    znum row and the 12-bit quantized luminance; invalid triangles get
    all-zero columns."""
    lum_q = torch.clamp(torch.round(luma(setup.colors) * LUMA_MASK), 0, LUMA_MASK)
    B, T = setup.valid.shape
    flat = torch.cat([setup.edges.reshape(B, T, 9), setup.znum, lum_q[..., None]], -1)
    return torch.where(setup.valid[..., None], flat, 0.0).transpose(1, 2).contiguous()


def compact_setup(setup: TriangleSetup, cap: int) -> TriangleSetup:
    """Gather the valid triangles, nearest-first, into a ``cap``-wide setup;
    overflow drops the farthest."""
    score = torch.where(setup.valid, setup.zmin, float("inf"))
    order = torch.argsort(score, dim=1, stable=True)[:, :cap]

    def take(a):
        ix = order.view(order.shape + (1,) * (a.dim() - 2)).expand(
            order.shape + a.shape[2:])
        return torch.gather(a, 1, ix)

    return TriangleSetup(edges=take(setup.edges), znum=take(setup.znum),
                         colors=take(setup.colors), classes=take(setup.classes),
                         valid=take(setup.valid), bbox=take(setup.bbox),
                         zmin=take(setup.zmin))


def tile_lists_fast(setup: TriangleSetup, height: int, k: int, width: int,
                    far: float = 300.0, lod_px: float = 0.0,
                    rows_per_band: int = TILE_ROWS):
    """Per band: indices of the triangles that can cover a pixel in it.

    Beyond the bbox test: the corner cull (edge functions are affine, so
    their maxima over the band rectangle [0, W]×[ylo, yhi] sit at corners)
    and, with ``lod_px > 0``, the scene LOD (drop triangles whose bbox is
    under ``lod_px`` pixels both ways). Hits are grouped first in index
    order; with ``k`` below the table width, hits are ordered by zmin rank
    so the cap drops the farthest. Keys are built in int64.
    → (idx (B, R, k) int32, count (B, R) int32)."""
    n_rows = height // rows_per_band
    dev = setup.bbox.device
    xmin, xmax = setup.bbox[..., 0], setup.bbox[..., 1]
    ymin, ymax = setup.bbox[..., 2], setup.bbox[..., 3]
    onscreen = setup.valid & (setup.zmin < far) & (xmax >= 0.0) & (xmin <= width)
    if lod_px > 0.0:
        onscreen = onscreen & ((xmax - xmin >= lod_px) | (ymax - ymin >= lod_px))
    row_lo = (torch.arange(n_rows, dtype=torch.float32, device=dev) * rows_per_band)[None, :, None]
    row_hi = row_lo + rows_per_band
    hit = (ymax[:, None, :] >= row_lo) & (ymin[:, None, :] <= row_hi) & onscreen[:, None, :]

    # corner cull: e(x, y) = a·x + b·y + c over x ∈ [0, W], y ∈ [ylo, yhi]
    a = setup.edges[..., 0]                                  # (B, T, 3)
    b = setup.edges[..., 1]
    c = setup.edges[..., 2]
    ax_max = torch.clamp(a * width, min=0.0)[:, None]        # (B, 1, T, 3)
    ylo = row_lo[..., None]                                  # (1, R, 1, 1)
    yhi = row_hi[..., None]
    by_max = torch.maximum(b[:, None] * ylo, b[:, None] * yhi)  # (B, R, T, 3)
    emax = ax_max + by_max + c[:, None]
    hit = hit & ~(emax < 0.0).any(-1)                        # (B, R, T)

    count = torch.clamp(hit.sum(-1), max=k).to(torch.int32)
    n_tris = hit.shape[-1]
    iota = torch.arange(n_tris, device=dev)
    if k < n_tris:
        rank = torch.argsort(torch.argsort(setup.zmin, dim=-1, stable=True),
                             dim=-1, stable=True)            # (B, T)
        packed = torch.where(hit, rank[:, None, :] << 16, 0xFFFF0000) | iota
        idx = torch.sort(packed, dim=-1).values[..., :k] & 0xFFFF
    else:
        packed = torch.where(hit, 0, 0x80000000) | iota
        idx = torch.sort(packed, dim=-1).values & 0xFFFF
    return idx.to(torch.int32).contiguous(), count.contiguous()


def fast_bands_plain(tbl, idx, count, height: int, width: int, near: float,
                     far: float, fog_density: float, tile_rows: int):
    """Plain PyTorch version of kernel B over the same bands, lists and
    packed keys: list positions below the count rounded up to the unroll
    width, a running min of the packed key, the same epilogue. → (B, H, W)."""
    B, _, T = tbl.shape
    R, K = idx.shape[1], idx.shape[2]
    dev = tbl.device
    rows = tile_rows
    n_pass = torch.clamp((count + FAST_UNROLL - 1) // FAST_UNROLL * FAST_UNROLL,
                         max=K)                                               # (B, R)
    px = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5).view(1, 1, 1, 1, width)
    y_off = torch.arange(R, dtype=torch.float32, device=dev)[:, None] * rows + 0.5
    py = torch.arange(rows, dtype=torch.float32, device=dev) + y_off          # (R, rows)
    pyb = py.view(1, R, 1, rows, 1)
    tbl_t = tbl.transpose(1, 2)                                               # (B, T, 13)
    benv = torch.arange(B, device=dev).view(B, 1, 1)

    kmin = torch.full((B, R, rows, width), MISS_KEY, dtype=torch.int32, device=dev)
    chunk = max(1, PLAIN_BUDGET // (B * R * rows * width))
    n_max = int(n_pass.max()) if n_pass.numel() else 0
    for j0 in range(0, n_max, chunk):
        j = torch.arange(j0, min(j0 + chunk, K), device=dev)
        co = tbl_t[benv, idx[:, :, j0:j0 + j.numel()].to(torch.int64)]     # (B, R, C, 13)
        live = j < n_pass[..., None]
        c = [co[..., i, None, None] for i in range(FAST_PACK_WIDTH)]
        e0 = c[0] * px + (c[1] * pyb + c[2])
        e1 = c[3] * px + (c[4] * pyb + c[5])
        e2 = c[6] * px + (c[7] * pyb + c[8])
        znp = c[9] * px + (c[10] * pyb + c[11])
        inside = torch.minimum(torch.minimum(e0, e1), e2) > 0.0
        den = e0 + e1 + e2
        z = znp * torch.reciprocal(den)
        ok = inside & (z > near) & live[..., None, None]
        key = (z.view(torch.int32) & KEY_MASK) | c[12].to(torch.int32)
        cand = torch.where(ok, key, MISS_KEY)
        kmin = torch.minimum(kmin, cand.amin(dim=2))

    far_key = pack_key_const(far)
    hit = kmin < far_key
    depth = (kmin & KEY_MASK).view(torch.float32)
    lum = (kmin & LUMA_MASK).to(torch.float32) * (1.0 / LUMA_MASK)
    shade = torch.reciprocal(1.0 + 0.004 * depth)
    t_sky = ((py - 0.5) * (1.0 / max(height - 1, 1)))[None, :, :, None]
    sky = SKY_TOP_L * (1.0 - t_sky) + SKY_HOR_L * t_sky
    lit = lum * shade
    if fog_density > 0.0:
        f = torch.exp(-fog_density * depth)
        lit = lit * f + sky * (1.0 - f)
    return torch.where(hit, lit, sky).reshape(B, height, width)


def fast_bands(tbl, idx, count, height: int, width: int, near: float,
               far: float, fog_density: float, tile_rows: int):
    """Kernel B on CUDA tensors (``csrc/raster_fast.cu``), its plain PyTorch
    version on CPU tensors. tbl (B, 13, T) f32, idx (B, R, K) int32 with K
    even, count (B, R) int32 → gray (B, H, W) f32."""
    if not tbl.is_cuda:
        return fast_bands_plain(tbl, idx, count, height, width, near, far,
                                fog_density, tile_rows)
    B, _, T = tbl.shape
    R, K = idx.shape[1], idx.shape[2]
    cuda_lib.check_cuda(tbl, "tbl", torch.float32, (B, FAST_PACK_WIDTH, T))
    cuda_lib.check_cuda(idx, "idx", torch.int32, (B, R, K))
    cuda_lib.check_cuda(count, "count", torch.int32, (B, R))
    if R * tile_rows != height or K % FAST_UNROLL or width > 256:
        raise ValueError(f"unsupported band layout: R={R} rows={tile_rows} "
                         f"H={height} W={width} K={K}")
    fn = cuda_lib.entry_point(
        "raster_fast", "raster_fast_launch",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int]
        + [ctypes.c_float] * 5 + [ctypes.c_void_p])
    out = torch.empty((B, height, width), dtype=torch.float32, device=tbl.device)
    err = fn(tbl.data_ptr(), idx.data_ptr(), count.data_ptr(), out.data_ptr(),
             B, T, R, K, height, width, tile_rows, near, pack_key_const(far),
             SKY_TOP_L, SKY_HOR_L, 1.0 / max(height - 1, 1), 1.0 / LUMA_MASK,
             fog_density, cuda_lib.stream_ptr(tbl.device))
    cuda_lib.raise_on_error(err, "raster_fast")
    FAST_KERNEL.launches += 1
    return out


def rasterize_luma_fast(setup: TriangleSetup, height: int, width: int,
                        near: float = 0.5, far: float = 300.0,
                        max_tris_per_tile: int | None = None,
                        compact_cap: int | None = None,
                        fog_density: float = 0.0, lod_px: float = 0.0):
    """→ gray (B, H, W) f32 in [0, 1], the policy observation channel.

    ``max_tris_per_tile`` caps each band's list (dropping the farthest);
    ``compact_cap`` pre-gathers the valid triangles into a table that wide;
    ``fog_density > 0`` fuses exponential fog into the epilogue and shrinks
    ``far`` to the visibility limit."""
    far = visibility_far(fog_density, far)
    rows = band_rows(height)
    if compact_cap is not None and compact_cap < setup.valid.shape[1]:
        setup = compact_setup(setup, compact_cap)
    tbl = pack_setup_fast(setup)
    n_tris = tbl.shape[2]
    k = n_tris if max_tris_per_tile is None else min(max_tris_per_tile, n_tris)
    idx, count = tile_lists_fast(setup, height, k, width=width, far=far,
                                 lod_px=lod_px, rows_per_band=rows)
    if k % FAST_UNROLL:  # the pair-wise walk may read one entry past k
        idx = torch.nn.functional.pad(idx, (0, FAST_UNROLL - k % FAST_UNROLL))
    return fast_bands(tbl, idx, count, height, width, near, far, fog_density, rows)
