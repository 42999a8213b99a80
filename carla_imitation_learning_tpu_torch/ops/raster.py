"""Exact z-buffer band rasterizer: kernel A of the port.

The image is cut into bands of ``band_rows(H)`` rows. For each band,
``tile_lists`` gathers the nearest-first indices of the triangles whose
screen bbox meets it; ``raster_bands`` then walks that list per pixel with
an exact depth test. On a CUDA tensor ``raster_bands`` launches the
hand-written kernel ``csrc/raster_exact.cu``; on a CPU tensor it runs
``raster_bands_plain``, the same function in plain PyTorch over the same
bands and lists. Sky and distance shade are applied outside the kernel.

A setup projected with ``textures=True`` packs 23 rows instead of 17 (the
surface-UV rows) and takes the kernel's textured variant: each written
colour is multiplied by ``texture_factor`` (ops/texture.py) at the pixel's
perspective-correct surface point.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from carla_imitation_learning_tpu_torch.ops import cuda_lib
from carla_imitation_learning_tpu_torch.ops.texture import texture_factor
from carla_imitation_learning_tpu_torch.render.camera import TriangleSetup
from carla_imitation_learning_tpu_torch.render.plain_raster import SKY_HORIZON, SKY_TOP

TILE_ROWS = 32     # band height in pixel rows, clamped to a divisor of H
PACK_WIDTH = 17    # 9 edge + 3 znum + 3 rgb + 1 class + 1 zmin
TEX_PACK_WIDTH = PACK_WIDTH + 6  # + 3 unum + 3 vnum (procedural textures)
LUMA_W = (0.299, 0.587, 0.114)
PLAIN_BUDGET = 1 << 22  # elements per (B, R, chunk, rows, W) temporary


class LaunchCount:
    """Number of kernel launches a wrapper has made (reset by the caller);
    ``add`` counts one under a lock, so wrappers called from several
    threads lose no launch."""

    def __init__(self) -> None:
        self.launches = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self.launches += 1


EXACT_KERNEL = LaunchCount()      # flat variant
EXACT_TEX_KERNEL = LaunchCount()  # textured variant


def band_rows(height: int) -> int:
    """Largest divisor of ``height`` that is ≤ TILE_ROWS."""
    rows = min(TILE_ROWS, height)
    while height % rows:
        rows -= 1
    return rows


def luma(colors: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB → (...) luminance (reference imitation_dataset.py:121)."""
    return colors[..., 0] * LUMA_W[0] + colors[..., 1] * LUMA_W[1] + colors[..., 2] * LUMA_W[2]


def pack_setup(setup: TriangleSetup, luma_only: bool = False) -> torch.Tensor:
    """TriangleSetup → (B, 17, T) f32 coefficient-major table, or (B, 23, T)
    with the surface-UV rows when the setup carries them; invalid triangles
    get all-zero columns. With ``luma_only`` the colour slots carry the
    luminance."""
    colors = setup.colors
    if luma_only:
        colors = luma(colors)[..., None].expand_as(colors)
    B, T = setup.valid.shape
    parts = [setup.edges.reshape(B, T, 9), setup.znum, colors,
             setup.classes[..., None].to(torch.float32), setup.zmin[..., None]]
    if setup.unum is not None:
        parts += [setup.unum, setup.vnum]
    flat = torch.cat(parts, -1)
    return torch.where(setup.valid[..., None], flat, 0.0).transpose(1, 2).contiguous()


def tile_lists(setup: TriangleSetup, height: int, k: int, width: int | None = None,
               far: float = 300.0, rows_per_band: int | None = None):
    """Per band: nearest-first indices of intersecting triangles.

    → (idx (B, R, k) int32, count (B, R) int32). The order is a stable sort
    on zmin, so ties keep index order (kernel A's first-writer-wins rule
    depends on it)."""
    rows = rows_per_band or band_rows(height)
    n_rows = height // rows
    dev = setup.bbox.device
    xmin, xmax = setup.bbox[..., 0], setup.bbox[..., 1]
    ymin, ymax = setup.bbox[..., 2], setup.bbox[..., 3]
    onscreen = setup.valid & (setup.zmin < far)
    if width is not None:
        onscreen = onscreen & (xmax >= 0.0) & (xmin <= width)
    row_lo = (torch.arange(n_rows, dtype=torch.float32, device=dev) * rows)[None, :, None]
    row_hi = row_lo + rows
    hit = (ymax[:, None, :] >= row_lo) & (ymin[:, None, :] <= row_hi) & onscreen[:, None, :]
    count = torch.clamp(hit.sum(-1), max=k).to(torch.int32)
    score = torch.where(hit, setup.zmin[:, None, :], float("inf"))
    idx = torch.argsort(score, dim=-1, stable=True)[..., :k].to(torch.int32)
    return idx.contiguous(), count.contiguous()


def raster_bands_plain(tbl, idx, count, height: int, width: int, near: float,
                       far: float, n_channels: int, tile_rows: int):
    """Plain PyTorch version of the kernel over the same bands and lists.

    Within a chunk of list positions the winner is the first-occurring
    minimum (``argmin``) and it replaces the band's z-buffer only when
    strictly nearer — the same result as walking the list one triangle at a
    time with ``near < z < zbuf``. A 23-row table is textured: the winner's
    colour is multiplied by ``texture_factor`` at its (u, v). → (sem (B, H,
    W) int32, colour (B, C, H, W), depth (B, H, W))."""
    B, n_rows_tbl, T = tbl.shape
    textured = n_rows_tbl == TEX_PACK_WIDTH
    R, K = idx.shape[1], idx.shape[2]
    dev = tbl.device
    rows = tile_rows
    px = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5)
    py = (torch.arange(R, dtype=torch.float32, device=dev)[:, None] * rows
          + torch.arange(rows, dtype=torch.float32, device=dev)) + 0.5   # (R, rows)
    px = px.view(1, 1, 1, 1, width)
    py = py.view(1, R, 1, rows, 1)
    px_w, py_w = px[:, :, 0], py[:, :, 0]          # for (B, R, rows, W) winners
    tbl_t = tbl.transpose(1, 2)                                   # (B, T, 17|23)
    benv = torch.arange(B, device=dev).view(B, 1, 1)

    zbuf = torch.full((B, R, rows, width), far, device=dev)
    sem = torch.zeros((B, R, rows, width), dtype=torch.int32, device=dev)
    col = torch.zeros((n_channels, B, R, rows, width), device=dev)
    chunk = max(1, PLAIN_BUDGET // (B * R * rows * width))
    n_max = int(count.max()) if count.numel() else 0
    for j0 in range(0, n_max, chunk):
        j = torch.arange(j0, min(j0 + chunk, K), device=dev)
        co = tbl_t[benv, idx[:, :, j0:j0 + j.numel()].to(torch.int64)]  # (B, R, C, 17|23)
        live = j < count[..., None]                                # (B, R, C)
        c = [co[..., i, None, None] for i in range(PACK_WIDTH)]
        e0 = c[0] * px + c[1] * py + c[2]
        e1 = c[3] * px + c[4] * py + c[5]
        e2 = c[6] * px + c[7] * py + c[8]
        inside = (((e0 > 0) & (e1 > 0) & (e2 > 0))
                  | ((e0 < 0) & (e1 < 0) & (e2 < 0)))
        den = e0 + e1 + e2
        den = torch.where(den == 0.0, 1e-9, den)
        z = (c[9] * px + c[10] * py + c[11]) / den
        ok = inside & (z > near) & live[..., None, None]
        zm = torch.where(ok, z, float("inf"))
        win = torch.argmin(zm, dim=2, keepdim=True)               # (B, R, 1, rows, W)
        zwin = torch.gather(zm, 2, win)[:, :, 0]
        better = zwin < zbuf
        zbuf = torch.where(better, zwin, zbuf)

        def pick(i):
            v = co[..., i, None, None].expand(-1, -1, -1, rows, width)
            return torch.gather(v, 2, win)[:, :, 0]

        cls = pick(15).to(torch.int32)
        sem = torch.where(better, cls, sem)
        fac = 1.0
        if textured:   # the winner's perspective-correct (u, v)
            den_w = torch.gather(den, 2, win)[:, :, 0]
            u = (pick(17) * px_w + pick(18) * py_w + pick(19)) / den_w
            v = (pick(20) * px_w + pick(21) * py_w + pick(22)) / den_w
            fac = texture_factor(u, v, cls)
        for ch in range(n_channels):
            col[ch] = torch.where(better, pick(12 + ch) * fac, col[ch])

    def bands_to_image(a):
        return a.reshape(a.shape[:-3] + (height, width))

    return (bands_to_image(sem), bands_to_image(col).transpose(0, 1),
            bands_to_image(zbuf))


def raster_bands(tbl, idx, count, height: int, width: int, near: float,
                 far: float, n_channels: int, tile_rows: int):
    """Kernel A on CUDA tensors (``csrc/raster_exact.cu``), its plain
    PyTorch version on CPU tensors. tbl (B, 17, T) f32 (flat) or (B, 23, T)
    (textured), idx (B, R, K) int32, count (B, R) int32 → (sem, colour
    (B, C, H, W), depth)."""
    if not tbl.is_cuda:
        return raster_bands_plain(tbl, idx, count, height, width, near, far,
                                  n_channels, tile_rows)
    B, n_rows_tbl, T = tbl.shape
    R, K = idx.shape[1], idx.shape[2]
    textured = n_rows_tbl == TEX_PACK_WIDTH
    cuda_lib.check_cuda(tbl, "tbl", torch.float32,
                        (B, TEX_PACK_WIDTH if textured else PACK_WIDTH, T))
    cuda_lib.check_cuda(idx, "idx", torch.int32, (B, R, K))
    cuda_lib.check_cuda(count, "count", torch.int32, (B, R))
    if R * tile_rows != height or n_channels not in (1, 3) or width > 256:
        raise ValueError(f"unsupported band layout: R={R} rows={tile_rows} "
                         f"H={height} W={width} C={n_channels}")
    fn = cuda_lib.entry_point(
        "raster_exact", "raster_exact_launch",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
        + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    dev = tbl.device
    sem = torch.empty((B, height, width), dtype=torch.int32, device=dev)
    col = torch.empty((B, n_channels, height, width), dtype=torch.float32, device=dev)
    depth = torch.empty((B, height, width), dtype=torch.float32, device=dev)
    err = cuda_lib.launch(fn, dev, tbl.data_ptr(), idx.data_ptr(), count.data_ptr(),
                          sem.data_ptr(), col.data_ptr(), depth.data_ptr(), B, T, R, K,
                          height, width, tile_rows, n_channels, int(textured), near, far)
    cuda_lib.raise_on_error(err, "raster_exact")
    (EXACT_TEX_KERNEL if textured else EXACT_KERNEL).add()
    return sem, col, depth


def _rasterize_core(setup, height, width, near, far, max_tris_per_tile,
                    n_channels, luma_only):
    tbl = pack_setup(setup, luma_only=luma_only)
    n_tris = tbl.shape[2]
    k = n_tris if max_tris_per_tile is None else min(max_tris_per_tile, n_tris)
    rows = band_rows(height)
    idx, count = tile_lists(setup, height, k, width=width, far=far,
                            rows_per_band=rows)
    sem, chan, depth = raster_bands(tbl, idx, count, height, width, near, far,
                                    n_channels, rows)
    return chan, sem, depth


def _sky_t(height: int, device) -> torch.Tensor:
    return torch.arange(height, dtype=torch.float32, device=device) / max(height - 1, 1)


def rasterize_exact(setup: TriangleSetup, height: int, width: int,
                    near: float = 0.5, far: float = 300.0,
                    max_tris_per_tile: int | None = None):
    """→ (rgb (B, H, W, 3), sem (B, H, W) int32, depth (B, H, W)), with the
    sky gradient on misses and distance shade on hits."""
    rgb_p, sem, depth = _rasterize_core(setup, height, width, near, far,
                                        max_tris_per_tile, 3, luma_only=False)
    rgb = rgb_p.permute(0, 2, 3, 1)
    hit = depth < far
    t = _sky_t(height, depth.device)[:, None, None]
    sky = (torch.tensor(SKY_TOP, device=depth.device) * (1 - t)
           + torch.tensor(SKY_HORIZON, device=depth.device) * t)
    rgb = torch.where(hit[..., None], rgb, sky)
    shade = torch.where(hit, 1.0 / (1.0 + 0.004 * depth), 1.0)
    return rgb * shade[..., None], sem, depth


def rasterize_exact_luma(setup: TriangleSetup, height: int, width: int,
                         near: float = 0.5, far: float = 300.0,
                         max_tris_per_tile: int | None = None):
    """Grayscale exact path → (gray (B, H, W), sem (B, H, W) int32,
    depth (B, H, W)); luma is pre-dotted per triangle."""
    luma_p, sem, depth = _rasterize_core(setup, height, width, near, far,
                                         max_tris_per_tile, 1, luma_only=True)
    gray = luma_p[:, 0]
    hit = depth < far
    t = _sky_t(height, depth.device)[:, None]
    sky_top_l = luma(torch.tensor(SKY_TOP, device=depth.device))
    sky_hor_l = luma(torch.tensor(SKY_HORIZON, device=depth.device))
    sky_luma = sky_top_l * (1 - t) + sky_hor_l * t
    gray = torch.where(hit, gray, sky_luma)
    shade = torch.where(hit, 1.0 / (1.0 + 0.004 * depth), 1.0)
    return gray * shade, sem, depth
