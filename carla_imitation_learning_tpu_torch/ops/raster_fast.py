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

Two opt-in variants of the same rollout render (``rasterize_luma_fast``):

- ``quads=True`` (kernel C, ``prim_bands`` / ``csrc/raster_prim.cu``):
  coplanar even/odd triangle pairs fused into 4-edge primitives
  (``fuse_prims``), depth from a screen-affine 1/z row, visibility a running
  MAX of ``(bits(1/z) & ~0xFFF) | luma12`` with 0 as the miss — no divide in
  the pass loop;
- ``vec=True`` (kernel D, ``vec_bands`` / ``csrc/raster_vec.cu``): kernel
  B's function read from per-band gathered tables (``gather_band_tables``)
  in groups of ``VEC_P`` list entries, bit-exact against kernel B.

All three take ``list_band_factor`` f (default 1): the lists are built over
bands of f·tile_rows rows, and render band r reads list row r // f. A
coarse list is a superset of each of its bands' own lists, so without a
``max_tris_per_tile`` cap the frame is the same at every factor.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from carla_imitation_learning_tpu_torch.ops import cuda_lib
from carla_imitation_learning_tpu_torch.ops.raster import (
    PLAIN_BUDGET, TILE_ROWS, LaunchCount, band_rows, luma,
)
from carla_imitation_learning_tpu_torch.render.camera import TriangleSetup
from carla_imitation_learning_tpu_torch.render.plain_raster import SKY_HORIZON, SKY_TOP
from carla_imitation_learning_tpu_torch.render.weather import visibility_far
from carla_imitation_learning_tpu_torch.utils.profiling import span

LUMA_BITS = 12
LUMA_MASK = (1 << LUMA_BITS) - 1
KEY_MASK = ~LUMA_MASK  # keeps sign + exponent + 11 mantissa bits of the depth
MISS_KEY = 0x7FFFFFFF
FAST_PACK_WIDTH = 13   # 9 edge + 3 znum + 1 luma key
FAST_UNROLL = 2        # list entries per loop body (the kernel walks pairs)
PRIM_PACK_WIDTH = 16   # 12 edge + 3 zinv + 1 luma key
VEC_P = 8              # list entries per group of the vec kernel
VEC_ROW = 16           # floats per band-table entry (13 rows + 3 pad)

FAST_KERNEL = LaunchCount()
PRIM_KERNEL = LaunchCount()
VEC_KERNEL = LaunchCount()


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


def tile_lists_fast(setup: "TriangleSetup | PrimSetup", height: int, k: int, width: int,
                    far: float = 300.0, lod_px: float = 0.0,
                    rows_per_band: int = TILE_ROWS, list_band_factor: int = 1):
    """Per list row of ``rows_per_band · list_band_factor`` image rows:
    indices of the triangles that can cover a pixel in it.

    Beyond the bbox test: the corner cull (edge functions are affine, so
    their maxima over the band rectangle [0, W]×[ylo, yhi] sit at corners)
    and, with ``lod_px > 0``, the scene LOD (drop triangles whose bbox is
    under ``lod_px`` pixels both ways). A PrimSetup's four edge rows are
    culled the same way. Hits are grouped first in index
    order; with ``k`` below the table width, hits are ordered by zmin rank
    so the cap drops the farthest. Keys are built in int64.
    → (idx (B, R, k) int32, count (B, R) int32), R = height // span."""
    span = rows_per_band * list_band_factor
    n_rows = height // span
    dev = setup.bbox.device
    xmin, xmax = setup.bbox[..., 0], setup.bbox[..., 1]
    ymin, ymax = setup.bbox[..., 2], setup.bbox[..., 3]
    onscreen = setup.valid & (setup.zmin < far) & (xmax >= 0.0) & (xmin <= width)
    if lod_px > 0.0:
        onscreen = onscreen & ((xmax - xmin >= lod_px) | (ymax - ymin >= lod_px))
    row_lo = (torch.arange(n_rows, dtype=torch.float32, device=dev) * span)[None, :, None]
    row_hi = row_lo + span
    hit = (ymax[:, None, :] >= row_lo) & (ymin[:, None, :] <= row_hi) & onscreen[:, None, :]

    # corner cull: e(x, y) = a·x + b·y + c over x ∈ [0, W], y ∈ [ylo, yhi]
    a = setup.edges[..., 0]                                  # (B, T, 3 or 4)
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


def _n_bands(n_list_rows: int, height: int, tile_rows: int, factor: int) -> int:
    """Render bands of ``n_list_rows`` lists shared by ``factor`` bands each;
    raises unless they tile the image in bands of ``tile_rows``."""
    if n_list_rows * factor * tile_rows != height:
        raise ValueError(f"unsupported band layout: {n_list_rows} list rows x factor "
                         f"{factor} x {tile_rows} rows != H={height}")
    return n_list_rows * factor


def _list_rows(n_list_rows: int, height: int, tile_rows: int, factor: int, dev):
    """The list row each render band reads: band r takes row r // factor."""
    R = _n_bands(n_list_rows, height, tile_rows, factor)
    return torch.arange(R, device=dev) // factor


def _band_grid(B: int, R: int, rows: int, width: int, dev):
    """Pixel centres of every band: px (1, 1, 1, 1, W), py (R, rows) and
    py as (1, R, 1, rows, 1) for (B, R, list chunk, rows, W) passes."""
    px = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5).view(1, 1, 1, 1, width)
    y_off = torch.arange(R, dtype=torch.float32, device=dev)[:, None] * rows + 0.5
    py = torch.arange(rows, dtype=torch.float32, device=dev) + y_off          # (R, rows)
    return px, py, py.view(1, R, 1, rows, 1)


def _tri_keys(c, px, pyb, near: float):
    """Kernel B's pass over 13 coefficient columns ``c`` (each (B, R, C, 1,
    1)): the packed key of every candidate, MISS_KEY where it fails."""
    e0 = c[0] * px + (c[1] * pyb + c[2])
    e1 = c[3] * px + (c[4] * pyb + c[5])
    e2 = c[6] * px + (c[7] * pyb + c[8])
    znp = c[9] * px + (c[10] * pyb + c[11])
    inside = torch.minimum(torch.minimum(e0, e1), e2) > 0.0
    den = e0 + e1 + e2
    z = znp * torch.reciprocal(den)
    key = (z.view(torch.int32) & KEY_MASK) | c[12].to(torch.int32)
    return torch.where(inside & (z > near), key, MISS_KEY)


def _sky_rows(py, height: int):
    t_sky = ((py - 0.5) * (1.0 / max(height - 1, 1)))[None, :, :, None]
    return SKY_TOP_L * (1.0 - t_sky) + SKY_HOR_L * t_sky


def _luma_epilogue(kmin, py, height: int, far: float, fog_density: float):
    """Kernel B's (and D's) epilogue: decode the running-min key of every
    band pixel (B, R, rows, W) → gray (B, H, W)."""
    B, _, _, width = kmin.shape
    hit = kmin < pack_key_const(far)
    depth = (kmin & KEY_MASK).view(torch.float32)
    lum = (kmin & LUMA_MASK).to(torch.float32) * (1.0 / LUMA_MASK)
    shade = torch.reciprocal(1.0 + 0.004 * depth)
    sky = _sky_rows(py, height)
    lit = lum * shade
    if fog_density > 0.0:
        f = torch.exp(-fog_density * depth)
        lit = lit * f + sky * (1.0 - f)
    return torch.where(hit, lit, sky).reshape(B, height, width)


def fast_bands_plain(tbl, idx, count, height: int, width: int, near: float,
                     far: float, fog_density: float, tile_rows: int,
                     list_band_factor: int = 1):
    """Plain PyTorch version of kernel B over the same bands, lists and
    packed keys: list positions below the count rounded up to the unroll
    width, a running min of the packed key, the same epilogue; band r reads
    list row r // list_band_factor. → (B, H, W)."""
    B, _, T = tbl.shape
    dev = tbl.device
    lrow = _list_rows(idx.shape[1], height, tile_rows, list_band_factor, dev)
    R, K = lrow.numel(), idx.shape[2]
    count = count[:, lrow]
    n_pass = torch.clamp((count + FAST_UNROLL - 1) // FAST_UNROLL * FAST_UNROLL,
                         max=K)                                               # (B, R)
    px, py, pyb = _band_grid(B, R, tile_rows, width, dev)
    tbl_t = tbl.transpose(1, 2)                                               # (B, T, 13)
    benv = torch.arange(B, device=dev).view(B, 1, 1)

    kmin = torch.full((B, R, tile_rows, width), MISS_KEY, dtype=torch.int32, device=dev)
    chunk = max(1, PLAIN_BUDGET // (B * R * tile_rows * width))
    n_max = int(n_pass.max()) if n_pass.numel() else 0
    for j0 in range(0, n_max, chunk):
        j = torch.arange(j0, min(j0 + chunk, K), device=dev)
        co = tbl_t[benv, idx[:, lrow, j0:j0 + j.numel()].to(torch.int64)]  # (B, R, C, 13)
        live = (j < n_pass[..., None])[..., None, None]
        cand = _tri_keys([co[..., i, None, None] for i in range(FAST_PACK_WIDTH)],
                         px, pyb, near)
        kmin = torch.minimum(kmin, torch.where(live, cand, MISS_KEY).amin(dim=2))
    return _luma_epilogue(kmin, py, height, far, fog_density)


def fast_bands(tbl, idx, count, height: int, width: int, near: float,
               far: float, fog_density: float, tile_rows: int,
               list_band_factor: int = 1):
    """Kernel B on CUDA tensors (``csrc/raster_fast.cu``), its plain PyTorch
    version on CPU tensors. tbl (B, 13, T) f32, idx (B, RL, K) int32 with K
    even, count (B, RL) int32, RL = H // (tile_rows · list_band_factor) list
    rows → gray (B, H, W) f32."""
    if not tbl.is_cuda:
        return fast_bands_plain(tbl, idx, count, height, width, near, far,
                                fog_density, tile_rows, list_band_factor)
    B, _, T = tbl.shape
    RL, K = idx.shape[1], idx.shape[2]
    cuda_lib.check_cuda(tbl, "tbl", torch.float32, (B, FAST_PACK_WIDTH, T))
    cuda_lib.check_cuda(idx, "idx", torch.int32, (B, RL, K))
    cuda_lib.check_cuda(count, "count", torch.int32, (B, RL))
    R = _n_bands(RL, height, tile_rows, list_band_factor)
    if K % FAST_UNROLL or width > 256:
        raise ValueError(f"unsupported band layout: H={height} W={width} K={K}")
    fn = cuda_lib.entry_point(
        "raster_fast", "raster_fast_launch",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int]
        + [ctypes.c_float] * 5 + [ctypes.c_int, ctypes.c_void_p])
    out = torch.empty((B, height, width), dtype=torch.float32, device=tbl.device)
    err = cuda_lib.launch(fn, tbl.device, tbl.data_ptr(), idx.data_ptr(), count.data_ptr(),
                          out.data_ptr(), B, T, R, K, height, width, tile_rows, near,
                          pack_key_const(far), SKY_TOP_L, SKY_HOR_L, 1.0 / max(height - 1, 1),
                          1.0 / LUMA_MASK, fog_density, list_band_factor)
    cuda_lib.raise_on_error(err, "raster_fast")
    FAST_KERNEL.add()
    return out


# ---------------------------------------------------------------------------
# Kernel C: fused quad primitives. Every scene emitter produces planar convex
# quads split as (v0, v1, v2) + (v0, v2, v3) at even/odd indices; such a pair
# becomes ONE 4-edge primitive, and since 1/z is screen-affine per plane the
# fused pass needs no perspective divide.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PrimSetup:
    """4-edge primitive table, batched (B, P, ...): fused quads and unfused
    triangles (4th edge row duplicated). Names line up with TriangleSetup
    where ``tile_lists_fast`` reads them (edges[..., i], valid, bbox, zmin)."""

    edges: torch.Tensor  # (B, P, 4, 3) sign-normalized border rows
    zinv: torch.Tensor   # (B, P, 3) affine 1/z row (per plane)
    luma: torch.Tensor   # (B, P) 12-bit-quantized luminance (stored as f32)
    valid: torch.Tensor  # (B, P) bool
    bbox: torch.Tensor   # (B, P, 4)
    zmin: torch.Tensor   # (B, P)


def _luma_q(colors):
    return torch.clamp(torch.round(luma(colors) * LUMA_MASK), 0, LUMA_MASK)


def fuse_prims(setup: TriangleSetup) -> PrimSetup:
    """TriangleSetup with ``pair_ok`` and ``zinv`` (``project_triangles(...,
    quads=True)``) → PrimSetup of the same width T: slot 2i holds the fused
    quad (pair fusable) or triangle 2i; slot 2i+1 holds triangle 2i+1 or is
    invalid. The quad's border rows are the two triangles' outer edge rows:
    {t0.E2, t0.E0, t1.E0, t1.E1}."""
    if setup.pair_ok is None or setup.zinv is None:
        raise ValueError("fuse_prims needs a setup projected with quads=True")
    B, T = setup.valid.shape
    E = setup.edges.reshape(B, T // 2, 2, 3, 3)
    ok = setup.pair_ok
    quad_edges = torch.stack([E[:, :, 0, 2], E[:, :, 0, 0], E[:, :, 1, 0],
                              E[:, :, 1, 1]], 2)
    tri0 = torch.cat([E[:, :, 0], E[:, :, 0, :1]], 2)      # duplicated 4th row
    tri1 = torch.cat([E[:, :, 1], E[:, :, 1, :1]], 2)
    even_edges = torch.where(ok[..., None, None], quad_edges, tri0)

    v0, v1 = setup.valid[:, 0::2], setup.valid[:, 1::2]
    even_valid = torch.where(ok, v0 & v1, v0)
    odd_valid = v1 & ~ok

    b0, b1 = setup.bbox[:, 0::2], setup.bbox[:, 1::2]
    union = torch.stack([torch.minimum(b0[..., 0], b1[..., 0]),
                         torch.maximum(b0[..., 1], b1[..., 1]),
                         torch.minimum(b0[..., 2], b1[..., 2]),
                         torch.maximum(b0[..., 3], b1[..., 3])], -1)
    even_bbox = torch.where(ok[..., None], union, b0)
    z0, z1 = setup.zmin[:, 0::2], setup.zmin[:, 1::2]
    even_zmin = torch.where(ok, torch.minimum(z0, z1), z0)
    lum_q = _luma_q(setup.colors)

    def interleave(a, b):
        return torch.stack([a, b], 2).reshape((B, T) + a.shape[2:])

    return PrimSetup(edges=interleave(even_edges, tri1),
                     zinv=interleave(setup.zinv[:, 0::2], setup.zinv[:, 1::2]),
                     luma=interleave(lum_q[:, 0::2], lum_q[:, 1::2]),
                     valid=interleave(even_valid, odd_valid),
                     bbox=interleave(even_bbox, b1),
                     zmin=interleave(even_zmin, z1))


def compact_prims(prims: PrimSetup, cap: int) -> PrimSetup:
    """Valid-primitive compaction, nearest-first (see compact_setup)."""
    score = torch.where(prims.valid, prims.zmin, float("inf"))
    order = torch.argsort(score, dim=1, stable=True)[:, :cap]

    def take(a):
        ix = order.view(order.shape + (1,) * (a.dim() - 2)).expand(
            order.shape + a.shape[2:])
        return torch.gather(a, 1, ix)

    return PrimSetup(**{f.name: take(getattr(prims, f.name))
                        for f in dataclasses.fields(PrimSetup)})


def pack_setup_prims(prims: PrimSetup) -> torch.Tensor:
    """PrimSetup → (B, 16, P) coefficient-major f32 table; invalid
    primitives get all-zero columns."""
    B, P = prims.valid.shape
    flat = torch.cat([prims.edges.reshape(B, P, 12), prims.zinv,
                      prims.luma[..., None]], -1)
    return torch.where(prims.valid[..., None], flat, 0.0).transpose(1, 2).contiguous()


_ITEM_QUEUES: dict = {}


def item_queue(device: torch.device) -> torch.Tensor:
    """The item counter of kernels C and D on ``device``'s current stream:
    two int32 that are zero between launches (each launch's last block sets
    them back), made once per stream so that launches on two streams never
    share one."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    if key not in _ITEM_QUEUES:
        _ITEM_QUEUES[key] = torch.zeros(2, dtype=torch.int32, device=device)
    return _ITEM_QUEUES[key]


def prim_far_key(far: float) -> int:
    """Smallest packed key strictly nearer than ``far`` (max luma at 1/far):
    a pixel is a hit iff its running-max key exceeds it."""
    return (int(np.float32(1.0 / far).view(np.int32)) & KEY_MASK) | LUMA_MASK


def prim_bands_plain(tbl, idx, count, height: int, width: int, near: float,
                     far: float, fog_density: float, tile_rows: int,
                     list_band_factor: int = 1):
    """Plain PyTorch version of kernel C over the same bands, lists and
    keys: four edge rows and the 1/z row per primitive, a running max of
    ``(bits(1/z) & ~0xFFF) | luma12`` (0 = miss) over list positions below
    the count rounded up to the unroll width; the epilogue shades by
    zi / (zi + 0.004) and fogs at depth 1 / max(zi, 1e-9); band r reads
    list row r // list_band_factor. → (B, H, W)."""
    B, _, T = tbl.shape
    dev = tbl.device
    lrow = _list_rows(idx.shape[1], height, tile_rows, list_band_factor, dev)
    R, K = lrow.numel(), idx.shape[2]
    count = count[:, lrow]
    n_pass = torch.clamp((count + FAST_UNROLL - 1) // FAST_UNROLL * FAST_UNROLL, max=K)
    px, py, pyb = _band_grid(B, R, tile_rows, width, dev)
    tbl_t = tbl.transpose(1, 2)                                               # (B, P, 16)
    benv = torch.arange(B, device=dev).view(B, 1, 1)
    inv_near = float(np.float32(1.0 / near))

    kmax = torch.zeros((B, R, tile_rows, width), dtype=torch.int32, device=dev)
    chunk = max(1, PLAIN_BUDGET // (B * R * tile_rows * width))
    n_max = int(n_pass.max()) if n_pass.numel() else 0
    for j0 in range(0, n_max, chunk):
        j = torch.arange(j0, min(j0 + chunk, K), device=dev)
        co = tbl_t[benv, idx[:, lrow, j0:j0 + j.numel()].to(torch.int64)]  # (B, R, C, 16)
        live = (j < n_pass[..., None])[..., None, None]
        c = [co[..., i, None, None] for i in range(PRIM_PACK_WIDTH)]
        e = [c[3 * i] * px + (c[3 * i + 1] * pyb + c[3 * i + 2]) for i in range(4)]
        zi = c[12] * px + (c[13] * pyb + c[14])
        m = torch.minimum(torch.minimum(e[0], e[1]), torch.minimum(e[2], e[3]))
        ok = (m > 0.0) & (zi < inv_near) & live
        key = (zi.view(torch.int32) & KEY_MASK) | c[15].to(torch.int32)
        kmax = torch.maximum(kmax, torch.where(ok, key, 0).amax(dim=2))

    hit = kmax > prim_far_key(far)
    ziw = (kmax & KEY_MASK).view(torch.float32)
    lum = (kmax & LUMA_MASK).to(torch.float32) * (1.0 / LUMA_MASK)
    shade = ziw * torch.reciprocal(ziw + 0.004)   # = 1 / (1 + 0.004·z)
    sky = _sky_rows(py, height)
    lit = lum * shade
    if fog_density > 0.0:
        depth = torch.reciprocal(torch.clamp(ziw, min=1e-9))
        f = torch.exp(-fog_density * depth)
        lit = lit * f + sky * (1.0 - f)
    return torch.where(hit, lit, sky).reshape(B, height, width)


def prim_bands(tbl, idx, count, height: int, width: int, near: float,
               far: float, fog_density: float, tile_rows: int,
               list_band_factor: int = 1):
    """Kernel C on CUDA tensors (``csrc/raster_prim.cu``), its plain PyTorch
    version on CPU tensors. tbl (B, 16, P) f32, idx (B, RL, K) int32 with K
    even, count (B, RL) int32, RL = H // (tile_rows · list_band_factor) list
    rows → gray (B, H, W) f32."""
    if not tbl.is_cuda:
        return prim_bands_plain(tbl, idx, count, height, width, near, far,
                                fog_density, tile_rows, list_band_factor)
    B, _, P = tbl.shape
    RL, K = idx.shape[1], idx.shape[2]
    cuda_lib.check_cuda(tbl, "tbl", torch.float32, (B, PRIM_PACK_WIDTH, P))
    cuda_lib.check_cuda(idx, "idx", torch.int32, (B, RL, K))
    cuda_lib.check_cuda(count, "count", torch.int32, (B, RL))
    R = _n_bands(RL, height, tile_rows, list_band_factor)
    if K % FAST_UNROLL or width > 256:
        raise ValueError(f"unsupported band layout: H={height} W={width} K={K}")
    fn = cuda_lib.entry_point(
        "raster_prim", "raster_prim_launch",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int]
        + [ctypes.c_float] * 5 + [ctypes.c_int, ctypes.c_void_p])
    out = torch.empty((B, height, width), dtype=torch.float32, device=tbl.device)
    queue = item_queue(tbl.device)
    err = cuda_lib.launch(fn, tbl.device, tbl.data_ptr(), idx.data_ptr(), count.data_ptr(),
                          out.data_ptr(), queue.data_ptr(), B, P, R, K, height, width, tile_rows,
                          float(np.float32(1.0 / near)), prim_far_key(far), SKY_TOP_L,
                          SKY_HOR_L, 1.0 / max(height - 1, 1), 1.0 / LUMA_MASK, fog_density,
                          list_band_factor)
    cuda_lib.raise_on_error(err, "raster_prim")
    PRIM_KERNEL.add()
    return out


# ---------------------------------------------------------------------------
# Kernel D: kernel B's function over per-band gathered coefficient tables,
# walked in groups of VEC_P entries with no index indirection in the loop.
# ---------------------------------------------------------------------------


def gather_band_tables(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, 13, T) coefficient table + (B, R, k) band lists → (B, R, k, 16)
    band-resident tables, one per list row (13 rows + 3 zero pad, so an entry is 64 bytes).
    The result is allocated once and filled in place: at 1024 envs, R = 4,
    k = 1408 it is 369 MB."""
    B, W13, T = tbl.shape
    R, k = idx.shape[1], idx.shape[2]
    src = torch.nn.functional.pad(tbl.transpose(1, 2), (0, VEC_ROW - W13))   # (B, T, 16)
    flat = (idx.to(torch.int64) + (torch.arange(B, device=idx.device) * T).view(B, 1, 1))
    out = torch.empty((B, R, k, VEC_ROW), dtype=tbl.dtype, device=tbl.device)
    torch.index_select(src.reshape(B * T, VEC_ROW), 0, flat.reshape(-1),
                       out=out.view(-1, VEC_ROW))
    return out


def vec_bands_plain(btbl, count, height: int, width: int, near: float,
                    far: float, fog_density: float, tile_rows: int,
                    list_band_factor: int = 1):
    """Plain PyTorch version of kernel D: kernel B's pass and epilogue over
    each band's table, for list positions below the count rounded up to a
    whole group of VEC_P; band r reads the table and count of list row
    r // list_band_factor. → (B, H, W)."""
    B, _, K, _ = btbl.shape
    dev = btbl.device
    lrow = _list_rows(btbl.shape[1], height, tile_rows, list_band_factor, dev)
    R = lrow.numel()
    count = count[:, lrow]
    n_pass = torch.clamp((count + VEC_P - 1) // VEC_P * VEC_P, max=K)
    px, py, pyb = _band_grid(B, R, tile_rows, width, dev)
    kmin = torch.full((B, R, tile_rows, width), MISS_KEY, dtype=torch.int32, device=dev)
    chunk = max(VEC_P, PLAIN_BUDGET // (B * R * tile_rows * width) // VEC_P * VEC_P)
    n_max = int(n_pass.max()) if n_pass.numel() else 0
    for j0 in range(0, n_max, chunk):
        co = btbl[:, lrow, j0:j0 + chunk]                                    # (B, R, C, 16)
        j = torch.arange(j0, j0 + co.shape[2], device=dev)
        live = (j < n_pass[..., None])[..., None, None]
        cand = _tri_keys([co[..., i, None, None] for i in range(FAST_PACK_WIDTH)],
                         px, pyb, near)
        kmin = torch.minimum(kmin, torch.where(live, cand, MISS_KEY).amin(dim=2))
    return _luma_epilogue(kmin, py, height, far, fog_density)


def vec_bands(btbl, count, height: int, width: int, near: float, far: float,
              fog_density: float, tile_rows: int, list_band_factor: int = 1):
    """Kernel D on CUDA tensors (``csrc/raster_vec.cu``), its plain PyTorch
    version on CPU tensors. btbl (B, RL, K, 16) f32 with K a multiple of
    VEC_P, 16-byte aligned (the kernel bulk-copies its rows), count (B, RL)
    int32, RL = H // (tile_rows · list_band_factor) list rows → gray (B, H,
    W) f32."""
    if not btbl.is_cuda:
        return vec_bands_plain(btbl, count, height, width, near, far,
                               fog_density, tile_rows, list_band_factor)
    B, RL, K, _ = btbl.shape
    cuda_lib.check_cuda(btbl, "btbl", torch.float32, (B, RL, K, VEC_ROW))
    cuda_lib.check_cuda(count, "count", torch.int32, (B, RL))
    R = _n_bands(RL, height, tile_rows, list_band_factor)
    if K % VEC_P or width > 256:
        raise ValueError(f"unsupported band layout: H={height} W={width} K={K}")
    if btbl.data_ptr() % 16:
        raise ValueError("btbl must be 16-byte aligned")
    fn = cuda_lib.entry_point(
        "raster_vec", "raster_vec_launch",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int]
        + [ctypes.c_float] * 5 + [ctypes.c_int, ctypes.c_void_p])
    out = torch.empty((B, height, width), dtype=torch.float32, device=btbl.device)
    queue = item_queue(btbl.device)
    err = cuda_lib.launch(fn, btbl.device, btbl.data_ptr(), count.data_ptr(), out.data_ptr(),
                          queue.data_ptr(), B, R, K, height, width, tile_rows, near,
                          pack_key_const(far), SKY_TOP_L, SKY_HOR_L, 1.0 / max(height - 1, 1),
                          1.0 / LUMA_MASK, fog_density, list_band_factor)
    cuda_lib.raise_on_error(err, "raster_vec")
    VEC_KERNEL.add()
    return out


def rasterize_luma_fast(setup: TriangleSetup, height: int, width: int,
                        near: float = 0.5, far: float = 300.0,
                        max_tris_per_tile: int | None = None,
                        compact_cap: int | None = None,
                        fog_density: float = 0.0, lod_px: float = 0.0,
                        list_band_factor: int = 1, quads: bool = False,
                        vec: bool = False):
    """→ gray (B, H, W) f32 in [0, 1], the policy observation channel.

    ``max_tris_per_tile`` caps each band's list (dropping the farthest);
    ``compact_cap`` pre-gathers the valid triangles into a table that wide;
    ``fog_density > 0`` fuses exponential fog into the epilogue and shrinks
    ``far`` to the visibility limit. ``list_band_factor`` f builds one list
    per f bands (coarse shared lists). ``quads`` takes kernel C (the setup must
    carry ``pair_ok`` and ``zinv``); otherwise ``vec`` takes kernel D, and
    by default kernel B runs. (The JAX package's ``quads=None`` turns kernel
    C on whenever the setup carries the pair analysis; here it is asked for
    explicitly.)"""
    far = visibility_far(fog_density, far)
    rows = band_rows(height)
    if quads:
        src = fuse_prims(setup)
        if compact_cap is not None and compact_cap < src.valid.shape[1]:
            src = compact_prims(src, compact_cap)
        tbl = pack_setup_prims(src)
    else:
        src = setup
        if compact_cap is not None and compact_cap < src.valid.shape[1]:
            src = compact_setup(src, compact_cap)
        tbl = pack_setup_fast(src)
    n_tris = tbl.shape[2]
    k = n_tris if max_tris_per_tile is None else min(max_tris_per_tile, n_tris)
    idx, count = tile_lists_fast(src, height, k, width=width, far=far,
                                 lod_px=lod_px, rows_per_band=rows,
                                 list_band_factor=list_band_factor)
    if vec and not quads:   # whole groups of VEC_P: pad the lists with index 0
        if k % VEC_P:
            idx = torch.nn.functional.pad(idx, (0, VEC_P - k % VEC_P))
        tables = gather_band_tables(tbl, idx)
        with span("raster"):
            return vec_bands(tables, count, height, width, near, far, fog_density, rows,
                             list_band_factor)
    if k % FAST_UNROLL:  # the pair-wise walk may read one entry past k
        idx = torch.nn.functional.pad(idx, (0, FAST_UNROLL - k % FAST_UNROLL))
    bands = prim_bands if quads else fast_bands
    with span("raster"):
        return bands(tbl, idx, count, height, width, near, far, fog_density, rows,
                     list_band_factor)
