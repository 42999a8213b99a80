"""The yardsticks of kernels A and B on their edge cases, on the CPU.

On the card, ``chip_smoke.py`` holds kernel A (``raster_bands``) and kernel
B (``fast_bands``) bit for bit against their plain PyTorch versions on the
synthetic band tables of ``chip_smoke.edge_case_tables``: edges through
pixel centres and warp-tile corners, slivers, both windings, den = 0,
equal-z duplicates, lists longer than two staging chunks, empty bands, odd
counts followed by a covering sub-LOD triangle, and bands of 32, 24 and 20
rows. Here the plain versions themselves are held, on the same tables at a
small size, against a straightforward numpy walk of each list one entry at
a time, as the TPU kernels walk it (``ops/raster.py:172-176`` of the JAX
package; the pair walk of ``ops/raster_fast.py:444-452`` for B), with the
plain versions' float32 expression order. Tolerance: none — semantic planes,
colours, depths and gray frames must be equal.

The walk computes the speckle factor with the port's ``texture_factor``,
because one ulp of ``sin`` moves the hash anywhere. torch's CPU ``sin``
takes a vectorized path for whole vectors and a scalar one for a tail, and
the two may differ by an ulp; the walk therefore evaluates it on a flat
tensor padded to a multiple of 64 elements (every element on the vector
path), as the plain version's tensors, whose sizes here are multiples of 64,
are.

The last tests check the argument behind the kernels' warp-tile culling on
the same tables: every entry that ``chip_smoke.warp_tile_keep`` (the
kernels' corner test, with their expressions) drops from a 16 x 16 tile
has no pixel of the tile inside; and the same for kernel C's 4-edge
primitives on a small rich fleet, whose kept pairs ``chip_smoke.py``'s
bounds count.
"""

import functools

import numpy as np
import pytest
import torch

import chip_smoke
from carla_imitation_learning_tpu_torch.ops import raster as p_raster
from carla_imitation_learning_tpu_torch.ops import raster_fast as p_fast
from carla_imitation_learning_tpu_torch.ops.texture import texture_factor

NEAR, FAR = 0.5, 300.0
N_ENVS = 2
FRAMES = [f"{h}x{w}" for h, w in chip_smoke.EDGE_FRAMES]
F32 = np.float32


@functools.lru_cache(maxsize=1)
def _cases():
    return {f"{c['height']}x{c['width']}": c
            for c in chip_smoke.edge_case_tables("cpu", n_envs=N_ENVS)}


def _texture(u, v, cls):
    """texture_factor on a flat tensor padded to a multiple of 64."""
    n = u.size
    pad = -n % 64

    def flat(a, dtype):
        return torch.from_numpy(np.pad(a.reshape(-1), (0, pad))).to(dtype)

    fac = texture_factor(flat(u, torch.float32), flat(v, torch.float32),
                         flat(np.full(u.shape, cls, np.int32), torch.int32))
    return fac[:n].numpy().reshape(u.shape)


@functools.lru_cache(maxsize=None)
def _walk_exact(frame: str, textured: bool):
    """Kernel A's function, one list entry at a time → (sem, rgb, depth)."""
    case = _cases()[frame]
    h, w, rows = case["height"], case["width"], case["rows"]
    tbl = case["tex"].numpy()
    if not textured:
        tbl = tbl[:, :p_raster.PACK_WIDTH]
    idx, count = case["idx_a"].numpy(), case["count_a"].numpy()
    B, R = count.shape
    sem = np.zeros((B, h, w), np.int32)
    col = np.zeros((B, 3, h, w), F32)
    depth = np.full((B, h, w), F32(FAR))
    px = (np.arange(w, dtype=F32) + F32(0.5))[None, :]
    with np.errstate(all="ignore"):
        for b in range(B):
            for r in range(R):
                py = ((F32(r * rows) + np.arange(rows, dtype=F32)) + F32(0.5))[:, None]
                zbuf = np.full((rows, w), F32(FAR))
                s = np.zeros((rows, w), np.int32)
                cc = np.zeros((3, rows, w), F32)
                for p in range(count[b, r]):
                    c = tbl[b, :, idx[b, r, p]]
                    e0 = c[0] * px + c[1] * py + c[2]
                    e1 = c[3] * px + c[4] * py + c[5]
                    e2 = c[6] * px + c[7] * py + c[8]
                    inside = (((e0 > 0) & (e1 > 0) & (e2 > 0))
                              | ((e0 < 0) & (e1 < 0) & (e2 < 0)))
                    den = e0 + e1 + e2
                    den = np.where(den == 0, F32(1e-9), den)
                    z = (c[9] * px + c[10] * py + c[11]) / den
                    ok = inside & (z > F32(NEAR)) & (z < zbuf)
                    zbuf = np.where(ok, z, zbuf)
                    s = np.where(ok, np.int32(c[15]), s)
                    fac = F32(1.0)
                    if textured and ok.any():
                        u = (c[17] * px + c[18] * py + c[19]) / den
                        v = (c[20] * px + c[21] * py + c[22]) / den
                        fac = _texture(u, v, int(c[15]))
                    for ch in range(3):
                        cc[ch] = np.where(ok, c[12 + ch] * fac, cc[ch])
                band = slice(r * rows, (r + 1) * rows)
                sem[b, band], col[b, :, band], depth[b, band] = s, cc, zbuf
    return sem, col, depth


def _walk_fast(frame: str):
    """Kernel B's function: the pair walk of the packed-key running min and
    its epilogue → gray (B, H, W)."""
    case = _cases()[frame]
    h, w, rows = case["height"], case["width"], case["rows"]
    tbl, idx, count = case["fast"].numpy(), case["idx_b"].numpy(), case["count_b"].numpy()
    B, R, K = idx.shape
    far_key = np.int32(p_fast.pack_key_const(FAR))
    gray = np.zeros((B, h, w), F32)
    px = (np.arange(w, dtype=F32) + F32(0.5))[None, :]
    with np.errstate(all="ignore"):
        for b in range(B):
            for r in range(R):
                py = (np.arange(rows, dtype=F32) + (F32(r * rows) + F32(0.5)))[:, None]
                kmin = np.full((rows, w), p_fast.MISS_KEY, np.int32)
                n_pass = min((count[b, r] + 1) // 2 * 2, K)
                for p in range(n_pass):
                    c = tbl[b, :, idx[b, r, p]]
                    e0 = c[0] * px + (c[1] * py + c[2])
                    e1 = c[3] * px + (c[4] * py + c[5])
                    e2 = c[6] * px + (c[7] * py + c[8])
                    zn = c[9] * px + (c[10] * py + c[11])
                    inside = np.minimum(np.minimum(e0, e1), e2) > 0
                    z = zn * (F32(1.0) / (e0 + e1 + e2))
                    key = (z.view(np.int32) & np.int32(p_fast.KEY_MASK)) | np.int32(c[12])
                    kmin = np.minimum(kmin, np.where(inside & (z > F32(NEAR)), key,
                                                     np.int32(p_fast.MISS_KEY)))
                z = (kmin & np.int32(p_fast.KEY_MASK)).view(F32)
                lum = (kmin & np.int32(p_fast.LUMA_MASK)).astype(F32) * F32(1.0 / p_fast.LUMA_MASK)
                shade = F32(1.0) / (F32(1.0) + F32(0.004) * z)
                t = (py - F32(0.5)) * F32(1.0 / max(h - 1, 1))
                sky = F32(p_fast.SKY_TOP_L) * (F32(1.0) - t) + F32(p_fast.SKY_HOR_L) * t
                gray[b, r * rows:(r + 1) * rows] = np.where(kmin < far_key, lum * shade, sky)
    return gray


def test_cases_cover_what_they_claim():
    for frame, case in _cases().items():
        count_a, count_b = case["count_a"].numpy(), case["count_b"].numpy()
        assert count_a[0, 0] > 2 * 128, frame                    # longer than two chunks
        assert (count_a == 0).any(), frame                       # an empty band
        assert (count_b % 2 == 1).any(), frame                   # odd counts
        assert case["rows"] in (32, 24, 20) and case["height"] % case["rows"] == 0
    assert {c["rows"] for c in _cases().values()} == {32, 24, 20}
    assert max(c["width"] for c in _cases().values()) > 128     # two column segments


@pytest.mark.parametrize("n_ch", [1, 3])
@pytest.mark.parametrize("textured", [False, True])
@pytest.mark.parametrize("frame", FRAMES)
def test_exact_plain_matches_walk(frame, textured, n_ch):
    case = _cases()[frame]
    tbl = case["tex"] if textured else case["tex"][:, :p_raster.PACK_WIDTH].contiguous()
    sem, col, depth = p_raster.raster_bands_plain(
        tbl, case["idx_a"], case["count_a"], case["height"], case["width"], NEAR, FAR,
        n_ch, case["rows"])
    w_sem, w_col, w_depth = _walk_exact(frame, textured)
    np.testing.assert_array_equal(sem.numpy(), w_sem)
    np.testing.assert_array_equal(depth.numpy(), w_depth)
    np.testing.assert_array_equal(col.numpy(), w_col[:, :n_ch])
    assert (w_depth < FAR).mean() > 0.5


@pytest.mark.parametrize("frame", FRAMES)
def test_fast_plain_matches_walk(frame):
    case = _cases()[frame]
    gray = p_fast.fast_bands_plain(case["fast"], case["idx_b"], case["count_b"],
                                   case["height"], case["width"], NEAR, FAR, 0.0, case["rows"])
    np.testing.assert_array_equal(gray.numpy(), _walk_fast(frame))


@pytest.mark.parametrize("kernel", ["A", "B"])
@pytest.mark.parametrize("frame", FRAMES)
def test_warp_tile_cull_is_exact(frame, kernel):
    case = _cases()[frame]
    h, w, rows = case["height"], case["width"], case["rows"]
    exact = kernel == "A"
    tbl = case["tex"] if exact else case["fast"]
    idx = case["idx_a"] if exact else case["idx_b"]
    count = case["count_a"] if exact else case["count_b"]
    culled = kept = 0
    for x0, x1, y0, y1, keep, live in chip_smoke.warp_tile_keep(tbl, idx, count, w, rows, exact):
        for b in range(idx.shape[0]):
            for r in range(idx.shape[1]):
                gone = (live[b, r] & ~keep[b, r]).numpy()
                co = tbl[b][:, idx[b, r]].numpy()[:, gone]              # (rows, culled)
                # every pixel of the tile, with the pass's expression
                px = (np.arange(x0, x1 + 1, dtype=F32) + F32(0.5))[None, None, :]
                if exact:
                    py = ((F32(r * rows) + np.arange(y0, y1 + 1, dtype=F32)) + F32(0.5))[None, :, None]
                    e = [(co[3 * i, :, None, None] * px + co[3 * i + 1, :, None, None] * py)
                         + co[3 * i + 2, :, None, None] for i in range(3)]
                else:
                    py = (np.arange(y0, y1 + 1, dtype=F32) + (F32(r * rows) + F32(0.5)))[None, :, None]
                    e = [co[3 * i, :, None, None] * px
                         + (co[3 * i + 1, :, None, None] * py + co[3 * i + 2, :, None, None])
                         for i in range(3)]
                inside = (e[0] > 0) & (e[1] > 0) & (e[2] > 0)
                if exact:
                    inside |= (e[0] < 0) & (e[1] < 0) & (e[2] < 0)
                assert not inside.any(), (frame, kernel, b, r, x0, y0)
                culled += int(gone.sum())
                kept += int((live[b, r] & keep[b, r]).sum())
    assert culled > kept / 10, (culled, kept)


def test_quad_cull_is_exact():
    """The same corner test on kernel C's 4-edge primitives, which the
    bounds of ``chip_smoke.py`` count C's work with: on a small rich fleet,
    every quad dropped from a tile has no pixel of the tile inside."""
    from carla_imitation_learning_tpu_torch.render.pipeline import make_scene_setup
    from carla_imitation_learning_tpu_torch.sim.world import reset_env

    params, town = chip_smoke.bench_fleet("cpu")
    rcfg = chip_smoke.rich_config(rgb=False, fast=True, quads=True)
    states = reset_env(params, town, torch.Generator().manual_seed(0), N_ENVS)
    prims = p_fast.fuse_prims(make_scene_setup(params, town, rcfg, device="cpu")(states))
    hw, rows = chip_smoke.HW, p_raster.band_rows(chip_smoke.HW)
    tbl = p_fast.pack_setup_prims(prims)
    idx, count = p_fast.tile_lists_fast(prims, hw, chip_smoke.T_RICH, width=hw, lod_px=2.0,
                                        rows_per_band=rows)
    culled = kept = 0
    for x0, x1, y0, y1, keep, live in chip_smoke.warp_tile_keep(tbl, idx, count, hw, rows,
                                                                exact=False, edges=4):
        px = (np.arange(x0, x1 + 1, dtype=F32) + F32(0.5))[None, None, :]
        for b in range(idx.shape[0]):
            for r in range(idx.shape[1]):
                gone = (live[b, r] & ~keep[b, r]).numpy()
                co = tbl[b][:, idx[b, r]].numpy()[:, gone]
                py = (np.arange(y0, y1 + 1, dtype=F32) + (F32(r * rows) + F32(0.5)))[None, :, None]
                inside = np.ones((co.shape[1], y1 - y0 + 1, x1 - x0 + 1), bool)
                for i in range(4):
                    inside &= (co[3 * i, :, None, None] * px
                               + (co[3 * i + 1, :, None, None] * py + co[3 * i + 2, :, None, None])) > 0
                assert not inside.any(), (b, r, x0, y0)
                culled += int(gone.sum())
                kept += int((live[b, r] & keep[b, r]).sum())
    assert culled > kept, (culled, kept)
