"""The yardsticks of kernels A to D on their edge cases, on the CPU.

On the card, ``chip_smoke.py`` holds kernel A (``raster_bands``), B
(``fast_bands``), C (``prim_bands``) and D (``vec_bands``) bit for bit
against their plain PyTorch versions on the synthetic band tables of
``chip_smoke.edge_case_tables``: edges through pixel centres and warp-tile
corners, slivers, both windings, den = 0, equal-z duplicates, lists longer
than two staging chunks, empty bands, odd counts followed by a covering
sub-LOD triangle (in D's walked tail of its group of 8), C's quads with
corners on tile corners and pixel centres and 1/z exactly at 1/near, and
bands of 32, 24 and 20 rows. Here the plain versions themselves are held,
on the same tables at a small size, against a straightforward numpy walk of
each list one entry at a time, as the TPU kernels walk it
(``ops/raster.py:172-176`` of the JAX package; the pair walk of
``ops/raster_fast.py:444-452`` for B and C, the groups of 8 of
``ops/raster_fast.py:356-397`` for D), with the plain versions' float32
expression order. Tolerance: none — semantic planes, colours, depths and
gray frames must be equal.

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
has no pixel of the tile inside, over the positions each kernel walks (D's
lists rounded up to whole groups of 8); and the same for kernel C's 4-edge
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
    """Kernel B's pass: the pair walk of the packed-key running min → keys
    (B, H, W) int32."""
    case = _cases()[frame]
    h, w, rows = case["height"], case["width"], case["rows"]
    tbl, idx, count = case["fast"].numpy(), case["idx_b"].numpy(), case["count_b"].numpy()
    B, R, K = idx.shape
    keys = np.zeros((B, h, w), np.int32)
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
                keys[b, r * rows:(r + 1) * rows] = kmin
    return keys


def _luma_gray(keys, h: int, fog: float, prim: bool):
    """Kernel B's and D's epilogue on running-min keys, or kernel C's
    (``prim``) on running-max 1/z keys, over whole frames → gray (B, H, W).
    The fog factor is taken with torch's ``exp`` on the whole frame, laid
    out as the plain versions lay it out, so that each element takes the
    same vectorized path."""
    with np.errstate(all="ignore"):
        zw = (keys & np.int32(p_fast.KEY_MASK)).view(F32)
        if prim:
            hit = keys > np.int32(p_fast.prim_far_key(FAR))
            shade = zw * (F32(1.0) / (zw + F32(0.004)))
            depth = F32(1.0) / np.maximum(zw, F32(1e-9))
        else:
            hit = keys < np.int32(p_fast.pack_key_const(FAR))
            shade = F32(1.0) / (F32(1.0) + F32(0.004) * zw)
            depth = zw
        lum = (keys & np.int32(p_fast.LUMA_MASK)).astype(F32) * F32(1.0 / p_fast.LUMA_MASK)
        py = (np.arange(h, dtype=F32) + F32(0.5))[:, None]
        t = (py - F32(0.5)) * F32(1.0 / max(h - 1, 1))
        sky = F32(p_fast.SKY_TOP_L) * (F32(1.0) - t) + F32(p_fast.SKY_HOR_L) * t
        lit = lum * shade
        if fog > 0.0:
            f = torch.exp(torch.from_numpy(np.ascontiguousarray(F32(-fog) * depth))).numpy()
            lit = lit * f + sky * (F32(1.0) - f)
        return np.where(hit, lit, sky)


def _walk_prim(frame: str):
    """Kernel C's pass: the pair walk of the packed 1/z key's running max
    over four borders → keys (B, H, W) int32."""
    case = _cases()[frame]
    h, w, rows = case["height"], case["width"], case["rows"]
    tbl, idx, count = case["prim"].numpy(), case["idx_c"].numpy(), case["count_c"].numpy()
    B, R, K = idx.shape
    inv_near = F32(1.0 / NEAR)
    keys = np.zeros((B, h, w), np.int32)
    px = (np.arange(w, dtype=F32) + F32(0.5))[None, :]
    with np.errstate(all="ignore"):
        for b in range(B):
            for r in range(R):
                py = (np.arange(rows, dtype=F32) + (F32(r * rows) + F32(0.5)))[:, None]
                kmax = np.zeros((rows, w), np.int32)
                for p in range(min((count[b, r] + 1) // 2 * 2, K)):
                    c = tbl[b, :, idx[b, r, p]]
                    ok = np.ones((rows, w), bool)
                    for i in range(4):
                        ok &= c[3 * i] * px + (c[3 * i + 1] * py + c[3 * i + 2]) > 0
                    zi = c[12] * px + (c[13] * py + c[14])
                    key = (zi.view(np.int32) & np.int32(p_fast.KEY_MASK)) | np.int32(c[15])
                    kmax = np.maximum(kmax, np.where(ok & (zi < inv_near), key, np.int32(0)))
                keys[b, r * rows:(r + 1) * rows] = kmax
    return keys


def _walk_vec(frame: str):
    """Kernel D's pass: B's pass over the band's gathered table in groups of
    8 list positions (a group's min, then the running min) → keys (B, H, W)
    int32."""
    case = _cases()[frame]
    h, w, rows = case["height"], case["width"], case["rows"]
    btbl = p_fast.gather_band_tables(case["fast"], case["idx_d"]).numpy()
    count = case["count_d"].numpy()
    B, R, K, _ = btbl.shape
    keys = np.zeros((B, h, w), np.int32)
    px = (np.arange(w, dtype=F32) + F32(0.5))[None, :]
    miss = np.int32(p_fast.MISS_KEY)
    with np.errstate(all="ignore"):
        for b in range(B):
            for r in range(R):
                py = (np.arange(rows, dtype=F32) + (F32(r * rows) + F32(0.5)))[:, None]
                kmin = np.full((rows, w), miss, np.int32)
                for g in range(0, min((count[b, r] + 7) // 8 * 8, K), p_fast.VEC_P):
                    gmin = np.full((rows, w), miss, np.int32)
                    for c in btbl[b, r, g:g + p_fast.VEC_P]:
                        e0 = c[0] * px + (c[1] * py + c[2])
                        e1 = c[3] * px + (c[4] * py + c[5])
                        e2 = c[6] * px + (c[7] * py + c[8])
                        zn = c[9] * px + (c[10] * py + c[11])
                        inside = (e0 > 0) & (e1 > 0) & (e2 > 0)
                        z = zn * (F32(1.0) / (e0 + e1 + e2))
                        key = (z.view(np.int32) & np.int32(p_fast.KEY_MASK)) | np.int32(c[12])
                        gmin = np.minimum(gmin, np.where(inside & (z > F32(NEAR)), key, miss))
                    kmin = np.minimum(kmin, gmin)
                keys[b, r * rows:(r + 1) * rows] = kmin
    return keys


def test_cases_cover_what_they_claim():
    for frame, case in _cases().items():
        count_a, count_b = case["count_a"].numpy(), case["count_b"].numpy()
        assert count_a[0, 0] > 2 * 128, frame                    # longer than two chunks
        assert (count_a == 0).any(), frame                       # an empty band
        assert (count_b % 2 == 1).any(), frame                   # odd counts
        assert case["rows"] in (32, 24, 20) and case["height"] % case["rows"] == 0
    assert {c["rows"] for c in _cases().values()} == {32, 24, 20}
    assert max(c["width"] for c in _cases().values()) > 128     # two column segments


def test_prim_and_vec_cases_cover_what_they_claim():
    """Kernel D's lists end within a group of 8 with the covering sub-LOD
    entry in the walked tail; kernel C's lists hold quads, strips with 1/z
    at 1/near, a strip whose top border is NaN inside a warp tile that its
    corner test keeps, an empty band and lists longer than two chunks."""
    tail_lit = 0
    for frame, case in _cases().items():
        count_d, count_c = case["count_d"].numpy(), case["count_c"].numpy()
        idx_d, prim = case["idx_d"].numpy(), case["prim"].numpy()
        assert idx_d.shape[2] % p_fast.VEC_P == 0
        assert (count_d % p_fast.VEC_P != 0).any(), frame
        assert count_c[0, 0] > 2 * 128 and (count_c == 0).any(), frame
        assert (count_c % 2 == 1).any(), frame
        listed = case["idx_c"].numpy()[0, 0, :count_c[0, 0]]
        zi_c = prim[0, 14, listed]
        assert (zi_c == np.float32(1.0 / NEAR)).sum() == 2, frame      # both strips listed
        assert (prim[0, 9:12, listed] != prim[0, 0:3, listed]).any(), frame   # quads listed
        over = listed[np.abs(prim[0, 0, listed]) > 1e38]
        assert len(over) == 1, frame
        a, b, c = prim[0, 0:3, over[0]]
        with np.errstate(over="ignore", invalid="ignore"):
            assert np.isnan(a * F32(1.5) + (b * F32(1.5) + c)), frame    # NaN at pixel (1, 1)
            assert a * F32(15.5) + (b * F32(0.5) + c) > 0, frame         # tile (0, 0) keeps it
        # D walks up to 7 positions past the count, B at most one: the
        # covering entry there lights pixels in D's frame only
        args = (case["height"], case["width"], NEAR, FAR, 0.0, case["rows"])
        gray_b = p_fast.fast_bands_plain(case["fast"], case["idx_d"], case["count_d"], *args)
        gray_d = p_fast.vec_bands_plain(p_fast.gather_band_tables(case["fast"], case["idx_d"]),
                                        case["count_d"], *args)
        tail_lit += int((gray_b != gray_d).sum())
    assert tail_lit > 0


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
    np.testing.assert_array_equal(gray.numpy(), _luma_gray(_walk_fast(frame), case["height"],
                                                           0.0, prim=False))


@pytest.mark.parametrize("kernel", ["A", "B", "C", "D"])
@pytest.mark.parametrize("frame", FRAMES)
@np.errstate(over="ignore", invalid="ignore")   # kernel C's overflowing strip
def test_warp_tile_cull_is_exact(frame, kernel):
    case = _cases()[frame]
    h, w, rows = case["height"], case["width"], case["rows"]
    exact = kernel == "A"
    tbl, idx, count = {"A": ("tex", "idx_a", "count_a"), "B": ("fast", "idx_b", "count_b"),
                       "C": ("prim", "idx_c", "count_c"),
                       "D": ("fast", "idx_d", "count_d")}[kernel]
    tbl, idx, count = case[tbl], case[idx], case[count]
    edges = 4 if kernel == "C" else 3
    group = p_fast.VEC_P if kernel == "D" else 2
    culled = kept = 0
    for x0, x1, y0, y1, keep, live in chip_smoke.warp_tile_keep(tbl, idx, count, w, rows, exact,
                                                                edges=edges, group=group):
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
                         for i in range(edges)]
                inside = np.logical_and.reduce([ei > 0 for ei in e])
                if exact:
                    inside |= (e[0] < 0) & (e[1] < 0) & (e[2] < 0)
                assert not inside.any(), (frame, kernel, b, r, x0, y0)
                culled += int(gone.sum())
                kept += int((live[b, r] & keep[b, r]).sum())
    assert culled > kept / 10, (culled, kept)


@pytest.mark.parametrize("frame", FRAMES)
def test_prim_plain_matches_walk(frame):
    case = _cases()[frame]
    gray = p_fast.prim_bands_plain(case["prim"], case["idx_c"], case["count_c"], case["height"],
                                   case["width"], NEAR, FAR, 0.0, case["rows"])
    np.testing.assert_array_equal(gray.numpy(), _luma_gray(_walk_prim(frame), case["height"],
                                                           0.0, prim=True))


@pytest.mark.parametrize("frame", FRAMES)
def test_vec_plain_matches_walk(frame):
    case = _cases()[frame]
    btbl = p_fast.gather_band_tables(case["fast"], case["idx_d"])
    gray = p_fast.vec_bands_plain(btbl, case["count_d"], case["height"], case["width"], NEAR, FAR,
                                  0.0, case["rows"])
    np.testing.assert_array_equal(gray.numpy(), _luma_gray(_walk_vec(frame), case["height"],
                                                           0.0, prim=False))


@pytest.mark.parametrize("kernel", ["B", "C", "D"])
@pytest.mark.parametrize("frame", FRAMES)
def test_band_plain_with_fog_matches_walk(frame, kernel):
    """The fog branch of kernels B, C and D's epilogues at the density the
    card's edge-case phase also runs."""
    case = _cases()[frame]
    args = (case["height"], case["width"], NEAR, FAR, chip_smoke.EDGE_FOG, case["rows"])
    if kernel == "B":
        gray = p_fast.fast_bands_plain(case["fast"], case["idx_b"], case["count_b"], *args)
        keys = _walk_fast(frame)
    elif kernel == "C":
        gray = p_fast.prim_bands_plain(case["prim"], case["idx_c"], case["count_c"], *args)
        keys = _walk_prim(frame)
    else:
        btbl = p_fast.gather_band_tables(case["fast"], case["idx_d"])
        gray = p_fast.vec_bands_plain(btbl, case["count_d"], *args)
        keys = _walk_vec(frame)
    want = _luma_gray(keys, case["height"], chip_smoke.EDGE_FOG, prim=kernel == "C")
    assert (want != _luma_gray(keys, case["height"], 0.0, prim=kernel == "C")).any()
    np.testing.assert_array_equal(gray.numpy(), want)


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
