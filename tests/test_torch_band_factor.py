"""Coarse shared band lists (``list_band_factor``) in the port's kernels B,
C and D — their plain versions, the path CPU tensors take — vs the JAX
package.

Tolerances:
- ``tile_lists_fast`` at factor 2, triangles and fused quads, capped and
  not: equal to JAX's lists built over bands of 2 · tile_rows rows;
- B, C and D at factor 2 vs their own factor-1 frame: equal (a coarse list
  is a superset of each of its bands' lists, and the min/max key does not
  depend on the order), as tests/test_raster_fast.py holds JAX;
- B at factor 2 vs ``rasterize_luma_fast(interpret=True,
  list_band_factor=2)``: the fast raster's tolerance
  (tests/test_raster_fast.py: mean|d| < 2e-3, < 1 % of pixels off by more
  than 2/255);
- C with the JAX test's option set that holds ``list_band_factor=2``
  (tests/test_raster_fast.py ``test_quad_path_with_cap_fog_lod``): vs JAX's
  quad kernel at the fast raster's tolerance, vs kernel B at that test's
  (mean|d| < 2e-3, < 2 % off by > 2/255);
- D with the option set of tests/test_vec_kernel.py
  ``test_vec_path_with_cap_fog_lod_bandfactor``: equal to kernel B (the
  port's B and D share one epilogue, so the fog blend is equal too), and
  vs JAX's vec kernel with the exact reciprocal at the fast raster's
  tolerance and max|d| < 1e-4 (see tests/test_torch_raster_quad_vec.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from carla_imitation_learning_tpu.ops import raster_fast as j_fast
from carla_imitation_learning_tpu.render import geometry as j_geo
from carla_imitation_learning_tpu.render.camera import camera_from_ego, project_triangles
from carla_imitation_learning_tpu.sim import SimParams, make_town
from carla_imitation_learning_tpu.sim import agents as j_agents
from carla_imitation_learning_tpu.sim.world import reset_env
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch.ops import raster as p_raster
from carla_imitation_learning_tpu_torch.ops import raster_fast as p_fast

H = W = 64
T = 256
TOWN = make_town(blocks=2, n_buildings=6, n_lights=2)
PARAMS = SimParams(n_agents=3)
STATIC = j_geo.build_static_scene(TOWN)
CAP_FOG_LOD = {"compact_cap": 96, "fog_density": 0.01, "lod_px": 1.0}


def _setup(seed):
    st = reset_env(PARAMS, TOWN, jax.random.PRNGKey(seed))
    phases = j_agents.light_phases(TOWN, st.t.astype(jnp.float32) * PARAMS.dt,
                                   PARAMS.light_green, PARAMS.light_yellow,
                                   PARAMS.light_red)
    ap, ay = j_agents.agent_positions(TOWN, st.agents_route, st.agents_s)
    tris, colors, classes = j_geo.assemble_scene(STATIC, TOWN.lights_pos, phases,
                                                 ap, ay, T)
    cam = camera_from_ego(st.ego_pos, st.ego_yaw)
    return project_triangles(tris, colors, classes, cam, W, H, 90.0, 0.5)


@pytest.fixture(scope="module")
def setups():
    """JAX TriangleSetups (with pair analysis) for seeds 0-2 and the port's
    batched setup converted from them."""
    by_seed = {seed: _setup(seed) for seed in (0, 1, 2)}
    batch = convert.setup_from_jax(
        jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *by_seed.values()))
    return by_seed, batch


def _check_tolerance(got, want, what, mean=2e-3, frac=0.01):
    d = np.abs(got - want)
    assert d.mean() < mean, f"{what}: mean diff {d.mean()}"
    assert (d > 2 / 255).mean() < frac, f"{what}: {(d > 2 / 255).mean():.3%} pixels off"


@pytest.mark.parametrize("quads", [False, True])
@pytest.mark.parametrize("k,lod", [(T, 0.0), (T, 2.0), (64, 0.0)])
def test_factor2_lists_equal_jax(setups, quads, k, lod):
    by_seed, batch = setups
    rows = p_raster.band_rows(H)
    src = p_fast.fuse_prims(batch) if quads else batch
    idx, count = p_fast.tile_lists_fast(src, H, k, width=W, lod_px=lod,
                                        rows_per_band=rows, list_band_factor=2)
    assert idx.shape == (3, H // (2 * rows), k)
    for b, setup in enumerate(by_seed.values()):
        j_src = j_fast.fuse_prims(setup) if quads else setup
        j_idx, j_count = j_fast.tile_lists_fast(j_src, H, k, width=W, lod_px=lod,
                                                rows_per_band=2 * rows)
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(j_idx))
        np.testing.assert_array_equal(count[b].numpy(), np.asarray(j_count)[:, 0])


def test_coarse_list_is_superset(setups):
    """List row q of factor 2 holds every entry of bands 2q and 2q+1."""
    batch = setups[1]
    rows = p_raster.band_rows(H)
    idx1, c1 = p_fast.tile_lists_fast(batch, H, T, width=W, rows_per_band=rows)
    idx2, c2 = p_fast.tile_lists_fast(batch, H, T, width=W, rows_per_band=rows,
                                      list_band_factor=2)
    for b in range(idx1.shape[0]):
        for r in range(idx1.shape[1]):
            fine = set(idx1[b, r, :int(c1[b, r])].tolist())
            coarse = set(idx2[b, r // 2, :int(c2[b, r // 2])].tolist())
            assert fine <= coarse, (b, r)
    assert (c2 >= c1.view(3, -1, 2).amax(-1)).all()


@pytest.mark.parametrize("kw", [{}, {"lod_px": 1.0}, {"fog_density": 0.02}])
def test_fast_factor2_identical_and_matches_jax(setups, kw):
    by_seed, batch = setups
    g1 = p_fast.rasterize_luma_fast(batch, H, W, **kw)
    g2 = p_fast.rasterize_luma_fast(batch, H, W, list_band_factor=2, **kw)
    assert torch.equal(g1, g2)
    for b, (seed, setup) in enumerate(by_seed.items()):
        want = np.asarray(j_fast.rasterize_luma_fast(setup, H, W, interpret=True,
                                                     list_band_factor=2, **kw))
        _check_tolerance(g2[b].numpy(), want, f"seed {seed} {kw}")


@pytest.mark.parametrize("variant", ["quads", "vec"])
def test_factor2_identical_to_factor1(setups, variant):
    batch = setups[1]
    kw = {variant: True}
    g1 = p_fast.rasterize_luma_fast(batch, H, W, **kw)
    g2 = p_fast.rasterize_luma_fast(batch, H, W, list_band_factor=2, **kw)
    assert torch.equal(g1, g2)


def test_quad_cap_fog_lod_factor2(setups):
    by_seed, batch = setups
    kw = dict(CAP_FOG_LOD, list_band_factor=2)
    got = p_fast.rasterize_luma_fast(batch, H, W, quads=True, **kw).numpy()
    tri = p_fast.rasterize_luma_fast(batch, H, W, **kw).numpy()
    for b, (seed, setup) in enumerate(by_seed.items()):
        want = np.asarray(j_fast.rasterize_luma_fast(setup, H, W, interpret=True,
                                                     quads=True, **kw))
        _check_tolerance(got[b], want, f"seed {seed} vs JAX")
        _check_tolerance(got[b], tri[b], f"seed {seed} vs kernel B", frac=0.02)


def test_vec_cap_fog_lod_factor2(setups):
    by_seed, batch = setups
    kw = dict(CAP_FOG_LOD, list_band_factor=2)
    got = p_fast.rasterize_luma_fast(batch, H, W, vec=True, **kw)
    assert torch.equal(got, p_fast.rasterize_luma_fast(batch, H, W, **kw))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "reciprocal", lambda x, approx=False: 1.0 / x)
        jax.clear_caches()
        want = [np.asarray(j_fast.rasterize_luma_fast(setup, H, W, interpret=True,
                                                      quads=False, vec=True, **kw))
                for setup in by_seed.values()]
    jax.clear_caches()
    for b, seed in enumerate(by_seed):
        _check_tolerance(got[b].numpy(), want[b], f"seed {seed}")
        assert np.abs(got[b].numpy() - want[b]).max() < 1e-4


@pytest.mark.parametrize("bands", ["fast", "prim", "vec"])
def test_band_layout_refused(setups, bands):
    """A list row count that does not tile the image at the factor raises."""
    batch = setups[1]
    rows = p_raster.band_rows(H)
    tbl = p_fast.pack_setup_fast(batch)
    idx, count = p_fast.tile_lists_fast(batch, H, T, width=W, rows_per_band=rows)
    with pytest.raises(ValueError, match="band layout"):
        if bands == "vec":
            p_fast.vec_bands(p_fast.gather_band_tables(tbl, idx), count, H, W, 0.5,
                             300.0, 0.0, rows, 2)
        else:
            fn = p_fast.fast_bands if bands == "fast" else p_fast.prim_bands
            fn(tbl, idx, count, H, W, 0.5, 300.0, 0.0, rows, 2)
