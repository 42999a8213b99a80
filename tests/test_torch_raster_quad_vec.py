"""PyTorch port of the fast raster's quad (kernel C) and vec (kernel D)
paths — their plain versions, the path CPU tensors take — vs the JAX
package, on the rich scene (facade bands, markings, shadows; T = 256).

Tolerances:
- ``fuse_prims``, ``compact_prims``, ``pack_setup_prims`` and the quad band
  lists: equal, on the converted JAX setup;
- C vs ``rasterize_luma_fast(interpret=True, quads=True)``: the fast
  raster's tolerance (mean|d| < 2e-3, < 1 % of pixels off by more than
  2/255); C vs kernel B's plain version: the JAX quad contract
  (tests/test_raster_fast.py: mean|d| < 1e-3, < 0.5 % off by > 2/255)
  where no cap applies (a cap of n primitives keeps more of the scene than
  a cap of n triangles);
- D vs kernel B's plain version: equal (``torch.equal``);
- D vs ``rasterize_luma_fast(interpret=True, vec=True)``: the fast raster's
  tolerance, with JAX's approximate reciprocal replaced by the exact one
  the port takes. In interpret mode JAX computes it through bfloat16, which
  makes the shadows (1 cm above the road) and the markings (4 mm above it)
  z-fight with the road on a few per cent of pixels; with the exact
  reciprocal the two agree to about 1e-5.
"""

import dataclasses

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
STATIC = j_geo.build_static_scene(TOWN, facade_bands=3, markings=True)
OPTIONS = [{}, {"lod_px": 2.0}, {"max_tris_per_tile": 64}, {"compact_cap": 96},
           {"fog_density": 0.02}]


def _setup(seed):
    st = reset_env(PARAMS, TOWN, jax.random.PRNGKey(seed))
    phases = j_agents.light_phases(TOWN, st.t.astype(jnp.float32) * PARAMS.dt,
                                   PARAMS.light_green, PARAMS.light_yellow,
                                   PARAMS.light_red)
    ap, ay = j_agents.agent_positions(TOWN, st.agents_route, st.agents_s)
    tris, colors, classes = j_geo.assemble_scene(STATIC, TOWN.lights_pos, phases,
                                                 ap, ay, T, shadows=True)
    cam = camera_from_ego(st.ego_pos, st.ego_yaw)
    cullable = ((classes == j_geo.SEM_BUILDING) | (classes == j_geo.SEM_VEHICLE))
    return project_triangles(tris, colors, classes, cam, W, H, 90.0, 0.5,
                             cullable=cullable)


@pytest.fixture(scope="module")
def setups():
    """JAX TriangleSetups (with pair analysis) for seeds 0-2 and the port's
    batched setup converted from them."""
    by_seed = {seed: _setup(seed) for seed in (0, 1, 2)}
    batch = convert.setup_from_jax(
        jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *by_seed.values()))
    return by_seed, batch


def _check_b_tolerance(got, want, what, mean=2e-3, frac=0.01):
    d = np.abs(got - want)
    assert d.mean() < mean, f"{what}: mean diff {d.mean()}"
    assert (d > 2 / 255).mean() < frac, f"{what}: {(d > 2 / 255).mean():.3%} pixels off"


def test_fuse_and_pack_prims_equal(setups):
    by_seed, batch = setups
    prims = p_fast.fuse_prims(batch)
    tbl = p_fast.pack_setup_prims(prims)
    assert tbl.shape == (3, p_fast.PRIM_PACK_WIDTH, T) and tbl.is_contiguous()
    compact = p_fast.compact_prims(prims, 96)
    for b, setup in enumerate(by_seed.values()):
        j_prims = j_fast.fuse_prims(setup)
        want = convert.prims_from_jax(j_prims)
        for f in dataclasses.fields(p_fast.PrimSetup):
            assert torch.equal(getattr(prims, f.name)[b], getattr(want, f.name)[0]), f.name
        np.testing.assert_array_equal(tbl[b].numpy(), np.asarray(j_fast.pack_setup_prims(j_prims)))
        want_c = convert.prims_from_jax(j_fast.compact_prims(j_prims, 96))
        for f in dataclasses.fields(p_fast.PrimSetup):
            assert torch.equal(getattr(compact, f.name)[b], getattr(want_c, f.name)[0]), f.name
    # a fused quad covers its pair: fewer list entries than triangles
    assert prims.valid.sum() < batch.valid.sum()


def test_quad_band_lists_equal(setups):
    """tile_lists_fast corner-culls a PrimSetup over its four edge rows, as
    the JAX function does."""
    by_seed, batch = setups
    prims = p_fast.fuse_prims(batch)
    for k, lod in ((T, 0.0), (T, 2.0), (64, 0.0)):
        idx, count = p_fast.tile_lists_fast(prims, H, k, width=W, lod_px=lod)
        for b, setup in enumerate(by_seed.values()):
            j_idx, j_count = j_fast.tile_lists_fast(j_fast.fuse_prims(setup), H, k,
                                                    width=W, lod_px=lod)
            np.testing.assert_array_equal(idx[b].numpy(), np.asarray(j_idx))
            np.testing.assert_array_equal(count[b].numpy(), np.asarray(j_count)[:, 0])


@pytest.mark.parametrize("kw", OPTIONS)
def test_quad_matches_jax_interpret(setups, kw):
    by_seed, batch = setups
    got = p_fast.rasterize_luma_fast(batch, H, W, quads=True, **kw).numpy()
    tri = p_fast.rasterize_luma_fast(batch, H, W, **kw).numpy()
    for b, (seed, setup) in enumerate(by_seed.items()):
        want = np.asarray(j_fast.rasterize_luma_fast(setup, H, W, interpret=True,
                                                     quads=True, **kw))
        _check_b_tolerance(got[b], want, f"seed {seed} {kw} vs JAX")
        if not {"max_tris_per_tile", "compact_cap"} & set(kw):
            _check_b_tolerance(got[b], tri[b], f"seed {seed} {kw} vs kernel B",
                               mean=1e-3, frac=0.005)


def test_quad_needs_pair_analysis(setups):
    batch = dataclasses.replace(setups[1], pair_ok=None)
    with pytest.raises(ValueError, match="quads=True"):
        p_fast.rasterize_luma_fast(batch, H, W, quads=True)


def test_prim_bands_walk_pairs_and_order_free(setups):
    """Kernel C's plain version walks list entries up to the count rounded
    up to two, and the running max makes the list order irrelevant."""
    batch = setups[1]
    prims = p_fast.fuse_prims(batch)
    tbl = p_fast.pack_setup_prims(prims)
    idx, count = p_fast.tile_lists_fast(prims, H, T, width=W)
    rows = p_raster.band_rows(H)
    out = p_fast.prim_bands(tbl, idx, count, H, W, 0.5, 300.0, 0.0, rows)
    flipped = idx.clone()
    for b in range(idx.shape[0]):
        for r in range(idx.shape[1]):
            n = int(count[b, r])
            flipped[b, r, :n] = idx[b, r, :n].flip(0)
    assert torch.equal(out, p_fast.prim_bands(tbl, flipped, count, H, W, 0.5, 300.0, 0.0, rows))
    sky = p_fast.prim_bands(tbl, idx, torch.zeros_like(count), H, W, 0.5, 300.0, 0.0, rows)
    want = p_fast.fast_bands(p_fast.pack_setup_fast(batch), idx, torch.zeros_like(count),
                             H, W, 0.5, 300.0, 0.0, rows)
    assert torch.equal(sky, want)
    assert p_fast.prim_far_key(300.0) == (int(np.float32(1 / 300.0).view(np.int32)) & ~0xFFF) | 0xFFF


@pytest.mark.parametrize("kw", OPTIONS)
def test_vec_equals_fast_kernel(setups, kw):
    batch = setups[1]
    tri = p_fast.rasterize_luma_fast(batch, H, W, **kw)
    vec = p_fast.rasterize_luma_fast(batch, H, W, vec=True, **kw)
    assert torch.equal(vec, tri)


def test_vec_empty_scene_is_sky(setups):
    batch = setups[1]
    empty = dataclasses.replace(batch, valid=torch.zeros_like(batch.valid))
    g = p_fast.rasterize_luma_fast(empty, H, W, vec=True)
    assert torch.equal(g, p_fast.rasterize_luma_fast(empty, H, W))
    assert torch.equal(g, g[..., :1].expand_as(g))
    assert (g[:, 0, 0] - g[:, -1, 0]).abs().min() > 1e-3


def test_band_tables_layout(setups):
    batch = setups[1]
    tbl = p_fast.pack_setup_fast(batch)
    idx, _ = p_fast.tile_lists_fast(batch, H, T, width=W)
    btbl = p_fast.gather_band_tables(tbl, idx)
    assert btbl.shape == idx.shape + (p_fast.VEC_ROW,) and btbl.is_contiguous()
    want = np.asarray(j_fast.gather_band_tables(jnp.asarray(tbl[2].numpy()),
                                                jnp.asarray(idx[2].numpy())))
    np.testing.assert_array_equal(btbl[2].numpy(), want)


@pytest.mark.parametrize("kw", [{}, {"max_tris_per_tile": 60}, {"fog_density": 0.02}])
def test_vec_matches_jax_interpret_exact_reciprocal(setups, kw):
    by_seed, batch = setups
    got = p_fast.rasterize_luma_fast(batch, H, W, vec=True, **kw).numpy()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "reciprocal", lambda x, approx=False: 1.0 / x)
        jax.clear_caches()
        want = [np.asarray(j_fast.rasterize_luma_fast(setup, H, W, interpret=True,
                                                      quads=False, vec=True, **kw))
                for setup in by_seed.values()]
    jax.clear_caches()
    for b, seed in enumerate(by_seed):
        _check_b_tolerance(got[b], want[b], f"seed {seed} {kw}")
        assert np.abs(got[b] - want[b]).max() < 1e-4
