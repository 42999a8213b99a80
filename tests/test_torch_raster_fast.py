"""PyTorch port of the fast rollout rasterizer (kernel B's module, the plain
version CPU tensors take) vs the JAX package.

Tolerance (tests/test_raster_fast.py): mean|d| < 2e-3 and < 1 % of pixels
off by more than 2/255, both against ``rasterize_luma_fast(interpret=True)``
on the same JAX ``TriangleSetup`` and against the exact luma path. The JAX
interpret path takes its approximate reciprocal through bfloat16, the port
the IEEE one, so depth keys may round differently; coverage and luma agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_imitation_learning_tpu.ops.raster import rasterize_pallas_luma
from carla_imitation_learning_tpu.ops.raster_fast import rasterize_luma_fast as j_fast
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


def _setup(seed):
    st = reset_env(PARAMS, TOWN, jax.random.PRNGKey(seed))
    phases = j_agents.light_phases(TOWN, st.t.astype(jnp.float32) * PARAMS.dt,
                                   PARAMS.light_green, PARAMS.light_yellow,
                                   PARAMS.light_red)
    ap, ay = j_agents.agent_positions(TOWN, st.agents_route, st.agents_s)
    tris, colors, classes = j_geo.assemble_scene(STATIC, TOWN.lights_pos, phases,
                                                 ap, ay, T)
    cam = camera_from_ego(st.ego_pos, st.ego_yaw)
    cullable = ((classes == j_geo.SEM_BUILDING) | (classes == j_geo.SEM_VEHICLE))
    return project_triangles(tris, colors, classes, cam, W, H, 90.0, 0.5,
                             cullable=cullable)


@pytest.fixture(scope="module")
def setups():
    """JAX TriangleSetups for seeds 0-2 and the port's batched setup."""
    by_seed = {seed: _setup(seed) for seed in (0, 1, 2)}
    batch = convert.setup_from_jax(
        jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *by_seed.values()))
    return by_seed, batch


def _check_b_tolerance(got, want, what):
    d = np.abs(got - want)
    assert d.mean() < 2e-3, f"{what}: mean diff {d.mean()}"
    assert (d > 2 / 255).mean() < 0.01, f"{what}: {(d > 2 / 255).mean():.3%} pixels off"
    return float(d.max())


@pytest.mark.parametrize("kw", [
    {}, {"lod_px": 2.0}, {"max_tris_per_tile": 64}, {"compact_cap": 96},
    {"fog_density": 0.02},
])
def test_fast_matches_jax_interpret(setups, kw):
    by_seed, batch = setups
    got = p_fast.rasterize_luma_fast(batch, H, W, **kw).numpy()
    for b, (seed, setup) in enumerate(by_seed.items()):
        want = np.asarray(j_fast(setup, H, W, interpret=True, **kw))
        worst = _check_b_tolerance(got[b], want, f"seed {seed} {kw}")
        print(f"seed {seed} {kw}: max|d| vs JAX interpret = {worst:.3e}")


def test_fast_matches_exact_luma(setups):
    by_seed, batch = setups
    got = p_fast.rasterize_luma_fast(batch, H, W).numpy()
    exact, _, _ = p_raster.rasterize_exact_luma(batch, H, W)
    for b in range(got.shape[0]):
        _check_b_tolerance(got[b], exact[b].numpy(), f"env {b}")
    # and the JAX exact kernel on the same setups
    for b, setup in enumerate(by_seed.values()):
        g_exact, _, _ = rasterize_pallas_luma(setup, H, W, interpret=True)
        _check_b_tolerance(got[b], np.asarray(g_exact), f"env {b} vs JAX exact")


def test_fast_bands_walk_pairs_and_order_free(setups):
    """The plain version walks list entries up to the count rounded up to
    the unroll width, and the packed-key min makes the list order
    irrelevant: reversing each band's live entries changes nothing."""
    batch = setups[1]
    tbl = p_fast.pack_setup_fast(batch)
    idx, count = p_fast.tile_lists_fast(batch, H, T, width=W)
    rows = p_raster.band_rows(H)
    out = p_fast.fast_bands(tbl, idx, count, H, W, 0.5, 300.0, 0.0, rows)
    flipped = idx.clone()
    for b in range(idx.shape[0]):
        for r in range(idx.shape[1]):
            n = int(count[b, r])
            flipped[b, r, :n] = idx[b, r, :n].flip(0)
    out2 = p_fast.fast_bands(tbl, flipped, count, H, W, 0.5, 300.0, 0.0, rows)
    assert torch.equal(out, out2)
    empty = p_fast.fast_bands(tbl, idx, torch.zeros_like(count), H, W, 0.5,
                              300.0, 0.0, rows)
    sky = p_fast.SKY_TOP_L * (1 - torch.arange(H) / (H - 1)) \
        + p_fast.SKY_HOR_L * (torch.arange(H) / (H - 1))
    torch.testing.assert_close(empty[0, :, 0], sky.to(torch.float32), rtol=0, atol=1e-6)


def test_packed_key_layout(setups):
    batch = setups[1]
    assert p_fast.pack_key_const(300.0) == int(np.float32(300.0).view(np.int32)) & ~0xFFF
    tbl = p_fast.pack_setup_fast(batch)
    assert tbl.shape == (3, p_fast.FAST_PACK_WIDTH, T) and tbl.is_contiguous()
    lum = tbl[:, 12]
    assert torch.equal(lum, lum.round()) and lum.min() >= 0 and lum.max() <= 4095
    assert (tbl[~batch.valid[:, None, :].expand_as(tbl)] == 0).all()
