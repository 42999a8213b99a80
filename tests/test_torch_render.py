"""PyTorch port of the renderer vs the JAX package: static scene, scene
assembly, camera setup, band lists, and the exact rasterizer's module
(kernel A's plain version, the path CPU tensors take).

Tolerances: static scene and lists equal; camera rows allclose (rtol 1e-5,
atol 1e-4) with ``valid`` equal; kernel A: semantic plane equal and
max|d| < 1e-5 against ``rasterize_pallas_luma(interpret=True)`` /
``rasterize_pallas(interpret=True)`` and ``rasterize_jax`` on the same
JAX ``TriangleSetup``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_imitation_learning_tpu.ops.raster import (
    rasterize_pallas, rasterize_pallas_luma, tile_lists as j_tile_lists,
)
from carla_imitation_learning_tpu.ops.raster_fast import tile_lists_fast as j_tile_lists_fast
from carla_imitation_learning_tpu.render import geometry as j_geo
from carla_imitation_learning_tpu.render.camera import camera_from_ego as j_camera
from carla_imitation_learning_tpu.render.camera import project_triangles as j_project
from carla_imitation_learning_tpu.render.jax_raster import rasterize_jax
from carla_imitation_learning_tpu.sim import SimParams, make_town
from carla_imitation_learning_tpu.sim import agents as j_agents
from carla_imitation_learning_tpu.sim.world import reset_env
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch.ops import raster as p_raster
from carla_imitation_learning_tpu_torch.ops import raster_fast as p_fast
from carla_imitation_learning_tpu_torch.render import geometry as p_geo
from carla_imitation_learning_tpu_torch.render.camera import camera_from_ego as p_camera
from carla_imitation_learning_tpu_torch.render.camera import project_triangles as p_project
from carla_imitation_learning_tpu_torch.render.plain_raster import rasterize_plain
from carla_imitation_learning_tpu_torch.sim import agents as p_agents

H = W = 64
T = 256
TOWN = make_town(blocks=2, n_buildings=6, n_lights=2)
PARAMS = SimParams(n_agents=3)
STATIC = j_geo.build_static_scene(TOWN)
P_TOWN = convert.town_from_jax(TOWN)
P_STATIC = p_geo.build_static_scene(P_TOWN)


def _scene(seed):
    st = reset_env(PARAMS, TOWN, jax.random.PRNGKey(seed))
    phases = j_agents.light_phases(TOWN, st.t.astype(jnp.float32) * PARAMS.dt,
                                   PARAMS.light_green, PARAMS.light_yellow,
                                   PARAMS.light_red)
    ap, ay = j_agents.agent_positions(TOWN, st.agents_route, st.agents_s)
    tris, colors, classes = j_geo.assemble_scene(STATIC, TOWN.lights_pos, phases,
                                                 ap, ay, T)
    cam = j_camera(st.ego_pos, st.ego_yaw)
    cullable = ((classes == j_geo.SEM_BUILDING) | (classes == j_geo.SEM_VEHICLE))
    setup = j_project(tris, colors, classes, cam, W, H, 90.0, 0.5, cullable=cullable)
    return st, (tris, colors, classes), setup


@pytest.fixture(scope="module")
def scenes():
    """JAX state, world triangles and TriangleSetup for seeds 0-2."""
    return {seed: _scene(seed) for seed in (0, 1, 2)}


def test_static_scene_equal():
    for name in ("tris", "colors", "classes"):
        np.testing.assert_array_equal(getattr(P_STATIC, name).numpy(),
                                      np.asarray(getattr(STATIC, name)), err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_assemble_scene_matches(scenes, seed):
    st, (tris, colors, classes), _ = scenes[seed]
    ps = convert.world_state_from_jax(st)
    phases = p_agents.light_phases(P_TOWN, ps.t.to(torch.float32) * PARAMS.dt,
                                   PARAMS.light_green, PARAMS.light_yellow,
                                   PARAMS.light_red)
    ap, ay = p_agents.agent_positions(P_TOWN, ps.agents_route, ps.agents_s)
    p_tris, p_colors, p_classes = p_geo.assemble_scene(
        P_STATIC, P_TOWN.lights_pos, phases, ap, ay, T)
    np.testing.assert_allclose(p_tris[0].numpy(), np.asarray(tris), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(p_colors[0].numpy(), np.asarray(colors))
    np.testing.assert_array_equal(p_classes[0].numpy(), np.asarray(classes))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_project_triangles_matches(scenes, seed):
    """Same world triangles and ego pose into both setups."""
    st, (tris, colors, classes), setup = scenes[seed]
    ps = convert.world_state_from_jax(st)
    cam = p_camera(ps.ego_pos, ps.ego_yaw)
    p_cls = torch.tensor(np.asarray(classes), dtype=torch.int64)[None]
    cullable = (p_cls == p_geo.SEM_BUILDING) | (p_cls == p_geo.SEM_VEHICLE)
    got = p_project(torch.tensor(np.asarray(tris))[None],
                    torch.tensor(np.asarray(colors))[None], p_cls, cam,
                    W, H, 90.0, 0.5, cullable=cullable)
    np.testing.assert_array_equal(got.valid[0].numpy(), np.asarray(setup.valid))
    for name in ("bbox", "zmin"):
        np.testing.assert_allclose(getattr(got, name)[0].numpy(),
                                   np.asarray(getattr(setup, name)),
                                   rtol=1e-5, atol=1e-4, err_msg=name)
    # Edge rows are cross products E_i = v_j × v_k of the homogeneous
    # vertices, and for thin or edge-on triangles they cancel to far below
    # their terms. XLA on the CPU contracts a1·b2 − a2·b1 (and the camera
    # dot products) into FMAs, torch does not, so the two agree to rtol
    # relative to the magnitude of the terms, |v_j|·|v_k|, not to that of
    # the cancelled result.
    jcam = j_camera(st.ego_pos, st.ego_yaw)
    rel = np.asarray(tris, np.float64) - np.asarray(jcam.pos, np.float64)
    v = np.stack([rel @ np.asarray(jcam.right), rel @ np.asarray(jcam.down),
                  rel @ np.asarray(jcam.forward)], -1)
    vz = np.abs(v[..., 2])
    vn = np.abs(v).max(-1) * (W / 2.0 + 1.0)             # |v_i| bound, (T, 3)
    term = np.stack([vn[:, 1] * vn[:, 2], vn[:, 2] * vn[:, 0], vn[:, 0] * vn[:, 1]], 1)
    scales = {"edges": term[..., None], "znum": (vz * term).sum(1)[..., None]}
    for name, scale in scales.items():
        g = getattr(got, name)[0].numpy()
        w = np.asarray(getattr(setup, name))
        assert (np.abs(g - w) <= 1e-5 * scale + 1e-4).all(), name


def _batched(scenes, seeds):
    setups = [scenes[s][2] for s in seeds]
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *setups)


def test_band_lists_equal(scenes):
    """tile_lists and tile_lists_fast on the same JAX setup (full-width and
    capped lists, with and without LOD) give the same idx and count."""
    seeds = (0, 1, 2)
    p_setup = convert.setup_from_jax(_batched(scenes, seeds))
    idx, count = p_raster.tile_lists(p_setup, H, T, width=W)
    for b, seed in enumerate(seeds):
        j_idx, j_count = j_tile_lists(scenes[seed][2], H, T, width=W)
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(j_idx))
        np.testing.assert_array_equal(count[b].numpy(), np.asarray(j_count)[:, 0])
    for k, lod in ((T, 0.0), (T, 2.0), (64, 0.0)):
        idx, count = p_fast.tile_lists_fast(p_setup, H, k, width=W, lod_px=lod)
        for b, seed in enumerate(seeds):
            j_idx, j_count = j_tile_lists_fast(scenes[seed][2], H, k, width=W,
                                               lod_px=lod)
            np.testing.assert_array_equal(idx[b].numpy(), np.asarray(j_idx))
            np.testing.assert_array_equal(count[b].numpy(), np.asarray(j_count)[:, 0])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exact_luma_matches_pallas_interpret(scenes, seed):
    setup = scenes[seed][2]
    g_j, sem_j, depth_j = rasterize_pallas_luma(setup, H, W, interpret=True)
    g_p, sem_p, depth_p = p_raster.rasterize_exact_luma(convert.setup_from_jax(setup), H, W)
    np.testing.assert_array_equal(sem_p[0].numpy(), np.asarray(sem_j))
    assert np.abs(g_p[0].numpy() - np.asarray(g_j)).max() < 1e-5
    np.testing.assert_allclose(depth_p[0].numpy(), np.asarray(depth_j), rtol=1e-5)


def test_exact_rgb_matches_pallas_and_jax_reference(scenes):
    seeds = (0, 1, 2)
    rgb_p, sem_p, _ = p_raster.rasterize_exact(convert.setup_from_jax(_batched(scenes, seeds)),
                                               H, W)
    for b, seed in enumerate(seeds):
        setup = scenes[seed][2]
        for rgb_j, sem_j, _ in (rasterize_pallas(setup, H, W, interpret=True),
                                rasterize_jax(setup, H, W)):
            np.testing.assert_array_equal(sem_p[b].numpy(), np.asarray(sem_j))
            assert np.abs(rgb_p[b].numpy() - np.asarray(rgb_j)).max() < 1e-5


def test_plain_reference_matches_exact_bands(scenes):
    """The port's own plain z-buffer reference (render/plain_raster.py) and
    kernel A's plain version agree pixel for pixel (the port's bench gate)."""
    p_setup = convert.setup_from_jax(_batched(scenes, (0, 1, 2)))
    rgb_a, sem_a, depth_a = p_raster.rasterize_exact(p_setup, H, W)
    rgb_r, sem_r, depth_r = rasterize_plain(p_setup, H, W)
    assert torch.equal(sem_a, sem_r)
    assert (rgb_a - rgb_r).abs().max() < 1e-5
    assert (depth_a - depth_r).abs().max() < 1e-3


def test_exact_bands_cap_and_first_writer(scenes):
    """A capped list keeps the nearest triangles; equal-depth duplicates
    resolve to the first listed one."""
    setup = convert.setup_from_jax(scenes[0][2])
    tbl = p_raster.pack_setup(setup, luma_only=True)
    idx, count = p_raster.tile_lists(setup, H, T, width=W)
    rows = p_raster.band_rows(H)
    sem, col, depth = p_raster.raster_bands(tbl, idx, count, H, W, 0.5, 300.0, 1, rows)
    # duplicate every listed triangle with another class: nothing changes
    tbl2 = torch.cat([tbl, tbl], dim=2)
    tbl2[:, 15, T:] = 7.0
    idx2 = torch.stack([idx, idx + T], dim=-1).reshape(1, idx.shape[1], -1)
    sem2, col2, depth2 = p_raster.raster_bands(tbl2.contiguous(), idx2.to(torch.int32),
                                               count * 2, H, W, 0.5, 300.0, 1, rows)
    assert torch.equal(sem, sem2) and torch.equal(col, col2) and torch.equal(depth, depth2)
    g_cap, sem_cap, _ = p_raster.rasterize_exact_luma(setup, H, W, max_tris_per_tile=48)
    g_j, sem_j, _ = rasterize_pallas_luma(scenes[0][2], H, W, interpret=True,
                                          max_tris_per_tile=48)
    np.testing.assert_array_equal(sem_cap[0].numpy(), np.asarray(sem_j))
    assert np.abs(g_cap[0].numpy() - np.asarray(g_j)).max() < 1e-5
