"""Procedural textures in the PyTorch port vs the JAX package:
``texture_factor`` on a grid, and kernel A's textured variant (its plain
version, the path CPU tensors take) and the port's plain reference
rasterizer against ``rasterize_jax``, ``rasterize_pallas(interpret=True)``
and ``rasterize_pallas_luma(interpret=True)`` on the same converted JAX
``TriangleSetup`` of the rich scene.

Tolerances. The road and terrain speckle hashes fract(sin(a)·43758.5453)
with a = cu·12.9898 + cv·78.233 of order 1e4, so one ulp of ``a`` or of
sin(a) moves the hash anywhere in [0, 1). torch's and XLA's CPU ``sin``
differ by one ulp on a few per cent of arguments; and inside ``jit`` XLA
fuses the argument's multiply-add, so the JAX package's own jitted kernels
disagree with its eager ``texture_factor`` on about 12 % of speckle hashes.
Hence: the semantic plane is equal and depth within rtol 1e-5 everywhere;
pixels of every other class within 1e-5; road and terrain pixels within the
fast raster's tolerance (mean|d| < 2e-3, < 1 % of pixels off by more than
2/255) against ``rasterize_jax`` run eagerly (``jax.disable_jit``), and
against the jitted kernels on the pixels where those agree with that eager
reference.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_imitation_learning_tpu.ops.raster import rasterize_pallas, rasterize_pallas_luma
from carla_imitation_learning_tpu.ops.texture import texture_factor as j_texture_factor
from carla_imitation_learning_tpu.render import geometry as j_geo
from carla_imitation_learning_tpu.render.camera import camera_from_ego, project_triangles
from carla_imitation_learning_tpu.render.jax_raster import rasterize_jax
from carla_imitation_learning_tpu.sim import SimParams, make_town
from carla_imitation_learning_tpu.sim import agents as j_agents
from carla_imitation_learning_tpu.sim.world import reset_env
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch.ops import raster as p_raster
from carla_imitation_learning_tpu_torch.ops.texture import texture_factor
from carla_imitation_learning_tpu_torch.render.plain_raster import rasterize_plain

H = W = 64
T = 256
TOWN = make_town(blocks=2, n_buildings=6, n_lights=2)
PARAMS = SimParams(n_agents=3)
STATIC = j_geo.build_static_scene(TOWN, facade_bands=3, markings=True)
SPECKLED = (j_geo.SEM_ROAD, j_geo.SEM_TERRAIN)


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
                             cullable=cullable, textures=True)


@pytest.fixture(scope="module")
def setups():
    by_seed = {seed: _setup(seed) for seed in (0, 1, 2)}
    batch = convert.setup_from_jax(
        jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *by_seed.values()))
    return by_seed, batch


def _check_colour(got, want, sem, what):
    """got/want (H, W) or (H, W, 3); sem (H, W) class ids of both."""
    d = np.abs(got - want)
    if d.ndim == 3:
        d = d.max(-1)
    speckle = np.isin(sem, SPECKLED)
    assert d[~speckle].max(initial=0.0) < 1e-5, f"{what}: flat pixels off by {d[~speckle].max()}"
    assert d.mean() < 2e-3, f"{what}: mean diff {d.mean()}"
    assert (d > 2 / 255).mean() < 0.01, f"{what}: {(d > 2 / 255).mean():.3%} pixels off"


def test_texture_factor_matches_jax():
    rng = np.random.default_rng(0)
    u = rng.uniform(-150.0, 450.0, (8, 4096)).astype(np.float32)
    v = rng.uniform(-150.0, 450.0, (8, 4096)).astype(np.float32)
    cls = np.arange(8, dtype=np.int32)[:, None]
    want = np.asarray(j_texture_factor(jnp.asarray(u), jnp.asarray(v), jnp.asarray(cls)))
    got = texture_factor(torch.tensor(u), torch.tensor(v), torch.tensor(cls)).numpy()
    for c in range(8):
        if c in SPECKLED:
            d = np.abs(got[c] - want[c])
            assert d.mean() < 2e-3 and (d > 2 / 255).mean() < 0.01, c
            assert (d == 0).mean() > 0.9, c     # most hashes agree bit for bit
        else:
            np.testing.assert_array_equal(got[c], want[c], err_msg=f"class {c}")
    # the factor spans the designed range per class
    assert set(np.unique(got[j_geo.SEM_BUILDING])) == {np.float32(0.55), np.float32(1.05)}
    assert (got[j_geo.SEM_ROAD] >= 0.88).all() and (got[j_geo.SEM_ROAD] < 1.12).all()


def test_textured_table_layout(setups):
    batch = setups[1]
    tbl = p_raster.pack_setup(batch)
    assert tbl.shape == (3, p_raster.TEX_PACK_WIDTH, T) and tbl.is_contiguous()
    torch.testing.assert_close(tbl[:, 17:20], torch.where(batch.valid[:, None], batch.unum.transpose(1, 2), 0.0))
    assert p_raster.pack_setup(batch, luma_only=True).shape[1] == 23


def _eager_reference(setup):
    """``rasterize_jax`` op by op: ``texture_factor`` as written, unfused."""
    with jax.disable_jit():
        rgb, sem, depth = rasterize_jax(setup, H, W)
    return np.asarray(rgb), np.asarray(sem), np.asarray(depth)


def _check_against_jitted(got, want, ref, sem, what):
    """Jitted JAX kernel ``want``: equal to ``got`` within 1e-5 off the
    speckle; on it, within tolerance where ``want`` agrees with the eager
    reference ``ref``."""
    d = np.abs(got - want)
    self_consistent = np.abs(want - ref) <= 1e-5
    if d.ndim == 3:
        d, self_consistent = d.max(-1), self_consistent.all(-1)
    speckle = np.isin(sem, SPECKLED)
    assert d[~speckle].max(initial=0.0) < 1e-5, f"{what}: flat pixels off by {d[~speckle].max()}"
    assert self_consistent[~speckle].all()
    _check_colour(np.where(self_consistent[..., None] if got.ndim == 3 else self_consistent,
                           got, want), want, sem, what)


def test_textured_luma_matches_jax(setups):
    by_seed, batch = setups
    g_p, sem_p, depth_p = p_raster.rasterize_exact_luma(batch, H, W)
    for b, (seed, setup) in enumerate(by_seed.items()):
        rgb_e, sem_e, depth_e = _eager_reference(setup)
        luma_e = rgb_e @ np.asarray(p_raster.LUMA_W, np.float32)
        np.testing.assert_array_equal(sem_p[b].numpy(), sem_e)
        np.testing.assert_allclose(depth_p[b].numpy(), depth_e, rtol=1e-5)
        _check_colour(g_p[b].numpy(), luma_e, sem_e, f"seed {seed} luma vs eager")
        g_j, sem_j, depth_j = rasterize_pallas_luma(setup, H, W, interpret=True)
        np.testing.assert_array_equal(sem_p[b].numpy(), np.asarray(sem_j))
        np.testing.assert_allclose(depth_p[b].numpy(), np.asarray(depth_j), rtol=1e-5)
        _check_against_jitted(g_p[b].numpy(), np.asarray(g_j), luma_e, sem_e,
                              f"seed {seed} luma vs pallas")


def test_textured_rgb_matches_jax(setups):
    by_seed, batch = setups
    rgb_p, sem_p, depth_p = p_raster.rasterize_exact(batch, H, W)
    rgb_r, sem_r, depth_r = rasterize_plain(batch, H, W)
    assert torch.equal(sem_p, sem_r)
    for b, (seed, setup) in enumerate(by_seed.items()):
        rgb_e, sem_e, depth_e = _eager_reference(setup)
        for got in (rgb_p, rgb_r):
            np.testing.assert_array_equal(sem_p[b].numpy(), sem_e)
            np.testing.assert_allclose(depth_p[b].numpy(), depth_e, rtol=1e-5)
            _check_colour(got[b].numpy(), rgb_e, sem_e, f"seed {seed} vs eager")
        for name, (rgb_j, sem_j, depth_j) in (
                ("pallas", rasterize_pallas(setup, H, W, interpret=True)),
                ("jax", rasterize_jax(setup, H, W))):
            np.testing.assert_array_equal(sem_p[b].numpy(), np.asarray(sem_j))
            np.testing.assert_allclose(depth_p[b].numpy(), np.asarray(depth_j), rtol=1e-5)
            _check_against_jitted(rgb_p[b].numpy(), np.asarray(rgb_j), rgb_e, sem_e,
                                  f"seed {seed} vs {name}")


def test_textured_plain_versions_agree(setups):
    """Kernel A's plain version and the plain reference rasterizer compute
    the same textured frame (the render gate the card runs); textures move
    the frame off the flat one."""
    batch = setups[1]
    rgb_a, sem_a, _ = p_raster.rasterize_exact(batch, H, W)
    rgb_r, sem_r, _ = rasterize_plain(batch, H, W)
    assert torch.equal(sem_a, sem_r)
    assert (rgb_a - rgb_r).abs().max() < 1e-5
    flat = dataclasses.replace(batch, unum=None, vnum=None)
    rgb_f, sem_f, _ = p_raster.rasterize_exact(flat, H, W)
    assert torch.equal(sem_f, sem_a)
    assert (rgb_f - rgb_a).abs().max() > 0.05
