"""PyTorch port of the rich scene vs the JAX package: banded facades, lane
markings, blob shadows, and the optional camera rows the rich render paths
read (surface-UV rows for textures, the 1/z row and quad-pair analysis for
the fused-quad kernel).

Tolerances: static scene equal field for field; assembled triangles allclose
(rtol 1e-5, atol 1e-4: vehicle and shadow corners go through cos/sin of the
yaw) with colours and classes equal; camera rows within rtol 1e-5 of the
magnitude of their terms (see tests/test_torch_render.py); ``pair_ok`` and
``valid`` equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_imitation_learning_tpu.render import geometry as j_geo
from carla_imitation_learning_tpu.render.camera import camera_from_ego as j_camera
from carla_imitation_learning_tpu.render.camera import project_triangles as j_project
from carla_imitation_learning_tpu.sim import SimParams, make_town
from carla_imitation_learning_tpu.sim import agents as j_agents
from carla_imitation_learning_tpu.sim.world import reset_env
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch.render import geometry as p_geo
from carla_imitation_learning_tpu_torch.render.camera import camera_from_ego as p_camera
from carla_imitation_learning_tpu_torch.render.camera import project_triangles as p_project
from carla_imitation_learning_tpu_torch.sim import agents as p_agents

H = W = 64
T = 256
TOWN = make_town(blocks=2, n_buildings=6, n_lights=2)
PARAMS = SimParams(n_agents=3)
P_TOWN = convert.town_from_jax(TOWN)
STATIC = j_geo.build_static_scene(TOWN, facade_bands=3, markings=True)
P_STATIC = p_geo.build_static_scene(P_TOWN, facade_bands=3, markings=True)


def _scene(seed):
    st = reset_env(PARAMS, TOWN, jax.random.PRNGKey(seed))
    phases = j_agents.light_phases(TOWN, st.t.astype(jnp.float32) * PARAMS.dt,
                                   PARAMS.light_green, PARAMS.light_yellow,
                                   PARAMS.light_red)
    ap, ay = j_agents.agent_positions(TOWN, st.agents_route, st.agents_s)
    tris, colors, classes = j_geo.assemble_scene(STATIC, TOWN.lights_pos, phases,
                                                 ap, ay, T, shadows=True)
    cam = j_camera(st.ego_pos, st.ego_yaw)
    cullable = ((classes == j_geo.SEM_BUILDING) | (classes == j_geo.SEM_VEHICLE))
    setup = j_project(tris, colors, classes, cam, W, H, 90.0, 0.5,
                      cullable=cullable, textures=True)
    return st, (tris, colors, classes), setup


@pytest.fixture(scope="module")
def scenes():
    return {seed: _scene(seed) for seed in (0, 1, 2)}


@pytest.mark.parametrize("bands,markings", [(3, True), (2, False), (0, True), (1, True)])
def test_static_scene_equal(bands, markings):
    want = j_geo.build_static_scene(TOWN, facade_bands=bands, markings=markings)
    got = p_geo.build_static_scene(P_TOWN, facade_bands=bands, markings=markings)
    for name in ("tris", "colors", "classes"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)


def test_rich_scene_fills_the_test_table(scenes):
    """The rich test scene is real work for the table: markings are in it
    and, with vehicles, light heads and shadows, every one of the T slots
    is used."""
    assert P_STATIC.tris.shape[0] == 210
    assert (P_STATIC.classes == p_geo.SEM_ROADLINE).sum() > 0
    tris = np.asarray(scenes[0][1][0])
    assert (np.abs(tris).sum((1, 2)) > 0).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_assemble_scene_with_shadows_matches(scenes, seed):
    st, (tris, colors, classes), _ = scenes[seed]
    ps = convert.world_state_from_jax(st)
    phases = p_agents.light_phases(P_TOWN, ps.t.to(torch.float32) * PARAMS.dt,
                                   PARAMS.light_green, PARAMS.light_yellow,
                                   PARAMS.light_red)
    ap, ay = p_agents.agent_positions(P_TOWN, ps.agents_route, ps.agents_s)
    p_tris, p_colors, p_classes = p_geo.assemble_scene(
        P_STATIC, P_TOWN.lights_pos, phases, ap, ay, T, shadows=True)
    np.testing.assert_allclose(p_tris[0].numpy(), np.asarray(tris), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(p_colors[0].numpy(), np.asarray(colors))
    np.testing.assert_array_equal(p_classes[0].numpy(), np.asarray(classes))


def test_walker_shadows_follow_the_walkers():
    """Walkers (P > 0) get core and penumbra shadows too, orientation-free."""
    static = p_geo.build_static_scene(P_TOWN)
    ap = torch.tensor([[[10.0, 20.0]]])
    ay = torch.tensor([[0.3]])
    peds = torch.tensor([[[5.0, 6.0], [7.0, 8.0]]])
    tris, colors, classes = p_geo.assemble_scene(
        static, P_TOWN.lights_pos, torch.zeros((1, 2), dtype=torch.int64), ap, ay,
        512, peds_pos=peds, shadows=True)
    n_static = static.tris.shape[0]
    shadow = tris[0, n_static + 10 + 4 + 20:n_static + 10 + 4 + 20 + 12]
    assert (classes[0, n_static + 34:n_static + 46] == p_geo.SEM_ROAD).all()
    # core shadow of walker 0: 0.25·1.15 half-extent square around (5, 6)
    core = shadow[2:4].reshape(-1, 3)
    torch.testing.assert_close(core[:, :2].amax(0), torch.tensor([5.2875, 6.2875]))
    assert (core[:, 2] == p_geo.SHADOW_Z).all()


def _p_setup(st, tris, colors, classes):
    ps = convert.world_state_from_jax(st)
    cam = p_camera(ps.ego_pos, ps.ego_yaw)
    p_cls = torch.tensor(np.asarray(classes), dtype=torch.int64)[None]
    cullable = (p_cls == p_geo.SEM_BUILDING) | (p_cls == p_geo.SEM_VEHICLE)
    return p_project(torch.tensor(np.asarray(tris))[None],
                     torch.tensor(np.asarray(colors))[None], p_cls, cam,
                     W, H, 90.0, 0.5, cullable=cullable, textures=True, quads=True)


def _term_scales(st, tris):
    """|v_j|·|v_k| bounds of the terms of each edge row (T, 3), the bound
    |v_i| of each homogeneous vertex (T, 3), and |det| (T,), all in float64
    from the JAX camera."""
    jcam = j_camera(st.ego_pos, st.ego_yaw)
    rel = np.asarray(tris, np.float64) - np.asarray(jcam.pos, np.float64)
    x, y, z = (rel @ np.asarray(getattr(jcam, a), np.float64)
               for a in ("right", "down", "forward"))
    v = np.stack([(x + z) * (W / 2.0), (y + z) * (H / 2.0), z], -1)  # fov 90°
    vn = np.abs(v).max(-1) * (W / 2.0 + 1.0)
    term = np.stack([vn[:, 1] * vn[:, 2], vn[:, 2] * vn[:, 0], vn[:, 0] * vn[:, 1]], 1)
    det = np.abs(np.einsum("tc,tc->t", v[:, 0], np.cross(v[:, 1], v[:, 2])))
    return term, vn, det


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_optional_camera_rows_match(scenes, seed):
    """unum / vnum / zinv within rtol 1e-5 of their terms; pair_ok equal.
    The same world triangles and ego pose go into both setups."""
    st, (tris, colors, classes), setup = scenes[seed]
    got = _p_setup(st, tris, colors, classes)
    np.testing.assert_array_equal(got.valid[0].numpy(), np.asarray(setup.valid))
    np.testing.assert_array_equal(got.pair_ok[0].numpy(), np.asarray(setup.pair_ok))
    assert got.pair_ok.any()
    term, vn, det = _term_scales(st, tris)
    t = np.asarray(tris, np.float64)
    wall = (np.asarray(classes) == j_geo.SEM_BUILDING)[:, None]
    uv = {"unum": np.where(wall, np.abs(t[..., 0]) + np.abs(t[..., 1]), np.abs(t[..., 0])),
          "vnum": np.where(wall, np.abs(t[..., 2]), np.abs(t[..., 1]))}
    for name, w in uv.items():
        scale = (w * term).sum(1)[..., None]
        g, want = getattr(got, name)[0].numpy(), np.asarray(getattr(setup, name))
        assert (np.abs(g - want) <= 1e-5 * scale + 1e-4).all(), name
    # zinv = Σ_i E_i / |det|: the numerator's rounding scales with Σ_i of the
    # terms, |det| = |v_0 · E_0|'s with |v_0|·term_0, both over |det|
    g, want = got.zinv[0].numpy(), np.asarray(setup.zinv, np.float64)
    scale = (term.sum(1) + np.abs(want).max(1) * vn[:, 0] * term[:, 0]) / np.maximum(det, 1e-9)
    valid = np.asarray(setup.valid)
    assert (np.abs(g - want)[valid] <= (1e-5 * scale[:, None] + 1e-6)[valid]).all()
