"""The LIDAR (``render/lidar.py``), the safety shield
(``training/shield.py``) and the shielded rollout of the PyTorch port
against the JAX package, fp32 on the CPU, from JAX's fleets converted with
``convert``:

- ``cast_rays`` on JAX's known walls (``tests/test_weather_lidar.py``);
- ``make_lidar`` on a random fleet with walkers against JAX's vmapped scan,
  for the full circle, the shield's fan and a wide sector: the beam angles
  equal JAX's, the ranges within 1e-5 relative;
- the shield's head-on trigger and clear-road no-op against JAX's
  (``tests/test_shield.py``), and ``shield_from_cfg``;
- an 8-step rollout with the shield and a 360-beam scan, from JAX's carry
  (env 0 pointed at an agent 6 m away at 8 m/s) and pool, with a
  full-throttle policy: ``traj["shield"]`` equal, ``traj["lidar"]`` within
  1e-5 relative, states allclose (rtol 1e-5, atol 1e-4), the labels the
  policy's own (the unshielded action) while the executed control brakes;
  the same rollout without either option keeps today's keys;
- ``evaluate_policy``'s two shield metrics equal JAX's on that trajectory.

The JAX rollout renders with its plain XLA path: the policy ignores its
frames, so the frames are not compared.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_imitation_learning_tpu.render import lidar as j_lidar
from carla_imitation_learning_tpu.render.pipeline import RenderConfig as JRenderConfig
from carla_imitation_learning_tpu.sim import SimParams as JParams
from carla_imitation_learning_tpu.sim import make_town
from carla_imitation_learning_tpu.sim.agents import agent_positions
from carla_imitation_learning_tpu.sim.pedestrians import ped_positions
from carla_imitation_learning_tpu.sim.world import VehicleControl as JControl
from carla_imitation_learning_tpu.sim.world import reset_env as j_reset
from carla_imitation_learning_tpu.training import closed_loop as j_loop
from carla_imitation_learning_tpu.training import shield as j_shield
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch.render import lidar
from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
from carla_imitation_learning_tpu_torch.sim.world import SimParams, VehicleControl
from carla_imitation_learning_tpu_torch.training import closed_loop as p_loop
from carla_imitation_learning_tpu_torch.training import shield

TOWN = make_town(blocks=2, n_buildings=6, n_lights=2)
P_TOWN = convert.town_from_jax(TOWN)
J_PARAMS, P_PARAMS = JParams(n_agents=3), SimParams(n_agents=3)
N_ENVS, N_STEPS, BEAMS = 4, 8, 360
FULL_THROTTLE = 7     # straight with throttle


def _fleet(params, n, seed):
    return jax.jit(jax.vmap(lambda k: j_reset(params, TOWN, k)))(
        jax.random.split(jax.random.PRNGKey(seed), n))


def _face_agent0(states, gap: float, speed: float):
    """Point env 0's ego straight at agent 0 from ``gap`` meters west of it."""
    ap, _ = agent_positions(TOWN, states.agents_route[0], states.agents_s[0])
    return states.replace(ego_pos=states.ego_pos.at[0].set(ap[0] - jnp.asarray([gap, 0.0])),
                          ego_yaw=states.ego_yaw.at[0].set(0.0),
                          ego_v=states.ego_v.at[0].set(speed))


@pytest.mark.parametrize("segs,angles,want", [
    ([[[10.0, -5.0], [10.0, 5.0]]], [0.0, np.pi / 2, np.pi], [10.0, 60.0, 60.0]),
    ([[[5.0, -9.0], [5.0, 9.0]]], [np.pi / 4], [5.0 * np.sqrt(2.0)]),
    ([[[20.0, -5.0], [20.0, 5.0]], [[7.0, -5.0], [7.0, 5.0]]], [0.0], [7.0]),
], ids=["wall", "diagonal", "nearest_of_two"])
def test_cast_rays_known_walls(segs, angles, want):
    segs, angles = np.float32(segs), np.float32(angles)
    j = np.asarray(j_lidar.cast_rays(jnp.zeros(2), jnp.asarray(angles), jnp.asarray(segs), 60.0))
    p = lidar.cast_rays(torch.zeros(2), torch.from_numpy(angles), torch.from_numpy(segs), 60.0)
    np.testing.assert_allclose(p.numpy(), want, atol=1e-4)
    np.testing.assert_allclose(p.numpy(), j, rtol=1e-6)


def test_segments_match():
    b = np.float32([[0.0, 0.0, 2.0, 3.0, 10.0], [5.0, 5.0, 1.0, 1.0, 8.0]])
    np.testing.assert_array_equal(lidar.building_segments(torch.from_numpy(b)).numpy(),
                                  np.asarray(j_lidar.building_segments(jnp.asarray(b))))
    rng = np.random.default_rng(0)
    pos, yaw = rng.uniform(-50, 50, (5, 2)).astype(np.float32), rng.uniform(-4, 4, 5).astype(
        np.float32)
    np.testing.assert_allclose(
        lidar.vehicle_segments(torch.from_numpy(pos), torch.from_numpy(yaw)).numpy(),
        np.asarray(j_lidar.vehicle_segments(jnp.asarray(pos), jnp.asarray(yaw))),
        rtol=1e-6, atol=1e-5)


def _closure(fn) -> dict:
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))


@pytest.fixture(scope="module")
def walker_fleet():
    return _fleet(JParams(n_agents=6, n_pedestrians=4), 6, 5)


@pytest.mark.parametrize("beams,fov", [(360, 360.0), (7, 36.0), (90, 120.0)],
                         ids=["circle", "shield_fan", "sector"])
def test_make_lidar_matches_jax_fleet(walker_fleet, beams, fov):
    states = walker_fleet
    scan = j_lidar.make_lidar(TOWN, n_beams=beams, max_range=60.0, fov_deg=fov)
    rel = np.asarray(_closure(scan)["rel"])
    np.testing.assert_array_equal(lidar.beam_angles(beams, fov).numpy(), rel)

    def one(s):
        ap, ay = agent_positions(TOWN, s.agents_route, s.agents_s)
        return scan(s, ap, ay, ped_positions(TOWN, s.peds_crossing, s.peds_s))

    want = np.asarray(jax.jit(jax.vmap(one))(states))
    got = lidar.make_lidar(P_TOWN, n_beams=beams, max_range=60.0, fov_deg=fov)(
        convert.world_state_from_jax(states)).numpy()
    assert got.shape == (6, beams) and (got > 0).all() and (got <= 60.0).all()
    assert (got < 60.0).any()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    img = lidar.lidar_image(torch.from_numpy(got)).numpy()
    np.testing.assert_allclose(img, np.asarray(j_lidar.lidar_image(jnp.asarray(want))),
                               atol=1e-6)


def _controls(n, torch_side: bool):
    ones, zeros = np.ones(n, np.float32), np.zeros(n, np.float32)
    if torch_side:
        return VehicleControl(steer=torch.from_numpy(zeros), throttle=torch.from_numpy(ones),
                              brake=torch.from_numpy(zeros))
    return JControl(steer=jnp.asarray(zeros), throttle=jnp.asarray(ones), brake=jnp.asarray(zeros))


@functools.lru_cache(maxsize=None)
def _j_shield_apply():
    return jax.jit(j_shield.make_shield(TOWN, j_shield.ShieldConfig()))


@pytest.mark.parametrize("case", ["head_on", "clear_road"])
def test_shield_trigger_matches_jax(jax_shielded, case):
    """On the rollout's start fleet (env 0 faces an agent 6 m away at 8
    m/s), and on the same fleet parked 500 m outside the town."""
    states = jax_shielded[0][0]
    if case == "clear_road":
        states = states.replace(
            ego_pos=jnp.tile(jnp.asarray([[-500.0, -500.0]]), (N_ENVS, 1)),
            ego_yaw=jnp.full((N_ENVS,), jnp.pi), ego_v=jnp.full((N_ENVS,), 5.0))
    n = states.t.shape[0]
    j_out, j_trig = _j_shield_apply()(states, _controls(n, False))
    p_out, p_trig = shield.make_shield(P_TOWN, shield.ShieldConfig())(
        convert.world_state_from_jax(states), _controls(n, True))
    np.testing.assert_array_equal(p_trig.numpy(), np.asarray(j_trig))
    assert bool(p_trig[0]) == (case == "head_on") and (case == "head_on" or not p_trig.any())
    for f in ("steer", "throttle", "brake"):
        np.testing.assert_array_equal(getattr(p_out, f).numpy(), np.asarray(getattr(j_out, f)))
    np.testing.assert_array_equal(p_out.steer.numpy(), 0.0)


def test_shield_from_cfg():
    assert shield.shield_from_cfg({}) is None
    assert shield.shield_from_cfg({"safety_shield": "false"}) is None
    cfg = {"safety_shield": True, "shield_ttc_s": 1.5, "shield_n_beams": 9}
    want = j_shield.shield_from_cfg(cfg)
    assert dataclasses.asdict(shield.shield_from_cfg(cfg)) == dataclasses.asdict(want)


def _full_throttle_j(obs):
    return jnp.full((obs.shape[0],), FULL_THROTTLE, jnp.int32)


def _full_throttle_p(obs):
    return torch.full((obs.shape[0],), FULL_THROTTLE, dtype=torch.int64)


@pytest.fixture(scope="module")
def jax_shielded():
    """JAX's 8-step rollout with the shield and the scan (one compile), from
    a carry whose env 0 faces an agent 6 m away at 8 m/s. The policy never
    looks at its frames, so the JAX side renders blank ones (no raster in
    the compile)."""
    rcfg = JRenderConfig(height=32, width=32, backend="jax", rgb=False, semantic=False,
                         max_triangles=128)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_loop, "make_renderer", lambda *a, **k: (
            lambda state: {"gray": jnp.zeros((32, 32), jnp.float32)}))
        init_fn, roll = j_loop.make_rollout(J_PARAMS, TOWN, rcfg, _full_throttle_j,
                                            shield=j_shield.ShieldConfig(),
                                            lidar_beams=BEAMS)
    states, framebuf, just_reset = init_fn(jax.random.PRNGKey(0), N_ENVS)
    carry = (_face_agent0(states, gap=6.0, speed=8.0), framebuf, just_reset)
    _, traj = roll(carry, N_STEPS)
    return carry, j_loop.rollout_spawn_pool(J_PARAMS, TOWN), traj


def _p_rollout(carry, pool, **kw):
    _, roll = p_loop.make_rollout(P_PARAMS, P_TOWN, RenderConfig(32, 32, max_triangles=128),
                                  _full_throttle_p, spawn_pool=convert.spawn_pool_from_jax(pool),
                                  device="cpu", **kw)
    return roll(convert.carry_from_jax(carry), N_STEPS)[1]


def test_shielded_rollout_matches_jax(jax_shielded):
    carry, pool, j_traj = jax_shielded
    traj = _p_rollout(carry, pool, shield=shield.ShieldConfig(), lidar_beams=BEAMS)
    assert traj["shield"].shape == (N_STEPS, N_ENVS) and traj["shield"].dtype == torch.bool
    assert traj["lidar"].shape == (N_STEPS, N_ENVS, BEAMS)
    np.testing.assert_array_equal(traj["shield"].numpy(), np.asarray(j_traj["shield"]))
    assert bool(traj["shield"][0, 0])
    np.testing.assert_allclose(traj["lidar"].numpy(), np.asarray(j_traj["lidar"]), rtol=1e-5)
    for key in ("action", "expert_action", "done", "collision", "offroad"):
        np.testing.assert_array_equal(traj[key].numpy(), np.asarray(j_traj[key]), err_msg=key)
    for key in ("speed", "sensor", "steer", "throttle", "brake", "route_ds"):
        np.testing.assert_allclose(traj[key].numpy(), np.asarray(j_traj[key]), rtol=1e-5,
                                   atol=1e-4, err_msg=key)
    on = traj["shield"]
    assert (traj["action"] == FULL_THROTTLE).all()
    assert (traj["brake"][on] == 1.0).all() and (traj["throttle"][on] == 0.0).all()
    assert (traj["throttle"][~on] == 1.0).all()
    plain = _p_rollout(carry, pool)
    assert "shield" not in plain and "lidar" not in plain
    assert torch.equal(plain["action"][0], traj["action"][0])
    assert not torch.equal(plain["brake"], traj["brake"])


def test_shield_metrics_match_jax(jax_shielded, monkeypatch):
    """JAX's ``evaluate_policy`` on its shielded trajectory (its rollout
    replaced by one that hands that trajectory back) against the port's
    ``driving_metrics`` on the port's own shielded rollout."""
    carry, pool, j_traj = jax_shielded
    monkeypatch.setattr(j_loop, "make_rollout", lambda *a, **k: (
        lambda rng, n: carry, lambda c, n: (c, j_traj)))
    want = j_loop.evaluate_policy(J_PARAMS, TOWN, None, _full_throttle_j, None,
                                  n_envs=N_ENVS, n_steps=N_STEPS,
                                  shield=j_shield.ShieldConfig())
    got = p_loop.driving_metrics(P_PARAMS, _p_rollout(carry, pool, shield=shield.ShieldConfig()))
    assert set(got) == set(want)
    assert want["shield_active_frac"] > 0
    for k in ("shield_interventions_per_km", "shield_active_frac", "km_driven"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
