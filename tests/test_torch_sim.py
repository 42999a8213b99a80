"""PyTorch port of the sim vs the JAX package: town build, dynamics, action
labels, spawn-pool picks and 20 expert steps from an injected fleet state.

Tolerances: town fields, pool picks and integer state equal; float state
allclose in fp32 (rtol 1e-5, atol 1e-4) — the two frameworks' libm
(atan2, tan, sqrt) may differ in the last bit, and 20 steps accumulate it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_imitation_learning_tpu.data import actions as j_actions
from carla_imitation_learning_tpu.sim import SimParams as JParams
from carla_imitation_learning_tpu.sim import make_town as j_make_town
from carla_imitation_learning_tpu.sim import world as j_world
from carla_imitation_learning_tpu.sim.dynamics import bicycle_step as j_bicycle
from carla_imitation_learning_tpu.sim.town import route_point as j_route_point
from carla_imitation_learning_tpu.training.closed_loop import rollout_spawn_pool as j_pool
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch.data import actions as p_actions
from carla_imitation_learning_tpu_torch.sim import world as p_world
from carla_imitation_learning_tpu_torch.sim.dynamics import bicycle_step as p_bicycle
from carla_imitation_learning_tpu_torch.sim.town import make_town as p_make_town
from carla_imitation_learning_tpu_torch.sim.town import route_point as p_route_point

RTOL, ATOL = 1e-5, 1e-4
TOWN_KW = dict(blocks=2, n_buildings=6, n_lights=2)
J_TOWN = j_make_town(**TOWN_KW)
P_TOWN = convert.town_from_jax(J_TOWN)


@pytest.mark.parametrize("kw", [
    dict(blocks=3, n_buildings=24, n_lights=8),          # the bench town
    TOWN_KW,                                             # the test town
    dict(blocks=2, n_buildings=8, n_lights=4, seed=3),
    dict(blocks=2, n_buildings=4, n_lights=2, corner_radius=6.0, superblocks=True),
])
def test_town_fields_equal(kw):
    j, p = j_make_town(**kw), p_make_town(**kw)
    for f in dataclasses.fields(p):
        want, got = getattr(j, f.name), getattr(p, f.name)
        if isinstance(got, torch.Tensor):
            assert got.dtype == torch.float32, f.name
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f.name)
        else:
            assert got == want, f.name


def test_route_point_matches():
    rng = np.random.default_rng(0)
    routes = rng.integers(0, J_TOWN.routes.shape[0], 64).astype(np.int32)
    s = rng.uniform(-50.0, 400.0, 64).astype(np.float32)
    j_pos, j_yaw = jax.vmap(lambda r, ss: j_route_point(J_TOWN, r, ss))(routes, s)
    p_pos, p_yaw = p_route_point(P_TOWN, torch.as_tensor(routes, dtype=torch.int64),
                                 torch.as_tensor(s))
    np.testing.assert_allclose(p_pos.numpy(), np.asarray(j_pos), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(p_yaw.numpy(), np.asarray(j_yaw), rtol=RTOL, atol=ATOL)


def test_bicycle_step_matches():
    rng = np.random.default_rng(1)
    n = 128
    args = [rng.uniform(-50, 50, (n, 2)), rng.uniform(-3.1, 3.1, n),
            rng.uniform(0, 15, n), rng.uniform(-0.6, 0.6, n),
            rng.uniform(-0.6, 0.6, n), rng.uniform(0, 1, n), rng.uniform(0, 1, n)]
    args = [a.astype(np.float32) for a in args]
    want = jax.vmap(lambda *a: j_bicycle(*a, dt=0.05))(*args)
    got = p_bicycle(*[torch.as_tensor(a) for a in args], dt=0.05)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


def test_action_labels_match():
    rng = np.random.default_rng(2)
    steer = rng.choice([-1.0, -0.06, -0.05, 0.0, 0.04, 0.05, 0.3, 1.0], 256).astype(np.float32)
    throttle = rng.choice([0.0, 0.5, 1.0, 0.7], 256).astype(np.float32)
    brake = rng.choice([0.0, 1.0, 0.3], 256).astype(np.float32)
    want = j_actions.continuous_to_discrete(jnp.asarray(steer), jnp.asarray(throttle),
                                            jnp.asarray(brake))
    got = p_actions.continuous_to_discrete(torch.as_tensor(steer), torch.as_tensor(throttle),
                                           torch.as_tensor(brake))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    action = np.arange(9, dtype=np.int32)
    for w, g in zip(j_actions.discrete_to_continuous(jnp.asarray(action)),
                    p_actions.discrete_to_continuous(torch.as_tensor(action))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_pedestrians_match():
    """Walkers are off in the bench config (P = 0) but ported: crosswalk and
    sidewalk walkers, walking and waiting, step and positions."""
    from carla_imitation_learning_tpu.sim import pedestrians as j_peds
    from carla_imitation_learning_tpu_torch.sim import pedestrians as p_peds

    rng = np.random.default_rng(3)
    n_paths = J_TOWN.crossings.shape[0] + J_TOWN.sidewalks.shape[0]
    path = rng.integers(0, n_paths, (2, 16)).astype(np.int32)
    s = rng.uniform(0, 1, (2, 16)).astype(np.float32)
    phase = rng.choice([1.0, -1.0, 0.3, -0.6, 0.99], (2, 16)).astype(np.float32)
    j_step = jax.vmap(lambda p, ss, ph: j_peds.step_pedestrians(J_TOWN, p, ss, ph, dt=0.05))
    j_pos = jax.vmap(lambda p, ss: j_peds.ped_positions(J_TOWN, p, ss))
    p_path = torch.as_tensor(path, dtype=torch.int64)
    got = p_peds.step_pedestrians(P_TOWN, p_path, torch.as_tensor(s),
                                  torch.as_tensor(phase), dt=0.05)
    for w, g in zip(j_step(path, s, phase), got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(p_peds.ped_positions(P_TOWN, p_path, torch.as_tensor(s)).numpy(),
                               np.asarray(j_pos(path, s)), rtol=RTOL, atol=ATOL)


def test_expert_branches_off_by_default_match():
    """Walkers (crosswalk and sidewalk) and the slow-for-turn cruise cap are
    off in the bench config but ported: the expert and the step agree with
    them on (resets come from a fixed fresh state here)."""
    kw = dict(n_agents=3, n_pedestrians=4, ped_sidewalk_frac=0.5, turn_speed=4.0)
    j_params, p_params = JParams(**kw), p_world.SimParams(**kw)
    states = jax.vmap(lambda k: j_world.reset_env(j_params, J_TOWN, k))(
        jax.random.split(jax.random.PRNGKey(5), 4))
    fresh = states

    @jax.jit
    def j_step(s):
        ctrl = jax.vmap(lambda x: j_world.autopilot_control(j_params, J_TOWN, x))(s)
        new, info = jax.vmap(lambda x, c, f: j_world.step_env(j_params, J_TOWN, x, c, f))(
            s, ctrl, fresh)
        return new, info, ctrl

    p_state, p_fresh = convert.world_state_from_jax(states), convert.world_state_from_jax(fresh)
    for step in range(8):
        states, j_info, j_ctrl = j_step(states)
        ctrl = p_world.autopilot_control(p_params, P_TOWN, p_state)
        for name in ("steer", "throttle", "brake"):
            np.testing.assert_allclose(getattr(ctrl, name).numpy(),
                                       np.asarray(getattr(j_ctrl, name)),
                                       rtol=RTOL, atol=ATOL, err_msg=f"step {step}: {name}")
        p_state, info = p_world.step_env(p_params, P_TOWN, p_state, ctrl, p_fresh)
        for key in ("done", "collision", "pedestrian"):
            np.testing.assert_array_equal(info[key].numpy(), np.asarray(j_info[key]))
        _compare_states(p_state, states, f"step {step}")


def _compare_states(p_state, j_state, where):
    for f in dataclasses.fields(p_state):
        got = getattr(p_state, f.name).numpy()
        want = np.asarray(getattr(j_state, f.name))
        if got.dtype == np.int64:
            np.testing.assert_array_equal(got, want.astype(np.int64),
                                          err_msg=f"{where}: {f.name}")
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{where}: {f.name}")


@pytest.fixture(scope="module")
def pool():
    """The JAX rollout's packed spawn pool for the test town (3 agents)."""
    return j_pool(JParams(n_agents=3), J_TOWN)


def test_spawn_pool_pick_matches(pool):
    params = JParams(n_agents=3)
    states = jax.vmap(lambda k: j_world.reset_env(params, J_TOWN, k))(
        jax.random.split(jax.random.PRNGKey(4), 6))
    states = states.replace(t=jnp.arange(6, dtype=jnp.int32) * 37)
    want = jax.vmap(lambda s: j_world.pick_fresh_packed(*pool, s))(states)
    got = p_world.pick_fresh_packed(convert.spawn_pool_from_jax(pool),
                                    p_world.SimParams(n_agents=3),
                                    convert.world_state_from_jax(states))
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                      np.asarray(getattr(want, f.name)), err_msg=f.name)


def test_own_resets_and_pool_roundtrip():
    """The port draws its own resets from a torch.Generator: check their
    distribution contract and that packing/picking returns them exactly."""
    params = p_world.SimParams(n_agents=5)
    st = p_world.reset_env(params, P_TOWN, torch.Generator().manual_seed(0), 64)
    total = P_TOWN.route_total
    assert ((st.ego_s >= 0) & (st.ego_s < total[st.ego_route])).all()
    frac = st.agents_s / total[st.agents_route]
    lane = torch.arange(5, dtype=torch.float32)
    assert ((frac * 5 >= lane - 1e-4) & (frac * 5 < lane + 1 + 1e-4)).all()
    assert ((st.rng >= 0) & (st.rng < 2 ** 32)).all() and (st.t == 0).all()
    assert len(set(st.ego_route.tolist())) > 1
    packed = p_world.pack_spawn_pool(st)
    probe = st.replace(rng=torch.zeros_like(st.rng),
                       t=torch.arange(64, dtype=torch.int64))
    back = p_world.pick_fresh_packed(packed, params, probe)
    for f in dataclasses.fields(st):
        torch.testing.assert_close(getattr(back, f.name), getattr(st, f.name),
                                   rtol=0, atol=0)


def test_expert_steps_match(pool):
    """Inject a JAX fleet state and the JAX spawn pool, run 20 expert steps
    in both packages. Two envs start close to the episode limit, so the
    auto-reset path (pool pick + select) runs inside the window."""
    j_params = JParams(n_agents=3)
    p_params = p_world.SimParams(n_agents=3)
    states = jax.vmap(lambda k: j_world.reset_env(j_params, J_TOWN, k))(
        jax.random.split(jax.random.PRNGKey(11), 4))
    states = states.replace(t=jnp.asarray([0, 394, 0, 387], jnp.int32))

    @jax.jit
    def j_step(s):
        ctrl = jax.vmap(lambda x: j_world.autopilot_control(j_params, J_TOWN, x))(s)
        fresh = jax.vmap(lambda x: j_world.pick_fresh_packed(*pool, x))(s)
        new, info = jax.vmap(lambda x, c, f: j_world.step_env(j_params, J_TOWN, x, c, f))(
            s, ctrl, fresh)
        extra = (jax.vmap(lambda x: j_world.sensor_vector(j_params, x))(s),
                 jax.vmap(lambda x: j_world.navigation_command(j_params, J_TOWN, x))(s),
                 jax.vmap(lambda x: j_world.traffic_light_state(j_params, J_TOWN, x))(s))
        return new, info, ctrl, extra

    p_pool = convert.spawn_pool_from_jax(pool)
    p_state = convert.world_state_from_jax(states)
    resets = 0
    for step in range(20):
        j_new, j_info, j_ctrl, (j_sens, j_cmd, j_light) = j_step(states)
        ctrl = p_world.autopilot_control(p_params, P_TOWN, p_state)
        for name in ("steer", "throttle", "brake"):
            np.testing.assert_allclose(getattr(ctrl, name).numpy(),
                                       np.asarray(getattr(j_ctrl, name)),
                                       rtol=RTOL, atol=ATOL, err_msg=f"step {step}: {name}")
        np.testing.assert_allclose(p_world.sensor_vector(p_params, p_state).numpy(),
                                   np.asarray(j_sens), rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(
            p_world.navigation_command(p_params, P_TOWN, p_state).numpy(), np.asarray(j_cmd))
        np.testing.assert_array_equal(
            p_world.traffic_light_state(p_params, P_TOWN, p_state).numpy(), np.asarray(j_light))
        fresh = p_world.pick_fresh_packed(p_pool, p_params, p_state)
        p_state, info = p_world.step_env(p_params, P_TOWN, p_state, ctrl, fresh)
        for key in ("done", "collision", "offroad", "timeout", "red_light", "ran_red"):
            np.testing.assert_array_equal(info[key].numpy(), np.asarray(j_info[key]),
                                          err_msg=f"step {step}: {key}")
        states = j_new
        _compare_states(p_state, states, f"step {step}")
        resets += int(np.asarray(j_info["done"]).sum())
    assert resets >= 2
