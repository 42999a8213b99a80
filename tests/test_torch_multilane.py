"""Multi-lane towns of the PyTorch port vs the JAX package: agent lane
changes (overtaking, the drift back right with double the gap, the
perimeter's flipped lane sense, and each veto: a blocked target lane, the
lower-index rival, the ego at the landing point, a junction), the ego's
scripted lane change with its junction and occupancy gates, commands 4
and 5, the legacy circle collisions, and a multi-lane expert rollout with a
reset inside the window. Integer state equal, floats at rtol 1e-5 / atol
1e-4 (the ``tests/test_torch_sim.py`` tolerances)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_imitation_learning_tpu.sim import SimParams as JParams
from carla_imitation_learning_tpu.sim import agents as j_agents
from carla_imitation_learning_tpu.sim import make_town as j_make_town
from carla_imitation_learning_tpu.sim import world as j_world
from carla_imitation_learning_tpu.sim.town import route_point as j_route_point
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch.sim import agents as p_agents
from carla_imitation_learning_tpu_torch.sim import collision as p_col
from carla_imitation_learning_tpu_torch.sim import world as p_world
from test_torch_turn_fans import ATOL, RTOL, _compare_states, expert_rollout_matches

# 2 × 2 blocks, 2 lanes a direction: route r is lane r % 2 of cell r // 2;
# cells 0-3 are the blocks (inward offset, lane 1 is the vehicle's left) and
# cell 4 the perimeter (outward offset, lane 0 is the vehicle's left)
TOWN = j_make_town(blocks=2, n_buildings=6, n_lights=2, lanes_per_direction=2)
P_TOWN = convert.town_from_jax(TOWN)
SUPER = j_make_town(blocks=2, n_buildings=6, n_lights=2, lanes_per_direction=2,
                    superblocks=True)
P_SUPER = convert.town_from_jax(SUPER)
PARKED = [(6, 100.0), (6, 200.0)]   # agents on block 3, far from the cases
FAR_EGO = (40.0, 120.0)

# (name, [(route, s) of agents 0..3], ego position, agent 0's route after)
# block 0's bottom edge runs +x at y = 1.75 (lane 0, s = x − 1.75) and
# y = 5.25 (lane 1, s = x − 5.25); the perimeter's at y = −5.25 (lane 1,
# s = x + 5.25); junctions sit on the 80 m grid
AGENT_CASES = [
    ("overtake", [(0, 30.0), (0, 35.0)] + PARKED, FAR_EGO, 1),
    ("blocked_target", [(0, 30.0), (0, 35.0), (1, 27.0), PARKED[0]], FAR_EGO, 0),
    ("rival", [(0, 30.0), (0, 35.0), (0, 40.0), PARKED[0]], FAR_EGO, 1),
    ("ego_at_landing", [(0, 30.0), (0, 35.0)] + PARKED, (32.5, 5.25), 0),
    ("junction", [(0, 4.0), (0, 9.0)] + PARKED, FAR_EGO, 0),
    ("back_right_near", [(1, 30.0), (0, 45.0)] + PARKED, FAR_EGO, 1),
    ("back_right_free", [(1, 30.0), (0, 53.0)] + PARKED, FAR_EGO, 0),
    ("perimeter", [(9, 45.25), (9, 50.25)] + PARKED, FAR_EGO, 8),
]


def test_agent_lane_changes_match():
    routes = np.asarray([[r for r, _ in c[1]] for c in AGENT_CASES], np.int32)
    s = np.asarray([[x for _, x in c[1]] for c in AGENT_CASES], np.float32)
    v = np.full(s.shape, 3.5, np.float32)
    ego = np.asarray([c[2] for c in AGENT_CASES], np.float32)
    phases = np.zeros((len(AGENT_CASES), TOWN.lights_pos.shape[0]), np.int32)   # all green
    want = jax.jit(jax.vmap(lambda r, ss, vv, ph, e: j_agents.step_agents(
        TOWN, r, ss, vv, ph, dt=0.05, target_speed=7.0, ego_pos=e)))(routes, s, v, phases, ego)
    got = p_agents.step_agents(
        P_TOWN, torch.as_tensor(routes, dtype=torch.int64), torch.as_tensor(s),
        torch.as_tensor(v), torch.as_tensor(phases, dtype=torch.int64), dt=0.05,
        target_speed=7.0, ego_pos=torch.as_tensor(ego))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]).astype(np.int64))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
    after = {c[0]: int(r) for c, r in zip(AGENT_CASES, got[0][:, 0])}
    assert after == {c[0]: c[3] for c in AGENT_CASES}
    rival = AGENT_CASES.index(next(c for c in AGENT_CASES if c[0] == "rival"))
    assert got[0][rival, 1] == 0  # the higher-index rival waits


def test_lane_changes_off_keeps_routes():
    """``lane_changes=False`` keeps every route on a multi-lane town, the
    blocked agent of the overtake case included."""
    routes = torch.as_tensor([[0, 0, 6, 6]])
    s = torch.as_tensor([[30.0, 35.0, 100.0, 200.0]])
    out = p_agents.step_agents(P_TOWN, routes, s, torch.full_like(s, 3.5),
                               torch.zeros((1, 2), dtype=torch.int64), dt=0.05,
                               target_speed=7.0, lane_changes=False)
    assert torch.equal(out[0], routes)


LANE_KW = dict(n_agents=2, lane_change_period=6, lane_change_window=4)


@pytest.fixture(scope="module")
def resets():
    """48 JAX resets on the super-block town (2 agents, no walkers)."""
    return jax.jit(jax.vmap(lambda k: j_world.reset_env(JParams(**LANE_KW), SUPER, k)))(
        jax.random.split(jax.random.PRNGKey(2), 48))


def _placed_states(resets, placements, t):
    """JAX states (one env per placement) with the ego at (route, s) and the
    agents at their (route, s) pairs."""
    n = len(placements)
    st = jax.tree_util.tree_map(lambda a: a[:n], resets)
    ego_r = jnp.asarray([p[0][0] for p in placements], jnp.int32)
    ego_s = jnp.asarray([p[0][1] for p in placements], jnp.float32)
    pos, yaw = jax.vmap(lambda r, x: j_route_point(SUPER, r, x))(ego_r, ego_s)
    return st.replace(
        ego_route=ego_r, ego_s=ego_s, ego_pos=pos, ego_yaw=yaw,
        agents_route=jnp.asarray([[r for r, _ in p[1]] for p in placements], jnp.int32),
        agents_s=jnp.asarray([[x for _, x in p[1]] for p in placements], jnp.float32),
        t=jnp.asarray(t, jnp.int32))


def test_ego_lane_change_matches(resets):
    """At the switch phase (t % 6 == 3): a free change (block loop: to lane
    1, command 4), a change vetoed by a junction, one vetoed by an agent on
    the target lane within 10 m, and a perimeter change (lane 1 to lane 0,
    the vehicle's left there)."""
    j_params, p_params = JParams(**LANE_KW), p_world.SimParams(**LANE_KW)
    placements = [((0, 30.0), PARKED), ((0, 4.0), PARKED),
                  ((0, 30.0), [(1, 27.0), PARKED[0]]), ((19, 45.25), PARKED)]
    prev = _placed_states(resets, placements, [3, 3, 9, 15])
    mid = prev.replace(t=prev.t + 1)
    want = jax.jit(jax.vmap(lambda a, b: j_world._apply_ego_lane_change(
        j_params, SUPER, a, b)))(prev, mid)
    p_prev = convert.world_state_from_jax(prev)
    got = p_world._apply_ego_lane_change(p_params, P_SUPER, p_prev,
                                         convert.world_state_from_jax(mid))
    _compare_states(got, want, "lane change")
    assert got.ego_route.tolist() == [1, 0, 0, 18]
    target, cmd = p_world.ego_lane_change_plan(p_params, P_SUPER, p_prev)
    assert target.tolist() == [1, 1, 1, 18] and cmd.tolist() == [4, 4, 4, 4]


def test_navigation_commands_4_and_5_match(resets):
    """Commands over two periods on both lanes of a block loop and of the
    perimeter: 4 / 5 inside the window around the switch, the turn
    commands outside it."""
    j_params, p_params = JParams(**LANE_KW), p_world.SimParams(**LANE_KW)
    egos = [(0, 30.0), (1, 70.0), (18, 45.25), (19, 150.0)]
    placements = [(e, PARKED) for e in egos for _ in range(12)]
    states = _placed_states(resets, placements, list(range(12)) * len(egos))
    want = jax.jit(jax.vmap(lambda x: j_world.navigation_command(j_params, SUPER, x)))(states)
    got = p_world.navigation_command(p_params, P_SUPER, convert.world_state_from_jax(states))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    assert {4, 5} <= set(got.tolist())
    assert (got.view(len(egos), 12)[:, [0, 6]] < 4).all()  # outside the window


def test_circle_collision_matches():
    """``collision_model="circle"``: the ego a metre from an agent, touching a
    building, beside a walker, and in the clear, braking in place."""
    radius = 2.2
    kw = dict(n_agents=2, n_pedestrians=2, collision_model="circle", collision_radius=radius)
    j_params, p_params = JParams(**kw), p_world.SimParams(**kw)
    st = jax.jit(jax.vmap(lambda k: j_world.reset_env(j_params, SUPER, k)))(
        jax.random.split(jax.random.PRNGKey(4), 4))
    agents_pos, _ = jax.vmap(lambda r, s: j_agents.agent_positions(SUPER, r, s))(
        st.agents_route, st.agents_s)
    from carla_imitation_learning_tpu.sim.pedestrians import ped_positions
    peds = jax.vmap(lambda c, s: ped_positions(SUPER, c, s))(st.peds_crossing, st.peds_s)
    b = np.asarray(SUPER.buildings[0])
    ego = jnp.stack([agents_pos[0, 0] + jnp.asarray([1.0, 0.0]),
                     jnp.asarray([b[0] + b[2] + 0.5 * radius, b[1]]),
                     peds[2, 0] + jnp.asarray([0.5, 0.0]),
                     jnp.asarray([40.0, 400.0])])
    st = st.replace(ego_pos=ego, agents_s=st.agents_s.at[3].set(0.0))
    ctrl = j_world.VehicleControl(steer=jnp.zeros(4), throttle=jnp.zeros(4),
                                  brake=jnp.ones(4))
    _, j_info = jax.jit(jax.vmap(lambda x, c: j_world.step_env(j_params, SUPER, x, c, x)))(
        st, ctrl)
    p_state = convert.world_state_from_jax(st)
    _, info = p_world.step_env(p_params, P_SUPER, p_state,
                               p_world.VehicleControl(torch.zeros(4), torch.zeros(4),
                                                      torch.ones(4)), p_state)
    for key in ("collision", "pedestrian", "done"):
        np.testing.assert_array_equal(info[key].numpy(), np.asarray(j_info[key]), err_msg=key)
    assert info["collision"][:3].all() and info["pedestrian"][2]
    a, p2 = torch.zeros(1, 2), torch.as_tensor([[[2.0, 2.0], [4.0, 4.0]]])
    assert p_col.circle_circle(a, 2.0, p2, 3.0).tolist() == [[True, False]]


def test_expert_rollout_on_multilane_town():
    """3 envs × 12 expert steps on the ``multilane`` town (super-blocks, two
    lanes) with scripted ego lane changes every 6 steps and agent
    overtakes; env 1 resets inside the window."""
    kw = dict(n_agents=6, lane_change_period=6, lane_change_window=4)
    counts = expert_rollout_matches(JParams(**kw), p_world.SimParams(**kw), SUPER)
    assert counts["ego"] > 0 and counts["resets"] >= 1
