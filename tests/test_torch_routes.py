"""Goal-directed driving (A→B routes) of the PyTorch port vs the JAX
package, on a 2 × 2-block, 2-lane super-block town with turn fans and
the JAX planner's tables for 3 goals (converted with
``convert.town_from_jax``):

- ``_apply_route_transfers`` on JAX fleet states with mixed goals (−1 and
  ≥ 0), with ``turn_period`` 0 (the planner's transfers alone) and 3 (the
  random re-roll beside them, agents turning too);
- ``step_env``'s ``arrived`` / ``done`` and its unreachable end on states
  placed at a goal, on a node with no path and on a prescribed turn;
- a 3-env goal-directed expert rollout step by step (integer state equal,
  floats at rtol 1e-5 / atol 1e-4, the ``tests/test_torch_sim.py``
  tolerances), with an arrival, an unreachable respawn and a planner
  transfer inside the window;
- ``evaluate_routes`` of the expert from the JAX init carry and spawn pool:
  the same counts, rates at rtol 1e-5;
- free roam unchanged bit for bit on a town that carries the tables."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import carla_imitation_learning_tpu.ops.raster_fast as j_raster_fast
from carla_imitation_learning_tpu.render.pipeline import RenderConfig as JRender
from carla_imitation_learning_tpu.sim import SimParams as JParams
from carla_imitation_learning_tpu.sim import make_town as j_make_town
from carla_imitation_learning_tpu.sim import planner as j_planner
from carla_imitation_learning_tpu.sim import world as j_world
from carla_imitation_learning_tpu.sim.town import route_point as j_route_point
from carla_imitation_learning_tpu.training import closed_loop as j_loop
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig as PRender
from carla_imitation_learning_tpu_torch.sim import world as p_world
from carla_imitation_learning_tpu_torch.training import closed_loop as p_loop
from test_torch_turn_fans import _compare_states, fleet_and_pool

TOWN_KW = dict(blocks=2, n_buildings=6, n_lights=2, superblocks=True, turn_fans=True,
               lanes_per_direction=2)
J_TOWN = j_planner.plan_to_goals(j_make_town(**TOWN_KW),
                                 j_planner.sample_goals(j_make_town(**TOWN_KW), 5, 3))
P_TOWN = convert.town_from_jax(J_TOWN)
SLOT = np.asarray(J_TOWN.nav_slot)
DIST = np.asarray(J_TOWN.nav_dist)
GOALS = np.asarray(J_TOWN.nav_goals)


def _place(states, b: int, route: int, s: float):
    """Env ``b`` of a JAX fleet put at arclength ``s`` of ``route``, at rest."""
    pos, yaw = j_route_point(J_TOWN, jnp.int32(route), jnp.float32(s))
    return states.replace(
        ego_route=states.ego_route.at[b].set(route), ego_s=states.ego_s.at[b].set(s),
        ego_pos=states.ego_pos.at[b].set(pos), ego_yaw=states.ego_yaw.at[b].set(yaw),
        ego_v=states.ego_v.at[b].set(0.0))


def _node_s(route: int, p: int, frac: float = 0.3) -> float:
    arclen = np.asarray(J_TOWN.route_arclen)[route]
    total = float(np.asarray(J_TOWN.route_total)[route])
    nxt = arclen[p + 1] if p + 1 < len(arclen) else total
    return float(arclen[p] + frac * (nxt - arclen[p]))


def _prescribed(g: int, skip: int = 0):
    """(route, point) of a node where goal g's table prescribes a turn."""
    r, p = np.nonzero(SLOT[g] >= 0)
    return int(r[skip]), int(p[skip])


def _unreachable(g: int):
    r, p = np.nonzero(~np.isfinite(DIST[g]))
    return int(r[0]), int(p[0])


def test_tables_route_and_strand():
    """The test town has prescribed turns and unreachable nodes for every
    goal, so the cases below exercise both."""
    for g in range(3):
        assert (SLOT[g] >= 0).sum() > 3 and (~np.isfinite(DIST[g])).any()


@pytest.mark.parametrize("turn_period,agent_turn_prob", [(0, 0.0), (3, 0.3)])
def test_route_transfers_with_goals(turn_period, agent_turn_prob):
    """48 envs, goals −1, 0, 1, 2 in turn, at steps 0, 1, 2, ...; every
    fourth env placed on a node with a prescribed turn for its goal. With
    ``turn_period`` 0 only the goal-directed egos may transfer."""
    kw = dict(n_agents=4, turn_period=turn_period, agent_turn_prob=agent_turn_prob)
    j_params, p_params = JParams(**kw), p_world.SimParams(**kw)
    n = 48
    states = jax.jit(jax.vmap(lambda k: j_world.reset_env(j_params, J_TOWN, k)))(
        jax.random.split(jax.random.PRNGKey(4), n))
    goal = np.arange(n) % 4 - 1
    states = states.replace(goal=jnp.asarray(goal, jnp.int32),
                            t=jnp.arange(n, dtype=jnp.int32))
    for b in range(1, n, 4):
        r, p = _prescribed(goal[b], skip=b // 4)
        states = _place(states, b, r, _node_s(r, p))
    mid = states.replace(t=states.t + 1)
    want = jax.jit(jax.vmap(
        lambda s, m: j_world._apply_route_transfers(j_params, J_TOWN, s, m)))(states, mid)
    got = p_world._apply_route_transfers(p_params, P_TOWN, convert.world_state_from_jax(states),
                                         convert.world_state_from_jax(mid))
    _compare_states(got, want, "transfers")
    moved = (got.ego_route != convert.world_state_from_jax(mid).ego_route).numpy()
    assert moved[goal >= 0].any()
    if turn_period == 0:
        assert not moved[goal < 0].any()


def test_step_env_arrival_and_unreachable():
    """Envs at their goal point (arrive), on a node with no path to their
    goal (end at once), on a prescribed turn, and free roaming: the step's
    flags and the whole new state equal JAX's; arrived and unreachable envs
    reset with their goals kept."""
    j_params = JParams(n_agents=3)
    p_params = p_world.SimParams(n_agents=3)
    states, pool = fleet_and_pool(j_params, J_TOWN, 6)
    goal = np.array([0, 1, 2, 2, -1, 1])
    states = states.replace(goal=jnp.asarray(goal, jnp.int32))
    for b in (0, 1):
        r, p = j_planner.nearest_node(J_TOWN, GOALS[goal[b]])
        states = _place(states, b, r, _node_s(r, p, 0.0))
    r, p = _unreachable(2)
    states = _place(states, 2, r, _node_s(r, p))
    r, p = _prescribed(2)
    states = _place(states, 3, r, _node_s(r, p))

    @jax.jit
    def j_step(s):
        ctrl = jax.vmap(lambda x: j_world.autopilot_control(j_params, J_TOWN, x))(s)
        fresh = jax.vmap(lambda x: j_world.pick_fresh_packed(*pool, x))(s)
        return jax.vmap(lambda x, c, f: j_world.step_env(j_params, J_TOWN, x, c, f))(
            s, ctrl, fresh)

    new_j, info_j = j_step(states)
    p_state = convert.world_state_from_jax(states)
    ctrl = p_world.autopilot_control(p_params, P_TOWN, p_state)
    fresh = p_world.pick_fresh_packed(convert.spawn_pool_from_jax(pool), p_params, p_state)
    new_p, info_p = p_world.step_env(p_params, P_TOWN, p_state, ctrl, fresh)
    for key in ("arrived", "done", "collision", "offroad", "timeout"):
        np.testing.assert_array_equal(info_p[key].numpy(), np.asarray(info_j[key]), err_msg=key)
    _compare_states(new_p, new_j, "step")
    arrived, done = info_p["arrived"].numpy(), info_p["done"].numpy()
    assert arrived[:2].all() and not arrived[2:].any()
    assert done[:3].all() and not (info_p["collision"] | info_p["offroad"]
                                   | info_p["timeout"])[2].item()
    np.testing.assert_array_equal(new_p.goal.numpy(), goal)


def test_goal_directed_expert_rollout():
    """3 envs × 16 expert steps from one JAX fleet and pool: env 0 on a
    prescribed turn of goal 0, env 1 3 m short of goal 1's point, env 2 on
    a node with no path to goal 2. Controls, commands, flags and the whole
    state compared every step."""
    kw = dict(n_agents=4, lane_change_period=160)
    j_params, p_params = JParams(**kw), p_world.SimParams(**kw)
    states, pool = fleet_and_pool(j_params, J_TOWN, 3)
    states = states.replace(goal=jnp.asarray([0, 1, 2], jnp.int32))
    r, p = _prescribed(0)
    states = _place(states, 0, r, _node_s(r, p))
    r, p = j_planner.nearest_node(J_TOWN, GOALS[1])
    states = _place(states, 1, r, max(_node_s(r, p, 0.0) - 3.0, 0.0))
    r, p = _unreachable(2)
    states = _place(states, 2, r, _node_s(r, p))

    @jax.jit
    def j_step(s):
        ctrl = jax.vmap(lambda x: j_world.autopilot_control(j_params, J_TOWN, x))(s)
        fresh = jax.vmap(lambda x: j_world.pick_fresh_packed(*pool, x))(s)
        new, info = jax.vmap(lambda x, c, f: j_world.step_env(j_params, J_TOWN, x, c, f))(
            s, ctrl, fresh)
        cmd = jax.vmap(lambda x: j_world.navigation_command(j_params, J_TOWN, x))(s)
        return new, info, ctrl, cmd

    p_pool = convert.spawn_pool_from_jax(pool)
    p_state = convert.world_state_from_jax(states)
    transfers = arrivals = 0
    for step in range(16):
        states, j_info, j_ctrl, j_cmd = j_step(states)
        ctrl = p_world.autopilot_control(p_params, P_TOWN, p_state)
        for name in ("steer", "throttle", "brake"):
            np.testing.assert_allclose(getattr(ctrl, name).numpy(),
                                       np.asarray(getattr(j_ctrl, name)),
                                       rtol=1e-5, atol=1e-4, err_msg=f"step {step}: {name}")
        np.testing.assert_array_equal(
            p_world.navigation_command(p_params, P_TOWN, p_state).numpy(), np.asarray(j_cmd))
        fresh = p_world.pick_fresh_packed(p_pool, p_params, p_state)
        new, info = p_world.step_env(p_params, P_TOWN, p_state, ctrl, fresh)
        for key in ("done", "arrived", "collision", "offroad"):
            np.testing.assert_array_equal(info[key].numpy(), np.asarray(j_info[key]),
                                          err_msg=f"step {step}: {key}")
        transfers += int(((new.ego_route != p_state.ego_route) & ~info["done"]).sum())
        arrivals += int(info["arrived"].sum())
        p_state = new
        _compare_states(p_state, states, f"step {step}")
    assert transfers > 0 and arrivals > 0


@pytest.fixture(scope="module")
def jax_routes():
    """The JAX package's ``evaluate_routes`` of the expert, 6 envs × 40
    steps (blank frames: the expert does not read them), with the init
    carry it ran from — env 0 at its goal, env 2 on a node with no path to
    its goal, env 4 near the episode limit — and its spawn pool."""
    params = JParams(n_agents=3, episode_len=30)
    rcfg = JRender(height=32, width=32, max_triangles=256, backend="pallas")
    seen = {}
    make = j_loop.make_rollout

    def recording(*a, **k):
        init_fn, rollout_fn = make(*a, **k)

        def init(rng, n):
            states, framebuf, just_reset = init_fn(rng, n)
            r, p = j_planner.nearest_node(J_TOWN, GOALS[0])
            states = _place(states, 0, r, _node_s(r, p, 0.0))
            r, p = _unreachable(2)
            states = _place(states, 2, r, _node_s(r, p))
            states = states.replace(t=states.t.at[4].set(params.episode_len - 5))
            seen["carry"] = (states, framebuf, just_reset)
            return seen["carry"]

        return init, rollout_fn

    def jitted_pool(params, town):
        rows = jax.jit(lambda tw: j_world.make_spawn_pool(
            params, tw, jax.random.PRNGKey(0x5EED), 1024))(town)
        seen["pool"] = j_world.pack_spawn_pool(rows)
        return seen["pool"]

    def blank(setup, height, width, **kw):
        return jnp.zeros((height, width), jnp.float32)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_raster_fast, "rasterize_luma_fast", blank)
        mp.setattr(j_loop, "make_rollout", recording)
        mp.setattr(j_loop, "rollout_spawn_pool", jitted_pool)
        want = j_loop.evaluate_routes(params, J_TOWN, rcfg, None, jax.random.PRNGKey(9),
                                      n_envs=6, n_steps=40)
    return seen, want


def test_evaluate_routes_matches_jax(jax_routes, monkeypatch):
    seen, want = jax_routes
    params = p_world.SimParams(n_agents=3, episode_len=30)
    make = p_loop.make_rollout

    def from_jax_carry(*a, **k):
        _, rollout_fn = make(*a, **k)
        return (lambda gen, n: convert.carry_from_jax(seen["carry"])), rollout_fn

    monkeypatch.setattr(p_loop, "make_rollout", from_jax_carry)
    got = p_loop.evaluate_routes(params, P_TOWN, PRender(height=32, width=32, max_triangles=256),
                                 None, torch.Generator().manual_seed(0), n_envs=6, n_steps=40,
                                 spawn_pool=convert.spawn_pool_from_jax(seen["pool"]),
                                 device="cpu")
    assert got.keys() == want.keys()
    for k, w in want.items():
        if w is None or isinstance(w, int):
            assert got[k] == w, k
        else:
            np.testing.assert_allclose(got[k], w, rtol=1e-5, err_msg=k)
    assert got["arrivals"] >= 1 and got["timeouts"] >= 1
    assert got["attempts"] == got["arrivals"] + got["crashes"] + got["timeouts"]


def test_evaluate_routes_needs_tables():
    town = convert.town_from_jax(j_make_town(blocks=2, n_buildings=6, n_lights=2))
    with pytest.raises(ValueError, match="nav tables"):
        p_loop.evaluate_routes(p_world.SimParams(n_agents=2), town, PRender(height=32, width=32),
                               None, torch.Generator(), n_envs=2, n_steps=2, device="cpu")


def test_free_roam_unchanged_by_tables():
    """Goal −1 everywhere: 12 steps with ego turn re-rolls and agent turns
    on the town with tables equal the same steps on it without, bit for
    bit (states and every flag)."""
    params = p_world.SimParams(n_agents=4, turn_period=3, agent_turn_prob=0.3)
    bare = dataclasses.replace(P_TOWN, nav_slot=None, nav_dist=None, nav_goals=None)
    pool = p_loop.rollout_spawn_pool(params, bare)
    a = b = p_world.reset_env(params, bare, torch.Generator().manual_seed(2), 8)
    changed = 0
    for _ in range(12):
        ctrl = p_world.autopilot_control(params, bare, a)
        na, ia = p_world.step_env(params, P_TOWN, a, ctrl,
                                  p_world.pick_fresh_packed(pool, params, a))
        nb, ib = p_world.step_env(params, bare, b, ctrl,
                                  p_world.pick_fresh_packed(pool, params, b))
        for f in dataclasses.fields(na):
            assert torch.equal(getattr(na, f.name), getattr(nb, f.name)), f.name
        for k in ia:
            assert torch.equal(ia[k], ib[k]), k
        changed += int((na.ego_route != a.ego_route).sum())
        a, b = na, nb
    assert changed > 0
