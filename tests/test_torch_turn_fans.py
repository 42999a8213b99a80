"""Junction turn fans of the PyTorch port vs the JAX package: the transfer
tables of ``make_town(turn_fans=True, superblocks=True)`` equal entry for
entry at 1 and 2 lanes; ``_apply_route_transfers`` on JAX fleet states
takes the same transfers (its draws are ``jax.random``'s, bit for bit); and
a 3-env × 12-step expert rollout on a ``turns`` town agrees step by step
(integer state and commands equal, float state at rtol 1e-5 / atol 1e-4,
the ``tests/test_torch_sim.py`` tolerances)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_imitation_learning_tpu.sim import SimParams as JParams
from carla_imitation_learning_tpu.sim import make_town as j_make_town
from carla_imitation_learning_tpu.sim import world as j_world
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch.sim import world as p_world
from carla_imitation_learning_tpu_torch.sim.town import make_town as p_make_town

RTOL, ATOL = 1e-5, 1e-4
TOWN_KW = dict(blocks=2, n_buildings=6, n_lights=2, superblocks=True, turn_fans=True)
TABLES = ("transfer_route", "transfer_s", "transfer_valid")


@pytest.fixture(scope="module")
def towns():
    """JAX town and the port's own build, at 1 and 2 lanes per direction."""
    return {lanes: (j_make_town(**TOWN_KW, lanes_per_direction=lanes),
                    p_make_town(**TOWN_KW, lanes_per_direction=lanes)) for lanes in (1, 2)}


@pytest.mark.parametrize("lanes", [1, 2])
def test_transfer_tables_equal(towns, lanes):
    j_town, p_town = towns[lanes]
    for name in TABLES:
        want, got = np.asarray(getattr(j_town, name)), getattr(p_town, name)
        np.testing.assert_array_equal(got.numpy(), want.astype(got.numpy().dtype), err_msg=name)
    assert p_town.transfer_route.dtype == torch.int64
    assert p_town.transfer_valid.dtype == torch.bool
    # the fans exist: a good share of sample points offer a transfer
    assert p_town.transfer_valid.any(dim=-1).float().mean() > 0.3
    for name in TABLES:
        np.testing.assert_array_equal(getattr(convert.town_from_jax(j_town), name).numpy(),
                                      getattr(p_town, name).numpy(), err_msg=name)


def test_no_tables_without_turn_fans():
    town = p_make_town(blocks=2, n_buildings=6, n_lights=2, superblocks=True)
    assert all(getattr(town, name) is None for name in TABLES)


def fleet_and_pool(j_params, j_town, n_envs: int, pool_size: int = 16):
    """A JAX fleet of ``n_envs`` resets and a packed spawn pool of
    ``pool_size`` more, from one jitted ``reset_env``. The fleet's leaves
    are strongly typed, as a step's outputs are, so a jitted step traces
    once."""
    both = jax.jit(jax.vmap(lambda k: j_world.reset_env(j_params, j_town, k)))(
        jax.random.split(jax.random.PRNGKey(11), n_envs + pool_size))
    fleet = jax.tree_util.tree_map(lambda a: a[:n_envs].astype(a.dtype), both)
    return fleet, j_world.pack_spawn_pool(jax.tree_util.tree_map(lambda a: a[n_envs:], both))


def _compare_states(p_state, j_state, where):
    for f in dataclasses.fields(p_state):
        got = getattr(p_state, f.name).numpy()
        want = np.asarray(getattr(j_state, f.name))
        if got.dtype == np.int64:
            np.testing.assert_array_equal(got, want.astype(np.int64), err_msg=f"{where}: {f.name}")
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{where}: {f.name}")


def test_route_transfers_on_jax_states(towns):
    """``_apply_route_transfers`` from JAX states: 32 envs at steps 0, 5,
    10, ..., the ego re-rolling its turn every step and each agent taking
    a transfer with p = 0.5."""
    j_town = towns[2][0]
    p_town = convert.town_from_jax(j_town)
    kw = dict(n_agents=6, turn_period=1, agent_turn_prob=0.5)
    j_params, p_params = JParams(**kw), p_world.SimParams(**kw)
    states = jax.jit(jax.vmap(lambda k: j_world.reset_env(j_params, j_town, k)))(
        jax.random.split(jax.random.PRNGKey(3), 32))
    states = states.replace(t=jnp.arange(32, dtype=jnp.int32) * 5)
    mid = states.replace(t=states.t + 1)
    want = jax.jit(jax.vmap(
        lambda s, m: j_world._apply_route_transfers(j_params, j_town, s, m)))(states, mid)
    got = p_world._apply_route_transfers(p_params, p_town, convert.world_state_from_jax(states),
                                         convert.world_state_from_jax(mid))
    _compare_states(got, want, "transfers")
    p_mid = convert.world_state_from_jax(mid)
    assert (got.ego_route != p_mid.ego_route).any()
    assert (got.agents_route != p_mid.agents_route).any()


def expert_rollout_matches(j_params, p_params, j_town, n_steps: int = 12) -> dict:
    """3 envs × ``n_steps`` expert steps in both packages from one JAX
    fleet and spawn pool, env 1 starting 8 steps before the episode limit
    (its reset falls inside the window): controls, commands, the step's
    flags and the whole state compared every step. → counts of ego and
    agent route changes that were not resets, and of resets."""
    p_town = convert.town_from_jax(j_town)
    states, pool = fleet_and_pool(j_params, j_town, 3)
    states = states.replace(t=jnp.asarray([0, j_params.episode_len - 8, 1], jnp.int32))

    @jax.jit
    def j_step(s):
        ctrl = jax.vmap(lambda x: j_world.autopilot_control(j_params, j_town, x))(s)
        fresh = jax.vmap(lambda x: j_world.pick_fresh_packed(*pool, x))(s)
        new, info = jax.vmap(lambda x, c, f: j_world.step_env(j_params, j_town, x, c, f))(
            s, ctrl, fresh)
        cmd = jax.vmap(lambda x: j_world.navigation_command(j_params, j_town, x))(s)
        return new, info, ctrl, cmd

    p_pool = convert.spawn_pool_from_jax(pool)
    p_state = convert.world_state_from_jax(states)
    counts = {"ego": 0, "agents": 0, "resets": 0}
    for step in range(n_steps):
        states, j_info, j_ctrl, j_cmd = j_step(states)
        ctrl = p_world.autopilot_control(p_params, p_town, p_state)
        for name in ("steer", "throttle", "brake"):
            np.testing.assert_allclose(getattr(ctrl, name).numpy(),
                                       np.asarray(getattr(j_ctrl, name)),
                                       rtol=RTOL, atol=ATOL, err_msg=f"step {step}: {name}")
        np.testing.assert_array_equal(
            p_world.navigation_command(p_params, p_town, p_state).numpy(), np.asarray(j_cmd))
        fresh = p_world.pick_fresh_packed(p_pool, p_params, p_state)
        new, info = p_world.step_env(p_params, p_town, p_state, ctrl, fresh)
        for key in ("done", "collision", "offroad"):
            np.testing.assert_array_equal(info[key].numpy(), np.asarray(j_info[key]),
                                          err_msg=f"step {step}: {key}")
        kept = ~info["done"]
        counts["ego"] += int(((new.ego_route != p_state.ego_route) & kept).sum())
        counts["agents"] += int(((new.agents_route != p_state.agents_route)
                                 & kept[:, None]).sum())
        counts["resets"] += int(info["done"].sum())
        p_state = new
        _compare_states(p_state, states, f"step {step}")
    return counts


def test_expert_rollout_on_turns_town(towns):
    """3 envs × 12 expert steps with ego turn decisions every 3 steps and
    agents transferring with p = 0.3 a step (and changing lanes); env 1
    resets inside the window."""
    kw = dict(n_agents=4, turn_period=3, agent_turn_prob=0.3)
    counts = expert_rollout_matches(JParams(**kw), p_world.SimParams(**kw), towns[2][0])
    assert counts["ego"] > 0 and counts["agents"] > 0 and counts["resets"] >= 1
