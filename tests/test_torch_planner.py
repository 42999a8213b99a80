"""The route planner of the PyTorch port vs the JAX package's
``sim/planner.py``: ``sample_goals`` and the baked ``nav_slot``,
``nav_dist`` (inf included) and ``nav_goals`` tables equal entry for entry
on 2 × 2-block super-block towns with turn fans at 1 and 2 lanes, built by
each package itself; ``mirror_town`` equal field for field;
``convert.town_from_jax`` carrying the tables; the lane-aware default goal
tolerance."""

import dataclasses

import numpy as np
import pytest
import torch

from carla_imitation_learning_tpu.sim import make_town as j_make_town
from carla_imitation_learning_tpu.sim import planner as j_planner
from carla_imitation_learning_tpu.sim.town import mirror_town as j_mirror
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch.sim import planner as p_planner
from carla_imitation_learning_tpu_torch.sim.town import make_town as p_make_town
from carla_imitation_learning_tpu_torch.sim.town import mirror_town as p_mirror

TOWN_KW = dict(blocks=2, n_buildings=6, n_lights=2, superblocks=True, turn_fans=True)
NAV = ("nav_slot", "nav_dist", "nav_goals")
N_GOALS = 3


@pytest.fixture(scope="module")
def planned():
    """lanes → (JAX town with tables, port town with tables, JAX goals,
    port goals), each package sampling and planning on its own town."""
    out = {}
    for lanes in (1, 2):
        j_town = j_make_town(**TOWN_KW, lanes_per_direction=lanes)
        p_town = p_make_town(**TOWN_KW, lanes_per_direction=lanes)
        j_goals = j_planner.sample_goals(j_town, 5, N_GOALS)
        p_goals = p_planner.sample_goals(p_town, 5, N_GOALS)
        out[lanes] = (j_planner.plan_to_goals(j_town, j_goals),
                      p_planner.plan_to_goals(p_town, p_goals), j_goals, p_goals)
    return out


@pytest.mark.parametrize("lanes", [1, 2])
def test_sample_goals_equal(planned, lanes):
    _, _, j_goals, p_goals = planned[lanes]
    assert p_goals.dtype == np.float32 and p_goals.shape == (N_GOALS, 2)
    np.testing.assert_array_equal(p_goals, j_goals)
    # a numpy Generator as the seed draws the same goals as its int
    p_town = planned[lanes][1]
    np.testing.assert_array_equal(
        p_planner.sample_goals(p_town, np.random.default_rng(5), N_GOALS), p_goals)


@pytest.mark.parametrize("lanes", [1, 2])
def test_nav_tables_equal(planned, lanes):
    j_town, p_town, _, _ = planned[lanes]
    for name in NAV:
        got, want = getattr(p_town, name).numpy(), np.asarray(getattr(j_town, name))
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=name)
    assert p_town.nav_slot.dtype == torch.int64
    assert p_town.nav_dist.dtype == torch.float32
    dist = p_town.nav_dist.numpy()
    # the tables route somewhere: prescribed transfers, finite distances,
    # and (the perimeter shares no lane line with the fans) unreachable nodes
    assert (p_town.nav_slot.numpy() >= 0).any()
    assert np.isfinite(dist).mean() > 0.5 and np.isinf(dist).any()
    assert (dist[np.isfinite(dist)] >= 0).all()


def test_planner_helpers_equal(planned):
    j_town, p_town, j_goals, _ = planned[2]
    for xy in ([10.0, 3.0], [-7.5, 81.0], [160.0, 160.0]):
        assert p_planner.nearest_node(p_town, xy) == j_planner.nearest_node(j_town, xy)
    j_rev, R, P = j_planner._reverse_adjacency(j_town)
    p_rev, R2, P2 = p_planner._reverse_adjacency(p_town)
    assert (R, P) == (R2, P2) and p_rev == j_rev
    j_dist, j_slot = j_planner._dijkstra_to(j_town, j_goals[0], goal_tol=2.0)
    p_dist, p_slot = p_planner._dijkstra_to(p_town, j_goals[0], goal_tol=2.0)
    np.testing.assert_array_equal(p_dist, j_dist)
    np.testing.assert_array_equal(p_slot, j_slot)
    j_planner._widen_back(j_town, j_slot)
    p_planner._widen_back(p_town, p_slot)
    np.testing.assert_array_equal(p_slot, j_slot)


def test_goal_tolerance_is_lane_aware(planned):
    """The default tolerance is 2.0 + lane_width · (lanes − 1): at 2 lanes
    it equals an explicit 5.5 and reaches more nodes than a bare 2.0, as in
    the JAX package."""
    j_town, p_town, _, p_goals = planned[2]
    explicit = p_planner.plan_to_goals(p_town, p_goals, goal_tol=2.0 + 3.5)
    np.testing.assert_array_equal(explicit.nav_dist.numpy(), p_town.nav_dist.numpy())
    bare = p_planner.plan_to_goals(p_town, p_goals, goal_tol=2.0)
    j_bare = j_planner.plan_to_goals(j_town, p_goals, goal_tol=2.0)
    np.testing.assert_array_equal(bare.nav_dist.numpy(), np.asarray(j_bare.nav_dist))
    assert np.isfinite(bare.nav_dist.numpy()).sum() < np.isfinite(p_town.nav_dist.numpy()).sum()


def test_goal_setup_round_robin(planned):
    p_town = p_make_town(**TOWN_KW, lanes_per_direction=2)
    town, goals, goal_ids = p_planner.goal_setup(p_town, N_GOALS, 7, seed=5)
    np.testing.assert_array_equal(goals, planned[2][3])
    np.testing.assert_array_equal(town.nav_slot.numpy(), planned[2][1].nav_slot.numpy())
    assert goal_ids.tolist() == [0, 1, 2, 0, 1, 2, 0]
    with pytest.raises(ValueError, match="turn_fans"):
        p_planner.goal_setup(p_make_town(blocks=2, n_buildings=6, n_lights=2), 2, 4)


@pytest.mark.parametrize("lanes", [1, 2])
def test_mirror_town_equal(planned, lanes):
    j_town, p_town, _, _ = planned[lanes]
    j_m, p_m = j_mirror(j_town), p_mirror(p_town)
    for f in dataclasses.fields(p_m):
        got = getattr(p_m, f.name)
        want = getattr(j_m, f.name)
        if not isinstance(got, torch.Tensor):
            assert got == want, f.name
            continue
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(got.numpy().dtype),
                                      err_msg=f.name)
    # only x columns move, and the original is untouched
    np.testing.assert_array_equal(p_m.routes[..., 1].numpy(), p_town.routes[..., 1].numpy())
    np.testing.assert_array_equal(p_m.routes[..., 0].numpy(), -p_town.routes[..., 0].numpy())
    np.testing.assert_array_equal(p_m.road_segments[:, 1::2].numpy(),
                                  p_town.road_segments[:, 1::2].numpy())
    assert (p_town.routes[..., 0] >= -20).all()


@pytest.mark.parametrize("lanes", [1, 2])
def test_town_from_jax_carries_tables(planned, lanes):
    j_town, p_town, _, _ = planned[lanes]
    conv = convert.town_from_jax(j_town)
    for f in dataclasses.fields(conv):
        got, want = getattr(conv, f.name), getattr(p_town, f.name)
        if isinstance(got, torch.Tensor):
            assert got.dtype == want.dtype, f.name
            np.testing.assert_array_equal(got.numpy(), want.numpy(), err_msg=f.name)
        else:
            assert got == want, f.name
