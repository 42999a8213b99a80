"""The port's sim harnesses against the JAX package: ``sim_ablation``'s
eight variants, ``crash_forensics``' features and classification, and
``expert_envelope``'s stages.

The JAX side is built here from the JAX package's public sim functions,
mirroring ``benchmarks/sim_ablation.py:60-110`` and
``benchmarks/crash_forensics.py:76-118`` line for line (their steps are
nested in the harnesses' ``main``); states and spawn pools are the JAX
package's, carried across with ``convert``. Tolerances as
``tests/test_torch_sim.py``: integer state and flags equal, float state and
features allclose in fp32 (rtol 1e-5, atol 1e-4).
"""

import ast
import argparse
import dataclasses
import functools
import importlib.util
import json
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_imitation_learning_tpu.sim import SimParams as JParams
from carla_imitation_learning_tpu.sim import agents as j_agents
from carla_imitation_learning_tpu.sim import collision as j_col
from carla_imitation_learning_tpu.sim import make_town as j_make_town
from carla_imitation_learning_tpu.sim import world as j_world
from carla_imitation_learning_tpu.sim.dynamics import bicycle_step as j_bicycle
from carla_imitation_learning_tpu.sim.planner import plan_to_goals as j_plan
from carla_imitation_learning_tpu.sim.planner import sample_goals as j_goals
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch.sim import world as p_world

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-4
N_ENVS = 4


def _load(name: str):
    path = ROOT / "benchmarks_torch" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"{name}_torch_harness", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


sim_ablation = _load("sim_ablation")
crash_forensics = _load("crash_forensics")
expert_envelope = _load("expert_envelope")


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


# --- sim_ablation ---------------------------------------------------------

# the test town; 3 agents, and episodes of 6 steps so that the reset path
# (done → the pool's pick) runs inside a short run
ABL_TOWN = dict(blocks=2, n_buildings=6, n_lights=2)
ABL_KW = dict(n_agents=3, episode_len=6)
ABL_STEPS = 8


def _j_custom_step(town, pool, state, control, *, p, agents=True, nearest=True,
                   reset=True, collide=True):
    """``benchmarks/sim_ablation.py:60-110`` over the JAX package's sim."""
    phases = j_agents.light_phases(
        town, state.t.astype(jnp.float32) * p.dt,
        p.light_green, p.light_yellow, p.light_red)
    ego_pos, ego_yaw, ego_v, ego_steer = j_bicycle(
        state.ego_pos, state.ego_yaw, state.ego_v, state.ego_steer,
        jnp.clip(control.steer, -1, 1) * p.max_steer,
        jnp.clip(control.throttle, 0, 1), jnp.clip(control.brake, 0, 1),
        dt=p.dt, wheelbase=p.wheelbase,
        max_accel=p.max_accel, max_brake=p.max_brake,
        drag=p.drag, tire_stiffness=p.tire_stiffness)
    if agents:
        agents_route, agents_s, agents_v = j_agents.step_agents(
            town, state.agents_route, state.agents_s, state.agents_v,
            phases, dt=p.dt, target_speed=p.agent_target_speed)
    else:
        agents_route, agents_s, agents_v = (
            state.agents_route, state.agents_s, state.agents_v)
    if collide:
        ap_, ay_ = j_agents.agent_positions(town, agents_route, agents_s)
        if p.collision_model == "capsule":
            hit = (j_col.capsule_vehicle_collision(
                       ego_pos, ego_yaw, ap_, ay_,
                       p.vehicle_half_len, p.vehicle_radius)
                   | j_col.capsule_building_collision(
                       ego_pos, ego_yaw, p.vehicle_half_len,
                       p.vehicle_radius, town.buildings))
        else:
            hit = (j_col.any_vehicle_collision(ego_pos, ap_, p.collision_radius)
                   | j_col.any_building_collision(ego_pos, town.buildings,
                                                  p.collision_radius))
        off = j_col.offroad(ego_pos, town.road_segments, town.road_half_width)
    else:
        hit = off = jnp.zeros((), bool)
    t_new = state.t + 1
    mid = state.replace(
        ego_pos=ego_pos, ego_yaw=ego_yaw, ego_v=ego_v, ego_steer=ego_steer,
        agents_route=agents_route, agents_s=agents_s, agents_v=agents_v,
        t=t_new)
    if nearest:
        mid = mid.replace(ego_s=j_world._nearest_s_update(town, mid))
    else:
        mid = mid.replace(ego_s=mid.ego_s + ego_v * p.dt)
    if reset:
        done = hit | off | (t_new >= p.episode_len)
        fresh = j_world.pick_fresh(pool, state)
        mid = jax.tree_util.tree_map(lambda a, b: jnp.where(done, a, b), fresh, mid)
    return mid


def _j_variants(params):
    """``benchmarks/sim_ablation.py:152-164``."""
    no_env = dataclasses.replace(params, headway_gap=0.0, yield_gap=0.0)
    circle = dataclasses.replace(params, collision_model="circle")
    return {
        "full": dict(auto=True),
        "no_envelope": dict(auto=True, p=no_env),
        "circle_collision": dict(auto=True, p=circle),
        "const_control": dict(auto=False),
        "no_agents": dict(auto=True, agents=False),
        "no_nearest": dict(auto=True, nearest=False),
        "no_reset": dict(auto=True, reset=False),
        "no_collision": dict(auto=True, reset=False, collide=False),
    }


@pytest.fixture(scope="module")
def ablation_world():
    town = j_make_town(**ABL_TOWN)
    params = JParams(**ABL_KW)
    pool = jax.jit(lambda k: j_world.make_spawn_pool(params, town, k, 64))(
        jax.random.PRNGKey(0x5EED))
    states = jax.jit(jax.vmap(lambda k: j_world.reset_env(params, town, k)))(
        jax.random.split(jax.random.PRNGKey(2), N_ENVS))
    return town, params, pool, states


def test_variants_match_jax_dict():
    """The port's eight variants are the JAX harness's, in its order, with
    the same parameter overrides."""
    p_vars = sim_ablation.variants(p_world.SimParams(n_agents=15))
    j_vars = _j_variants(JParams(n_agents=15))
    assert list(p_vars) == list(j_vars)
    for name, kw in j_vars.items():
        got = dict(p_vars[name])
        want = dict(kw)
        if "p" in want:
            assert dataclasses.asdict(got.pop("p")) == dataclasses.asdict(want.pop("p")), name
        assert got == want, name


@pytest.mark.parametrize("name", list(_j_variants(JParams())))
def test_ablation_variant_matches_jax(ablation_world, name):
    """ABL_STEPS steps of one variant from one converted fleet, state by
    state, ``pick_fresh`` on the JAX pool against ``pick_fresh_packed`` on
    its packed form."""
    town, params, pool, states = ablation_world
    kw = dict(_j_variants(params)[name])
    auto, p = kw.pop("auto"), kw.pop("p", params)

    def one(s):
        control = (j_world.autopilot_control(p, town, s) if auto else
                   j_world.VehicleControl(steer=jnp.zeros(()), throttle=jnp.ones(()),
                                          brake=jnp.zeros(())))
        return _j_custom_step(town, pool, s, control, p=p, **kw)

    j_step = jax.jit(jax.vmap(one))
    p_params = p_world.SimParams(**ABL_KW)
    p_kw = dict(sim_ablation.variants(p_params)[name])
    p_town = convert.town_from_jax(town)
    packed = convert.spawn_pool_from_jax(j_world.pack_spawn_pool(pool))
    run = sim_ablation.make_runner(p_params, p_town, packed, **p_kw)
    p_state = convert.world_state_from_jax(states)
    resets = 0
    for step in range(ABL_STEPS):
        states = j_step(states)
        p_state, v = run(p_state, 1)
        assert tuple(v.shape) == (1, N_ENVS)
        _compare_states(p_state, states, f"{name} step {step}")
        resets += int(jnp.sum(states.t == 0))
    # the variants with the reset ran it (every episode times out at 6 steps)
    assert (resets >= N_ENVS) == kw.get("reset", True), resets


def test_marginal_protocol_counts_steps():
    """``marginal`` runs one warm pair, then ``reps`` pairs, and reports the
    median of Δwall / (n_big − n_small) with the state carried through."""
    calls = []

    def run(states, n):
        calls.append((states, n))
        time.sleep(n * 2e-3)
        return states + n, torch.ones(n, 2)

    per, warm = sim_ablation.marginal(run, 0, n_small=2, n_big=6, reps=2)
    assert [n for _, n in calls] == [2, 6, 2, 6, 2, 6]
    assert [s for s, _ in calls] == [0, 2, 8, 10, 16, 18]
    assert 1.5e-3 < per < 10e-3 and warm >= 16e-3


# --- crash_forensics ------------------------------------------------------

CF_TOWN = dict(blocks=2, n_buildings=6, n_lights=2, lanes_per_direction=2,
               superblocks=True, turn_fans=True, seed=0)
CF_GOALS, CF_STEPS = 2, 40
CF_PARAMS = dict(n_agents=4, episode_len=2500, lane_change_period=160)
FEATS = ("hit_v", "culprit_fwd", "culprit_lat", "culprit_changed", "in_junction", "cmd",
         "ego_v", "collision", "offroad", "done", "arrived", "timeout")


def _j_features(params, town, state):
    """``benchmarks/crash_forensics.py:76-118`` over the JAX package's sim."""
    ctrl = j_world.autopilot_control(params, town, state)
    phases = j_agents.light_phases(
        town, state.t.astype(jnp.float32) * params.dt,
        params.light_green, params.light_yellow, params.light_red)
    ego_pos, ego_yaw, _, _ = j_bicycle(
        state.ego_pos, state.ego_yaw, state.ego_v, state.ego_steer,
        jnp.clip(ctrl.steer, -1, 1) * params.max_steer,
        jnp.clip(ctrl.throttle, 0, 1), jnp.clip(ctrl.brake, 0, 1),
        dt=params.dt, wheelbase=params.wheelbase,
        max_accel=params.max_accel, max_brake=params.max_brake,
        drag=params.drag, tire_stiffness=params.tire_stiffness)
    routes_post, s_post, _ = j_agents.step_agents(
        town, state.agents_route, state.agents_s, state.agents_v, phases,
        dt=params.dt, target_speed=params.agent_target_speed,
        ego_pos=state.ego_pos)
    ap_, ay_ = j_agents.agent_positions(town, routes_post, s_post)
    hl, vr = params.vehicle_half_len, params.vehicle_radius
    he = jnp.stack([jnp.cos(ego_yaw), jnp.sin(ego_yaw)])
    ha = jnp.stack([jnp.cos(ay_), jnp.sin(ay_)], axis=-1)
    d = j_col.segment_segment_distance(
        ego_pos - hl * he, ego_pos + hl * he,
        ap_ - hl * ha, ap_ + hl * ha)
    culprit = jnp.argmin(d)
    left = jnp.stack([-he[1], he[0]])
    rel = ap_[culprit] - ego_pos
    d_junc = jnp.min(jnp.linalg.norm(town.junctions - ego_pos, axis=-1))
    junction_r = jnp.maximum(6.0, town.road_half_width * 1.8)
    new_state, info = j_world.step_env(params, town, state, ctrl)
    feats = {
        "hit_v": d[culprit] < 2.0 * vr,
        "culprit_fwd": rel @ he, "culprit_lat": rel @ left,
        "culprit_changed": routes_post[culprit] != state.agents_route[culprit],
        "in_junction": d_junc < junction_r + 2.0,
        "cmd": j_world.navigation_command(params, town, state),
        "ego_v": state.ego_v,
    }
    keep = {k: info[k] for k in ("collision", "offroad", "done", "arrived", "timeout")}
    return new_state, {**feats, **keep}


@pytest.fixture(scope="module")
def forensics_runs():
    """CF_STEPS steps of the features in both packages from one converted
    fleet → (JAX (T, B) arrays, port (T, B) arrays, live (T, B): steps up to
    and including each env's first episode end, after which the packages'
    resets differ: both draw ``reset_env``, JAX from the env's key, the
    port from a generator)."""
    town = j_plan(j_make_town(**CF_TOWN), j_goals(j_make_town(**CF_TOWN), 0, CF_GOALS))
    params = JParams(**CF_PARAMS)
    states = jax.jit(jax.vmap(lambda k: j_world.reset_env(params, town, k)))(
        jax.random.split(jax.random.PRNGKey(7), N_ENVS))
    states = states.replace(goal=jnp.arange(N_ENVS, dtype=jnp.int32) % CF_GOALS)
    j_step = jax.jit(jax.vmap(lambda s: _j_features(params, town, s)))
    p_params = p_world.SimParams(**CF_PARAMS)
    p_town = convert.town_from_jax(town)
    # fresh states serve only envs whose episode ended, which the comparison drops
    gen = torch.Generator().manual_seed(0x5EED)
    p_state = convert.world_state_from_jax(states)
    j_out, p_out = [], []
    for _ in range(CF_STEPS):
        states, jf = j_step(states)
        p_state, pf = crash_forensics.features(
            p_params, p_town, p_state, p_world.reset_env(p_params, p_town, gen, N_ENVS))
        j_out.append({k: np.asarray(v) for k, v in jf.items()})
        p_out.append({k: v.numpy() for k, v in pf.items()})
    jt = {k: np.stack([o[k] for o in j_out]) for k in FEATS}
    pt = {k: np.stack([o[k] for o in p_out]) for k in FEATS}
    ended = np.cumsum(jt["done"], axis=0) - jt["done"]
    return jt, pt, ended == 0


def test_forensics_features_match_jax(forensics_runs):
    jt, pt, live = forensics_runs
    assert live.all(axis=0).sum() >= N_ENVS // 2, "most envs must run the whole window"
    for k in FEATS:
        got, want = pt[k][live], jt[k][live]
        if want.dtype == bool or np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=k)


def test_forensics_classify_both_packages(forensics_runs):
    """``classify`` counts the same on both packages' features (steps that
    each env ran from the same state)."""
    jt, pt, live = forensics_runs
    cut = {k: np.where(live, v, np.zeros_like(v)) for k, v in jt.items()}
    cut_p = {k: np.where(live, v, np.zeros_like(v)) for k, v in pt.items()}
    want = crash_forensics.classify(cut, 0.05)
    got = crash_forensics.classify(cut_p, 0.05)
    rates = ("km", "collisions_per_km", "mean_ego_speed_at_impact")
    assert {k: v for k, v in got.items() if k not in rates} == \
        {k: v for k, v in want.items() if k not in rates}
    for k in rates:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k


def _trajectory():
    """A hand-built (T, B) trajectory with one collision of each mode, an
    off-road-only event, a collision that is also off road and an arrival."""
    T, B = 4, 3
    tr = {k: np.zeros((T, B), bool) for k in ("hit_v", "culprit_changed", "in_junction",
                                              "collision", "offroad", "arrived")}
    tr.update({k: np.zeros((T, B), np.float32) for k in ("culprit_fwd", "culprit_lat")})
    tr["cmd"] = np.zeros((T, B), np.int64)
    tr["ego_v"] = np.full((T, B), 5.0, np.float32)
    events = [  # (t, b, hit_v, changed, fwd, lat, in_junction, cmd) → mode
        ((0, 0, False, False, 0.0, 0.0, True, 1), "building"),
        ((0, 1, True, True, 3.0, 0.0, False, 2), "veh_lane_teleport"),
        ((1, 0, True, False, -1.0, 0.0, False, 0), "veh_rear_end"),
        ((1, 1, True, False, 3.0, 1.0, True, 3), "veh_frontal"),
        ((2, 0, True, False, 0.2, 2.5, True, 1), "veh_side"),
        ((2, 1, True, False, 3.0, 2.5, False, 0), "veh_side"),
        ((3, 0, True, False, float("nan"), 0.0, False, 4), "veh_other"),
    ]
    for (t, b, hit, changed, fwd, lat, in_j, cmd), _ in events:
        tr["collision"][t, b] = True
        tr["hit_v"][t, b], tr["culprit_changed"][t, b] = hit, changed
        tr["culprit_fwd"][t, b], tr["culprit_lat"][t, b] = fwd, lat
        tr["in_junction"][t, b], tr["cmd"][t, b] = in_j, cmd
        tr["ego_v"][t, b] = 2.0
    tr["offroad"][3, 1] = True          # off road alone
    tr["offroad"][0, 0] = True          # off road with a collision: not counted
    tr["arrived"][3, 2] = True
    return tr, events


def test_classify_reaches_every_mode():
    tr, events = _trajectory()
    out = crash_forensics.classify(tr, 0.05)
    want = {m: 0 for m in crash_forensics.MODES}
    for _, mode in events:
        want[mode] += 1
    assert out["modes"] == want
    assert all(out["modes"][m] > 0 for m in crash_forensics.MODES)
    assert out["collision_events"] == len(events) == sum(out["modes"].values())
    assert out["offroad_only_events"] == 1
    assert out["arrivals"] == 1
    assert out["in_junction_by_mode"] == {"building": 1, "veh_lane_teleport": 0,
                                          "veh_rear_end": 0, "veh_frontal": 1,
                                          "veh_side": 1, "veh_other": 0}
    assert out["cmd_by_mode"]["veh_side"] == {1: 1, 0: 1}
    assert out["mean_ego_speed_at_impact"] == pytest.approx(2.0)
    km = float(tr["ego_v"].astype(np.float64).sum() * 0.05 / 1e3)
    assert out["km"] == pytest.approx(km)
    assert out["collisions_per_km"] == pytest.approx(len(events) / km)


# --- expert_envelope ------------------------------------------------------

def _jax_stages(turn_speed: float) -> dict:
    """The ``stages`` dict of the JAX harness's ``main``, read from its source
    and evaluated with ``args.turn_speed``."""
    tree = ast.parse((ROOT / "benchmarks" / "expert_envelope.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name) and node.targets[0].id == "stages"):
            return eval(compile(ast.Expression(node.value), "stages", "eval"),
                        {"dict": dict, "args": argparse.Namespace(turn_speed=turn_speed)})
    raise AssertionError("no stages dict in the JAX harness")


@pytest.mark.parametrize("turn_speed", [4.0, 2.5])
def test_envelope_stages_equal_jax(turn_speed):
    assert expert_envelope.stages(turn_speed) == _jax_stages(turn_speed)
    assert list(expert_envelope.stages(turn_speed)) == list(_jax_stages(turn_speed))
    for overrides in expert_envelope.stages(turn_speed).values():
        p_world.SimParams(n_agents=15, **overrides)   # every override names a field


# --- the harnesses' main() at a toy size ------------------------------------

def test_sim_ablation_main_toy(tmp_path, monkeypatch):
    """The variant loop and the report at 4 envs, each variant timed over
    pairs of 1 and 3 steps."""
    monkeypatch.setattr(sim_ablation, "marginal", functools.partial(
        sim_ablation.marginal, n_small=1, n_big=3, reps=1))
    out = tmp_path / "sa.json"
    res = sim_ablation.main(["--device", "cpu", "--envs", "4", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert set(res) >= {"envs", "ms", "compile_s", "device"}
    assert list(res["ms"]) == list(sim_ablation.variants(p_world.SimParams()))
    assert all(np.isfinite(v) for v in res["ms"].values())


def test_crash_forensics_main_toy(tmp_path):
    out = tmp_path / "cf.json"
    res = crash_forensics.main(["--device", "cpu", "--envs", "3", "--steps", "12",
                                "--goals", "2", "--out", str(out)])
    saved = json.loads(out.read_text())
    assert set(saved) >= {"envs", "steps", "km", "collision_events", "offroad_only_events",
                          "collisions_per_km", "modes", "in_junction_by_mode", "cmd_by_mode",
                          "mean_ego_speed_at_impact", "arrivals", "wall_seconds", "device"}
    assert sum(res["modes"].values()) == res["collision_events"]
    assert res["km"] > 0


def test_expert_envelope_main_toy(tmp_path, monkeypatch):
    """The stage loop and the report at 2 envs × 3 steps on a 32² camera."""
    from carla_imitation_learning_tpu_torch.render import pipeline

    small = pipeline.RenderConfig(height=32, width=32)
    monkeypatch.setattr(pipeline, "RenderConfig", lambda **kw: small)
    out = tmp_path / "ee.json"
    res = expert_envelope.main(["--device", "cpu", "--envs", "2", "--steps", "3",
                                "--out", str(out)])
    saved = json.loads(out.read_text())
    for stage in expert_envelope.stages(4.0):
        assert set(saved[stage]) == set(expert_envelope.KEEP)
        assert saved[stage]["km_driven"] >= 0.0
    assert saved["config"]["envs"] == 2 and "wall_seconds" in res
