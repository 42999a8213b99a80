"""The scenario suite of the PyTorch port vs the JAX package.

``SCENARIOS`` equals the JAX package's, and each scenario composes to the
same town, sim and render settings; ``evaluate_policy`` of the expert on
the ``storm``, ``busy``, ``multilane`` and ``turns`` worlds from the JAX
init carry and spawn pool gives the JAX package's metrics (counts equal,
rates allclose at rtol 1e-5), with one env resetting inside the window; on
``storm`` the rainy frames also agree within the fast raster's tolerance
(mean|d| < 2e-3 and under 1 % of pixels off by more than 2/255; JAX's
kernel B runs in interpret mode). The expert's metrics do not read the
frames, so on the other three worlds JAX renders blank frames, which keeps
its compile short. ``scenario_eval`` runs through the port's ``run``
command on the CPU; an unknown scenario raises."""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import carla_imitation_learning_tpu.ops.raster_fast as j_raster_fast
from carla_imitation_learning_tpu import compose as j_compose
from carla_imitation_learning_tpu import experiments as j_ex
from carla_imitation_learning_tpu.sim import world as j_world
from carla_imitation_learning_tpu.training import closed_loop as j_loop
from carla_imitation_learning_tpu_torch import cli
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch import experiments as p_ex
from carla_imitation_learning_tpu_torch.config import compose as p_compose
from carla_imitation_learning_tpu_torch.training.closed_loop import driving_metrics, make_rollout

N_ENVS, N_STEPS = 3, 10
# a town and camera small enough for the CPU; 512 triangles, so ``busy``
# renders 632 as on the card
TINY = ["sim.n_agents=3", "sim.town.blocks=2", "sim.town.n_buildings=6", "sim.n_lights=2",
        "render.height=64", "render.width=64", "compute_dtype=float32"]
COMPARED = ("storm", "busy", "multilane", "turns")


def _configs(name: str):
    """The scenario's config in each package, from the same overrides; the
    JAX side as its ``scenario_eval`` builds it (walkers add 10 triangles
    each)."""
    overrides = ["model=imitation", "experiment=scenario_eval", *TINY]
    j_cfg = j_compose("config", overrides=overrides)
    for k, v in j_ex.SCENARIOS[name].items():
        j_cfg.set_dotted(k, v)
    ped = int(j_cfg.get_dotted("sim.n_pedestrians", 0))
    if ped:
        j_cfg.set_dotted("render.max_triangles",
                         int(j_cfg.get_dotted("render.max_triangles", 512)) + 10 * ped)
    return j_cfg, p_ex.scenario_config(p_compose("config", overrides=overrides), name)


def test_scenarios_equal_jax():
    assert p_ex.SCENARIOS == j_ex.SCENARIOS


@pytest.mark.parametrize("name", list(j_ex.SCENARIOS))
def test_scenario_worlds_equal_jax(name):
    """Town, sim and render settings of every scenario equal the JAX
    package's (its walker bump of ``max_triangles`` included)."""
    j_cfg, p_cfg = _configs(name)
    j_town, j_params, j_rcfg = j_ex._sim_bits(j_cfg, backend="jax")
    p_town, p_params, p_rcfg = p_ex._sim_bits(p_cfg)
    assert dataclasses.asdict(p_params) == dataclasses.asdict(j_params)
    for f in dataclasses.fields(p_rcfg):
        assert getattr(p_rcfg, f.name) == getattr(j_rcfg, f.name), f.name
    for f in dataclasses.fields(p_town):
        want, got = getattr(j_town, f.name), getattr(p_town, f.name)
        if got is None or isinstance(got, (int, float)):
            assert got == want, f.name
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f.name)
    assert (p_town.transfer_route is not None) == (name == "turns")


@pytest.fixture(scope="module", params=COMPARED)
def rollouts(request):
    """One JAX ``evaluate_policy`` of the expert per scenario (kernel B in
    interpret mode on ``storm``, blank frames elsewhere), with the init
    carry it ran from (one env set to reset inside the window), its spawn
    pool and its trajectory."""
    name = request.param
    j_cfg, p_cfg = _configs(name)
    town, params, rcfg = j_ex._sim_bits(j_cfg, backend="pallas")
    seen = {}

    def recording(*a, **k):
        init_fn, rollout_fn = make(*a, **k)

        def init(rng, n):
            # env 1 starts 4 steps before the episode limit: its auto-reset
            # (a spawn-pool pick, with the pool row's key) falls inside the
            # compared window
            states, framebuf, just_reset = init_fn(rng, n)
            states = states.replace(t=states.t.at[1].set(params.episode_len - 4))
            seen["carry"] = (states, framebuf, just_reset)
            return seen["carry"]

        def roll(carry, n):
            out = rollout_fn(carry, n)
            seen["traj"] = out[1]
            return out

        return init, roll

    def jitted_pool(params, town):
        # rollout_spawn_pool's rows under one jit (its eager vmap takes
        # seconds on the CPU); both packages run from this pool
        rows = jax.jit(lambda tw: j_world.make_spawn_pool(
            params, tw, jax.random.PRNGKey(0x5EED), 1024))(town)
        seen["pool"] = j_world.pack_spawn_pool(rows)
        return seen["pool"]

    if name == "storm":
        fast = functools.partial(j_raster_fast.rasterize_luma_fast, interpret=True)
    else:
        def fast(setup, height, width, **kw):
            return jnp.zeros((height, width), jnp.float32)

    make = j_loop.make_rollout
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_raster_fast, "rasterize_luma_fast", fast)
        mp.setattr(j_loop, "make_rollout", recording)
        mp.setattr(j_loop, "rollout_spawn_pool", jitted_pool)
        want = j_loop.evaluate_policy(params, town, rcfg, None, jax.random.PRNGKey(21),
                                      n_envs=N_ENVS, n_steps=N_STEPS)
    return name, p_cfg, town, seen, want


def test_evaluate_policy_matches_jax(rollouts):
    name, p_cfg, town, seen, want = rollouts
    _, params, rcfg = p_ex._sim_bits(p_cfg)
    _, rollout_fn = make_rollout(params, convert.town_from_jax(town), rcfg, None,
                                 spawn_pool=convert.spawn_pool_from_jax(seen["pool"]),
                                 device="cpu")
    _, traj = rollout_fn(convert.carry_from_jax(seen["carry"]), N_STEPS)
    got = driving_metrics(params, traj)
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, int):
            assert got[k] == w, k
        else:
            np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-7, err_msg=f"{name}: {k}")
    for k in ("action", "command", "done", "collision", "offroad", "traffic"):
        np.testing.assert_array_equal(traj[k].numpy(), np.asarray(seen["traj"][k]),
                                      err_msg=f"{name}: {k}")
    assert want["km_driven"] > 0 and want["episodes_ended"] >= 1
    if name == "storm":
        d = np.abs(traj["gray"].numpy().astype(np.int64)
                   - np.asarray(seen["traj"]["gray"]).astype(np.int64)) / 255.0
        assert d.mean() < 2e-3 and (d > 2 / 255).mean() < 0.01, d.mean()


def test_scenario_eval_cli(tmp_path, capsys):
    """All eight scenarios through ``run scenario_eval`` on the CPU, at 32²
    (the plain version of kernel B sets this test's time)."""
    args = ["run", "scenario_eval", "--json", "-o", "device=cpu", "-o", "n_envs=2",
            "-o", "n_steps=8", "-o", f"data_dir={tmp_path}", "-o", f"log_dir={tmp_path}"]
    for o in TINY + ["render.height=32", "render.width=32"]:
        args += ["-o", o]
    assert cli.main(args) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(result) == ["scenarios", "summary", "mean_driving_score",
                            "mean_driving_score_arc"]
    assert list(result["summary"]) == list(j_ex.SCENARIOS)
    for name, res in result["scenarios"].items():
        assert res["policy"]["env_steps"] == 16, name
        assert res["expert"]["action_agreement"] == 1.0, name
        assert res["expert"]["km_driven"] > 0, name
        assert set(result["summary"][name]) == {"policy", "expert", "policy_arc", "expert_arc"}
    assert 0.0 <= result["mean_driving_score"] <= 1.0
    assert 0.0 <= result["mean_driving_score_arc"] <= 1.0


def test_scenario_eval_unknown_scenario(tmp_path):
    cfg = p_compose("config", overrides=["model=imitation", "device=cpu", *TINY])
    with pytest.raises(ValueError, match="unknown scenarios"):
        p_ex.scenario_eval(cfg, scenarios="clear,warp_drive")
    with pytest.raises(ValueError, match="no policy artifact"):
        p_ex.scenario_eval(cfg, artifact=str(tmp_path))
