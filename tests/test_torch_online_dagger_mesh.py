"""Online DAgger over a ``data`` mesh of two gloo ranks on the CPU
(``make_online_dagger(mesh=)``) against the port unsharded and against the
JAX package's single program on a ``data=2`` mesh.

One group of two ranks (tests/torch_mesh_ranks.py, the port alone) runs
``run_online``'s three cases and ``run dagger_online -o mesh.enabled=true``
through the CLI; this process runs the same cases unsharded, JAX's run and
the CLI in one process. 4 envs × 12 steps × 3 rounds × 3 train steps at
batch 8 (2 windows an env) at 32², episodes of 20 steps, so later rounds
hold torn windows:

- ``own``: the port's own draws (first fleet, β coins at β = 0.5, window
  indices) and renderer. Against the port unsharded: every step's windows,
  labels and weights equal (the ranks' rows joined), agreement equal,
  per-round loss rtol 1e-6, every step's reduced gradient rtol 1e-5 /
  atol 1e-7, parameters rtol 1e-5 / atol 1e-6. The atol is for an element
  whose gradient is within rounding of zero in some step: a gradient summed
  over two halves of the batch rounds apart from one summed whole, and
  Adam turns that rounding into part of a step of the learning rate (1e-3);
  one element of 73728 moved 2.8e-7 apart.
- ``unequal``: as ``own`` with the weights of the first half of the fleet's
  windows that end on an odd step zeroed, so rank 0's weight sums are
  about half of rank 1's: every step's reduced gradient at rtol 1e-5 /
  atol 1e-7 and the parameters at rtol 1e-5 / atol 1e-6 against the port
  unsharded.
  A sharded step that averaged its gradient (halved) or divided by its own
  rank's weight sum fails this case.
- ``jax``: JAX's draws injected as ``tests/test_torch_online_dagger.py``
  injects them (its first fleet, its window indices; β = 0) and both
  packages rendering the stand-in frames that file computes exactly;
  against JAX's ``make_online_dagger(mesh=)``: agreement equal,
  valid_frac rtol 1e-6, loss rtol 1e-5 (that file's tolerances),
  parameters rtol 1e-4 / atol 5e-5. That file holds them at atol 1e-5
  with 3 envs; with 4, one element of ``head.layers.0.weight`` (of 8192)
  takes an Adam step 3.7e-5 apart in the port, unsharded as well as
  sharded (JAX's own data=2 and unsharded runs agree within 2e-7): the
  near-zero-gradient case above, bounded here at 5 % of one step.
- the CLI: the two-rank result equals the one-process result (loss rtol
  1e-5, the rest equal or rtol 1e-5), and rank 1 prints nothing.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import carla_imitation_learning_tpu.training.online_dagger as j_od
import test_torch_online_dagger as base
import torch_mesh_ranks as ranks
from carla_imitation_learning_tpu.models import PolicyCNN as JPolicyCNN
from carla_imitation_learning_tpu.parallel.mesh import make_mesh as j_make_mesh
from carla_imitation_learning_tpu.render.pipeline import RenderConfig as JRenderConfig
from carla_imitation_learning_tpu.sim.world import make_spawn_pool, pack_spawn_pool, reset_env
from carla_imitation_learning_tpu.training import steps as j_steps
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch.training import online_dagger as p_od

N_ENVS, N_STEPS, ROUNDS, TRAIN_STEPS, BATCH = 4, 12, 3, 3, 8
K_PER_ENV = BATCH // N_ENVS
CLI_SIZES = ["rounds=2", "n_envs=4", "n_steps=10", "train_steps_per_round=2",
             "eval_steps=4", "BATCH_SIZE=8", "compute_dtype=float32"]
TINY = ["sim.n_agents=2", "sim.town.blocks=2", "sim.town.n_buildings=4",
        "render.height=32", "render.width=32", "render.max_triangles=256"]


def _jax_run():
    """JAX's run on a data=2 mesh with the stand-in frames, beta = 0 →
    (metrics, final params, the injected draws and initial weights)."""
    rng = jax.random.PRNGKey(11)
    k_init, key = jax.random.split(rng)
    indices = []
    for r in range(ROUNDS):
        key, _, k_train = jax.random.split(key, 3)
        for k in jax.random.split(k_train, TRAIN_STEPS):
            indices.append(base._jax_indices(k, r, ROUNDS, N_STEPS, N_ENVS, K_PER_ENV))
    states = jax.jit(jax.vmap(lambda k: reset_env(base.J_PARAMS, base.TOWN, k)))(
        jax.random.split(k_init, N_ENVS))
    pool = pack_spawn_pool(jax.jit(lambda: make_spawn_pool(
        base.J_PARAMS, base.TOWN, jax.random.PRNGKey(0x5EED), 1024))())
    p_states = convert.world_state_from_jax(states)
    render = ranks.pattern_renderer(base.HW)(None, None, None, "cpu")
    first = torch.clamp(render(p_states)["gray"] * 255.0 + 0.5, 0, 255).to(torch.uint8)
    params = base._centred(base._jax_weights(5),
                           first[..., None].repeat(1, 1, 1, 4).float() / 255.0)
    model = JPolicyCNN(dtype=jnp.float32)
    tx = j_steps.make_optimizer(base.CFG)
    jstate = j_steps.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                opt_state=tx.init(params), apply_fn=model.apply, tx=tx,
                                ema_params=None, ema_decay=0.0)
    sd = convert.policy_state_dict(params)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_od, "rollout_spawn_pool", lambda params, town: pool)
        mp.setattr(j_od, "make_renderer", base._jax_pattern_renderer)
        jax.clear_caches()
        run = j_od.make_online_dagger(model.apply, base.J_PARAMS, base.TOWN,
                                      JRenderConfig(base.HW, base.HW, max_triangles=256,
                                                    backend="jax"),
                                      n_envs=N_ENVS, n_steps=N_STEPS, rounds=ROUNDS,
                                      train_steps=TRAIN_STEPS, batch=BATCH, beta=0.0,
                                      mesh=j_make_mesh(axis_sizes={"data": 2}))
        j_final, j_metrics = run(jstate, rng)
        j_metrics = {k: np.asarray(v) for k, v in j_metrics.items()}
        j_params = convert.policy_state_dict(j_final.params)
    jax.clear_caches()
    draws = {"states": p_states, "indices": indices,
             "pool": convert.spawn_pool_from_jax(pool), "pattern": True}
    return j_metrics, j_params, draws, sd


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    j_metrics, j_params, draws, sd = _jax_run()
    root = tmp_path_factory.mktemp("od_mesh")
    cli_argv = ["run", "dagger_online", "--json", "-o", "model=imitation", "-o", "device=cpu",
                "-o", f"data_dir={root}/data", *[a for o in TINY + CLI_SIZES
                                                   for a in ("-o", o)]]
    job = {"params": base.P_PARAMS, "town": base.P_TOWN,
           "rcfg": dataclasses.replace(base.P_RCFG, rgb=False, fast=True),
           "n_envs": N_ENVS, "n_steps": N_STEPS, "rounds": ROUNDS, "train_steps": TRAIN_STEPS,
           "batch": BATCH, "cfg": base.CFG, "state_dict": sd,
           "cases": {"own": {"seed": 3, "beta": 0.5},
                     "unequal": {"seed": 4, "beta": 0.5, "unequal": True},
                     "jax": draws},
           "cli_argv": cli_argv + ["-o", "mesh.enabled=true"], "log_root": str(root / "logs")}
    two = ranks.spawn("online_dagger_checks", job, root / "job")
    one = {case: ranks.run_online(job, case, None) for case in job["cases"]}
    one["cli"] = ranks._cli_json(cli_argv + ["-o", f"log_dir={root}/logs/one"])
    return {"two": two, "one": one, "jax": (j_metrics, j_params)}


def _joined_windows(two, case):
    """Every train step's (obs, labels, weights) with the ranks' rows joined."""
    return [tuple(torch.cat([r[case]["windows"][i][j] for r in two]) for j in range(3))
            for i in range(len(two[0][case]["windows"]))]


def _params_match(got: dict, want: dict, rtol: float, atol: float = 0.0):
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=rtol, atol=atol, err_msg=k)


def test_sharded_run_matches_unsharded(run):
    two, one = run["two"], run["one"]["own"]
    assert two[0]["own"]["windows"][0][0].shape[0] == N_ENVS // 2 * K_PER_ENV
    joined = _joined_windows(two, "own")
    assert len(joined) == len(one["windows"]) == ROUNDS * TRAIN_STEPS
    for (obs, y, w), (o_obs, o_y, o_w) in zip(joined, one["windows"]):
        assert torch.equal(obs, o_obs) and torch.equal(y, o_y) and torch.equal(w, o_w)
    m = one["metrics"]
    assert 0.0 < m["agreement"][1:].min() and m["agreement"][0] == 1.0
    for r in two:
        np.testing.assert_array_equal(r["own"]["metrics"]["agreement"], m["agreement"])
        np.testing.assert_array_equal(r["own"]["metrics"]["valid_frac"], m["valid_frac"])
        np.testing.assert_allclose(r["own"]["metrics"]["loss"], m["loss"], rtol=1e-6)
        assert r["own"]["step"] == one["step"] == ROUNDS * TRAIN_STEPS
        _params_match(r["own"]["params"], one["params"], rtol=1e-5, atol=1e-6)
        for g, want in zip(r["own"]["grads"], one["grads"]):
            np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=1e-5, atol=1e-7)


def test_unequal_weight_sums_sum_the_gradient(run):
    two, one = run["two"], run["one"]["unequal"]
    sums = np.array([[float(w.sum()) for _, _, w in r["unequal"]["windows"]] for r in two])
    assert sums[0].sum() < 0.75 * sums[1].sum(), sums
    for r in two:
        for g, want in zip(r["unequal"]["grads"], one["grads"]):
            np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(r["unequal"]["metrics"]["loss"], one["metrics"]["loss"],
                                   rtol=1e-6)
        _params_match(r["unequal"]["params"], one["params"], rtol=1e-5, atol=1e-6)


def test_sharded_run_matches_jax_mesh(run):
    (jm, j_params), two = run["jax"], run["two"]
    for r in two:
        pm = r["jax"]["metrics"]
        np.testing.assert_array_equal(pm["agreement"], jm["agreement"])
        np.testing.assert_allclose(pm["valid_frac"], jm["valid_frac"], rtol=1e-6)
        np.testing.assert_allclose(pm["loss"], jm["loss"], rtol=1e-5)
        _params_match(r["jax"]["params"], j_params, rtol=1e-4, atol=5e-5)
    assert jm["agreement"][0] == 1.0 and np.all((jm["valid_frac"] > 0) & (jm["valid_frac"] < 1))


def test_cli_dagger_online_on_two_ranks(run):
    two, one = run["two"][0]["cli"], run["one"]["cli"]
    assert run["two"][1]["cli"] is None            # rank 0 prints the result
    assert two.keys() == one.keys()
    np.testing.assert_allclose(two["loss_per_round"], one["loss_per_round"], rtol=1e-5)
    assert two["agreement_per_round"] == one["agreement_per_round"]
    assert two["valid_frac_per_round"] == one["valid_frac_per_round"]
    assert two["final_eval"].keys() == one["final_eval"].keys()
    for k, v in one["final_eval"].items():
        if isinstance(v, float):
            np.testing.assert_allclose(two["final_eval"][k], v, rtol=1e-5, err_msg=k)
        else:
            assert two["final_eval"][k] == v, k
