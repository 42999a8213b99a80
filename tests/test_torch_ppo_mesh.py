"""PPO over a ``data`` mesh of two gloo ranks on the CPU
(``ppo_train(mesh=)``, ``make_ppo_update`` on a replicated state) against
the port unsharded and against the JAX package's update on a ``data=2``
mesh, and ``run rl_finetune -o mesh.enabled=true`` on both ranks.

One group of two ranks (tests/torch_mesh_ranks.py, the port alone) runs:

- one ``ppo_train`` iteration, 4 envs × 16 steps at 32², 2 epochs × 2
  minibatches, from the weights of ``tests/test_torch_rl.py``'s discrete
  actor-critic with the bias of action 7 (straight, full throttle) raised
  by 3, so that the fleet moves and earns progress (with no reward the
  advantages are the values' last-bit rounding, which the normalisation
  blows up to 1e-4), and a seed. Against the same run unsharded: the
  rollout's actions equal (the actor's Gumbel noise drawn for the global
  fleet), the normalised advantages rtol 1e-6 / atol 1e-6 (the global
  mean and population std, each rank's columns joined; the critic's values
  on a rank's 2 rows and on all 4 round apart in the last bit, 2e-8, as
  the CPU's kernels block by batch, and GAE and the normalisation carry
  that to 4e-7), every metric of the history rtol 1e-6 / atol 1e-6
  except the wall-clock ones (``pg_loss`` is minus a minibatch's mean
  advantage in the first epoch, near 0), and the
  parameters rtol 1e-5 / atol 1e-6 (an element with a gradient within
  rounding of zero takes part of an Adam step apart; see
  ``tests/test_torch_online_dagger_mesh.py``);
- one ``make_ppo_update`` on each rank's columns of that file's JAX-made
  trajectory, with JAX's epoch permutations injected through
  ``rl.epoch_permutations``, against JAX's ``make_ppo_update`` with the
  trajectory sharded ``P(None, 'data')`` over a data=2 mesh of the
  harness's CPU devices: parameters and metrics at that file's rtol 1e-4 /
  atol 1e-5;
- ``run rl_finetune`` through the CLI (4 envs × 4 steps, one iteration,
  evaluations at 4 × 4): rank 0 prints a result equal to the one-process
  run's (timings and paths aside; numbers rtol 1e-5 / atol 1e-7), rank 1
  prints nothing, and only rank 0 writes the actor checkpoint.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

import test_torch_rl as rbase
import torch_mesh_ranks as ranks
from carla_imitation_learning_tpu.parallel.mesh import make_mesh as j_make_mesh
from carla_imitation_learning_tpu.training import rl as j_rl
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
from carla_imitation_learning_tpu_torch.sim.town import make_town
from carla_imitation_learning_tpu_torch.sim.world import SimParams

PPO = {"update_epochs": 2, "num_minibatches": 2}
TINY = ["sim.n_agents=2", "sim.town.blocks=2", "sim.town.n_buildings=4",
        "render.height=32", "render.width=32", "render.max_triangles=256"]
CLI_SIZES = ["n_envs=4", "rollout_steps=4", "iterations=1", "eval_envs=4", "eval_steps=4",
             "rl_update_epochs=1", "rl_num_minibatches=2", "compute_dtype=float32"]


def _jax_update():
    """JAX's update of ``tests/test_torch_rl.py``'s discrete case on a
    data=2 mesh → (metrics, parameters as a state dict, what the ranks
    need: initial weights, trajectory, last value, permutations)."""
    jm, params = rbase._jax_ac(False, seed=2)
    cfg = j_rl.PPOConfig(**PPO)
    traj, last_value = rbase._jax_trajectory(jm, params, False)
    state_dict = convert.actor_critic_state_dict(params)
    tx = optax.chain(optax.clip_by_global_norm(cfg.max_grad_norm),
                     optax.adam(cfg.learning_rate))
    update_rng = jax.random.PRNGKey(15)
    perms = [np.asarray(jax.vmap(lambda k: jax.random.permutation(k, rbase.T))(
        jax.random.split(ek, rbase.B))) for ek in jax.random.split(update_rng, cfg.update_epochs)]
    mesh = j_make_mesh(axis_sizes={"data": 2})
    cols = NamedSharding(mesh, PartitionSpec(None, "data"))
    j_traj = {k: jax.device_put(jnp.asarray(v), cols) for k, v in traj.items()}
    j_last = jax.device_put(jnp.asarray(last_value), NamedSharding(mesh, PartitionSpec("data")))
    new_params, _, metrics = j_rl.make_ppo_update(jm, tx, cfg, rbase.K)(
        params, tx.init(params), j_traj, j_last, update_rng)
    p_traj = {k: torch.from_numpy(np.array(v)) for k, v in traj.items()}
    p_traj["action"] = p_traj["action"].to(torch.int64)
    handoff = {"state_dict": state_dict, "traj": p_traj,
               "last_value": torch.from_numpy(last_value), "perms": perms}
    return ({k: float(v) for k, v in metrics.items()},
            convert.actor_critic_state_dict(new_params), handoff)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    j_metrics, j_params, handoff = _jax_update()
    root = tmp_path_factory.mktemp("ppo_mesh")
    cli_argv = ["run", "rl_finetune", "--json", "-o", "device=cpu",
                *[a for o in TINY + CLI_SIZES for a in ("-o", o)]]
    moving = dict(handoff["state_dict"])
    moving["head.layers.2.bias"] = moving["head.layers.2.bias"] + 3.0 * (torch.arange(9) == 7)
    job = {"params": SimParams(n_agents=3), "town": make_town(blocks=2, n_buildings=6,
                                                              n_lights=4),
           "rcfg": RenderConfig(32, 32, max_triangles=256), "n_envs": 4, "steps": 16,
           "seed": 7, "ppo": PPO, "state_dict": moving, "jax": handoff,
           "cli_argv": cli_argv + ["-o", "mesh.enabled=true"], "log_root": str(root / "logs")}
    two = ranks.spawn("ppo_checks", job, root / "job")
    one = ranks.run_ppo(job, None)
    one_cli = ranks._cli_json(cli_argv + ["-o", f"log_dir={root}/logs/one"])
    return {"two": two, "one": one, "one_cli": one_cli, "jax": (j_metrics, j_params),
            "root": root}


def _close(got, want, rtol, atol, what=""):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), what
        for k, v in want.items():
            if "seconds" not in k and "per_sec" not in k and k != "actor_checkpoint":
                _close(got[k], v, rtol, atol, f"{what}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, rtol, atol, f"{what}[{i}]")
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)
    else:
        assert got == want, what


def test_sharded_ppo_matches_unsharded(run):
    two, one = run["two"], run["one"]
    assert two[0]["ppo"]["actions"].shape == (16, 2)
    assert one["history"][0]["progress_m_per_step"] > 0
    actions = torch.cat([r["ppo"]["actions"] for r in two], dim=1)
    assert torch.equal(actions, one["actions"])
    assert len(torch.unique(one["actions"])) > 1
    adv = torch.cat([r["ppo"]["adv"] for r in two], dim=1)
    np.testing.assert_allclose(adv.numpy(), one["adv"].numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(adv.mean()), 0.0, atol=1e-6)
    for r in two:
        _close(r["ppo"]["history"], one["history"], rtol=1e-6, atol=1e-6, what="history")
        assert r["ppo"]["history"][0]["env_steps_per_sec"] > 0
        for k, v in one["params"].items():
            np.testing.assert_allclose(r["ppo"]["params"][k].numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_sharded_update_matches_jax_mesh(run):
    j_metrics, j_params = run["jax"]
    for r in run["two"]:
        assert r["jax"]["metrics"].keys() == j_metrics.keys()
        for k, v in j_metrics.items():
            np.testing.assert_allclose(r["jax"]["metrics"][k], v, rtol=1e-4, atol=1e-5,
                                       err_msg=k)
        for k, v in j_params.items():
            np.testing.assert_allclose(r["jax"]["params"][k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)


def test_rl_finetune_on_two_ranks(run):
    two, one = run["two"][0]["cli"], run["one_cli"]
    assert run["two"][1]["cli"] is None            # rank 0 prints the result
    _close(two, one, rtol=1e-5, atol=1e-7, what="rl_finetune")
    assert np.isfinite(two["history"][0]["loss"])
    logs = run["root"] / "logs"
    assert (logs / "rank0" / "rl_finetune" / "actor_params").exists()
    assert not (logs / "rank1").exists()
    assert json.loads(json.dumps(two))      # a plain JSON result
