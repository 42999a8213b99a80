"""The RL and safety experiments of the PyTorch port through its CLI on the
CPU, at the JAX package's test size (``tests/test_rl.py``: 4 envs, 8-step
rollouts, 2 iterations, 1 epoch of 2 minibatches, the 3-agent bench town at
32²):

- ``run rl_finetune`` in both families, warm-started from a saved
  ``PolicyCNN`` / ``ContinuousPolicyCNN`` checkpoint: the result has the
  JAX experiment's keys and every PPO metric of JAX's history, all finite;
  the ``before`` score is the checkpoint's own policy on the evaluation
  fleet (so the warm start took); the actor checkpoint loads in
  ``closed_loop_eval``, which with ``safety_shield=true`` reports the
  shield's metrics for the policy and not for the expert;
- a JAX ``ActorCriticCNN`` train state in both families through
  ``convert.checkpoint_from_jax``: the weights, Adam's moments and the step
  land in the port's actor-critic (the Gaussian tree's ``log_std``
  included).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from carla_imitation_learning_tpu.training import rl as j_rl
from carla_imitation_learning_tpu_torch import cli, convert
from carla_imitation_learning_tpu_torch.config import compose
from carla_imitation_learning_tpu_torch.models import ContinuousPolicyCNN, PolicyCNN
from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
from carla_imitation_learning_tpu_torch.sim.town import make_town_from_cfg
from carla_imitation_learning_tpu_torch.sim.world import SimParams
from carla_imitation_learning_tpu_torch.training import closed_loop as cl
from carla_imitation_learning_tpu_torch.training import rl
from carla_imitation_learning_tpu_torch.training.steps import flax_init_
from carla_imitation_learning_tpu_torch.utils.checkpoint import restore_pytree, save_pytree

TINY = ["sim.n_envs=4", "sim.n_agents=3", "render.height=32", "render.width=32",
        "render.max_triangles=256", "sim.town.blocks=2", "sim.town.n_buildings=6",
        "sim.n_lights=4", "compute_dtype=float32", "device=cpu"]
# what the JAX experiment returns and what each of its history rows holds
RESULT_KEYS = {"before", "after", "history", "actor_checkpoint", "score_delta"}
JAX_HISTORY_KEYS = {"pg_loss", "value_loss", "entropy", "approx_kl", "clip_frac", "loss",
                    "reward_per_step", "progress_m_per_step", "value_mean",
                    "ran_red_per_1k_steps", "collisions_per_1k_steps", "iteration", "seconds",
                    "env_steps_per_sec"}


def _run(capsys, *args):
    argv = ["run", *args, "--json"]
    for o in TINY:
        argv += ["-o", o]
    assert cli.main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("family", ["discrete", "continuous"])
def test_rl_finetune_warm_start_then_shielded_eval(tmp_path, capsys, family):
    continuous = family == "continuous"
    policy = (ContinuousPolicyCNN if continuous else PolicyCNN)(dtype=torch.float32)
    flax_init_(policy, torch.Generator().manual_seed(5))
    save_pytree(tmp_path / "bc", {"params": policy.state_dict()})
    res = _run(capsys, "rl_finetune", "--checkpoint", str(tmp_path / "bc"),
               "-o", f"log_dir={tmp_path / 'logs'}", "-o", f"policy_family={family}",
               "-o", "n_envs=4", "-o", "rollout_steps=8", "-o", "iterations=2",
               "-o", "eval_envs=4", "-o", "eval_steps=8", "-o", "rl_update_epochs=1",
               "-o", "rl_num_minibatches=2")
    assert set(res) == RESULT_KEYS and len(res["history"]) == 2
    for row in res["history"]:
        assert set(row) >= JAX_HISTORY_KEYS
        assert all(np.isfinite(v) for v in row.values())
    assert res["score_delta"] == pytest.approx(res["after"]["driving_score"]
                                               - res["before"]["driving_score"])
    # the before score is the checkpoint's own policy on the evaluation fleet
    cfg = compose("config", overrides=TINY)
    with torch.no_grad():
        fn = (lambda obs: policy(obs)) if continuous else (lambda obs: policy(obs).argmax(-1))
        want = cl.evaluate_policy(SimParams.from_cfg(cfg),
                                  make_town_from_cfg(cfg, seed=int(cfg.get("data_seed", 0))),
                                  RenderConfig.from_cfg(cfg), fn,
                                  torch.Generator().manual_seed(int(cfg.get("seed", 0)) + 101),
                                  n_envs=4, n_steps=8,
                                  control_space="continuous" if continuous else "discrete",
                                  device="cpu")
    assert res["before"] == pytest.approx(want)
    actor = restore_pytree(res["actor_checkpoint"])["params"]
    assert set(actor) == set(policy.state_dict())
    # the updates moved the warm-started actor
    assert any(not torch.equal(actor[k], v) for k, v in policy.state_dict().items())

    ev = _run(capsys, "closed_loop_eval", "--checkpoint", res["actor_checkpoint"],
              "-o", f"log_dir={tmp_path / 'logs'}", "-o", f"policy_family={family}",
              "-o", "n_envs=4", "-o", "n_steps=8", "-o", "safety_shield=true")
    assert ev["policy"]["env_steps"] == 32 and 0.0 <= ev["policy"]["driving_score"] <= 1.0
    assert 0.0 <= ev["policy"]["shield_active_frac"] <= 1.0
    assert "shield_interventions_per_km" in ev["policy"]
    assert not any(k.startswith("shield_") for k in ev["expert"])


@pytest.mark.parametrize("family", ["discrete", "continuous"])
def test_actor_critic_checkpoint_from_jax(family):
    continuous = family == "continuous"
    model = j_rl.ActorCriticCNN(dtype=jnp.float32, continuous=continuous)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 4)))
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda s: jnp.asarray(rng.normal(size=s.shape).astype(np.float32) * 0.1), shapes)["params"]
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(3e-4))
    grads = jax.tree_util.tree_map(lambda p: jnp.asarray(
        rng.normal(size=p.shape).astype(np.float32)), params)
    _, opt_state = tx.update(grads, tx.init(params), params)
    payload = convert.checkpoint_from_jax({"params": params, "opt_state": opt_state, "step": 1})
    want = convert.actor_critic_state_dict(params)
    assert set(payload["params"]) == set(want)
    assert ("log_std" in want) == continuous
    port = rl.ActorCriticCNN(dtype=torch.float32, continuous=continuous)
    port.load_state_dict(payload["params"])
    for k, v in port.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
    assert payload["step"] == 1
    mu = convert.actor_critic_state_dict(opt_state[1][0].mu)
    names = [name for name, _ in port.named_parameters()]
    for i, name in enumerate(names):
        np.testing.assert_array_equal(payload["opt_state"]["state"][i]["exp_avg"].numpy(),
                                      mu[name].numpy(), err_msg=name)
