"""PPO (``training/rl.py``) in the PyTorch port against the JAX package's,
fp32 on the CPU, weights carried across with ``convert``:

- ``reward_from_traj``, ``compute_gae``, ``window_sources``,
  ``gather_windows`` and ``gaussian_logp`` on seeded inputs: indices equal,
  values allclose (rtol 1e-5);
- the window rebuild against ``update_framebuf`` stepped over a rollout's
  frames and resets (refill forced at step 0, as ``ppo_train`` does);
- ``ActorCriticCNN`` forward in both families with converted weights, and
  the warm start from a ``PolicyCNN`` and a ``ContinuousPolicyCNN``;
- ``make_actor`` with JAX's draws fed through ``rl.actor_draws``: equal
  actions, extras allclose;
- one ``make_ppo_update`` call per family on a JAX-made trajectory (frames,
  resets, the actor's own log-probabilities and values) with JAX's epoch
  permutations fed through ``rl.epoch_permutations``: parameters after the
  update at rtol 1e-4 / atol 1e-5 (Adam turns rounding in a near-zero
  gradient into part of a step, ``tests/test_torch_training.py``), every
  metric allclose.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from carla_imitation_learning_tpu.models import ContinuousPolicyCNN as JCont
from carla_imitation_learning_tpu.models import PolicyCNN as JPolicy
from carla_imitation_learning_tpu.training import rl as j_rl
from carla_imitation_learning_tpu.training.closed_loop import update_framebuf as j_update_framebuf
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch.models import ContinuousPolicyCNN, PolicyCNN
from carla_imitation_learning_tpu_torch.training import rl
from carla_imitation_learning_tpu_torch.training.closed_loop import update_framebuf
from carla_imitation_learning_tpu_torch.training.steps import AdamConfig, create_train_state

HW, T, B, K = 32, 8, 4, 4
FAMILIES = ["discrete", "continuous"]


def _dones(seed=0, n_steps=T, n_envs=B):
    d = np.random.default_rng(seed).uniform(size=(n_steps, n_envs)) < 0.2
    d[2, 0] = d[3, 0] = True          # back-to-back ends
    return d


def _draw_params(model, seed: int):
    """A flax tree of ``model``'s shapes (traced, not compiled), drawn from
    numpy: lecun-scaled kernels, small biases; ``log_std`` at −0.7 plus
    noise, so the Gaussian actor's two dims differ."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, HW, HW, K)))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, s):
        if path[-1].key == "log_std":
            return jnp.asarray(np.float32(-0.7 + 0.2 * rng.normal(size=s.shape)))
        scale = 0.1 if len(s.shape) == 1 else 1 / np.sqrt(np.prod(s.shape[:-1]))
        return jnp.asarray((rng.normal(size=s.shape) * scale).astype(np.float32))

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_ac(continuous: bool, seed: int = 0):
    model = j_rl.ActorCriticCNN(dtype=jnp.float32, continuous=continuous)
    return model, _draw_params(model, seed)


def _port_ac(params):
    model = convert.model_for_params(params, torch.float32)
    assert isinstance(model, rl.ActorCriticCNN)
    model.load_state_dict(convert.params_state_dict(params))
    return model


def test_reward_gae_and_logp_match_jax():
    rng = np.random.default_rng(1)
    traj = {"route_ds": rng.normal(0.3, 0.2, (T, B)).astype(np.float32),
            "collision": rng.uniform(size=(T, B)) < 0.1,
            "offroad": rng.uniform(size=(T, B)) < 0.1,
            "ran_red": rng.uniform(size=(T, B)) < 0.1,
            "red_light": rng.uniform(size=(T, B)) < 0.3,
            "speed": rng.uniform(0, 8, (T, B)).astype(np.float32)}
    cfg_j, cfg_p = j_rl.PPOConfig(), rl.PPOConfig()
    want_r = np.asarray(j_rl.reward_from_traj({k: jnp.asarray(v) for k, v in traj.items()}, cfg_j))
    got_r = rl.reward_from_traj({k: torch.from_numpy(v) for k, v in traj.items()}, cfg_p)
    np.testing.assert_allclose(got_r.numpy(), want_r, rtol=1e-6)
    values = rng.normal(size=(T, B)).astype(np.float32)
    last = rng.normal(size=B).astype(np.float32)
    dones = _dones(2)
    want = j_rl.compute_gae(jnp.asarray(want_r), jnp.asarray(values), jnp.asarray(dones),
                            jnp.asarray(last), 0.99, 0.95)
    got = rl.compute_gae(got_r, torch.from_numpy(values), torch.from_numpy(dones),
                         torch.from_numpy(last), 0.99, 0.95)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    a, mean = rng.normal(size=(6, 2)).astype(np.float32), rng.normal(size=(6, 2)).astype(np.float32)
    log_std = np.float32([-0.7, 0.3])
    np.testing.assert_allclose(
        rl.gaussian_logp(*map(torch.from_numpy, (a, mean, log_std))).numpy(),
        np.asarray(j_rl.gaussian_logp(*map(jnp.asarray, (a, mean, log_std)))), rtol=1e-6)


def test_window_sources_and_gather_match_jax():
    dones = _dones(3, 12, 5)
    src = rl.window_sources(torch.from_numpy(dones), K)
    np.testing.assert_array_equal(src.numpy(),
                                  np.asarray(j_rl.window_sources(jnp.asarray(dones), K)))
    gray = np.random.default_rng(4).integers(0, 256, (12, 5, 6, 7), dtype=np.uint8)
    idx = np.random.default_rng(5).permutation(60)[:23]
    want = j_rl.gather_windows(jnp.asarray(gray), jnp.asarray(src.numpy()), jnp.asarray(idx))
    got = rl.gather_windows(torch.from_numpy(gray), src, torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_window_rebuild_equals_update_framebuf():
    """Stepping ``update_framebuf`` over the frames (refill at step 0 and
    after every end) gives exactly the windows ``gather_windows`` rebuilds,
    in both packages."""
    n_steps, n_envs = 12, 5
    dones = _dones(6, n_steps, n_envs)
    gray = torch.from_numpy(np.random.default_rng(7).integers(0, 256, (n_steps, n_envs, 6, 7),
                                                              dtype=np.uint8))
    src = rl.window_sources(torch.from_numpy(dones), K)
    fb = torch.zeros((n_envs, 6, 7, K), dtype=torch.uint8)
    jfb = jnp.asarray(fb.numpy())
    just_reset = torch.ones(n_envs, dtype=torch.bool)
    for t in range(n_steps):
        fb = update_framebuf(fb, gray[t], just_reset)
        jfb = j_update_framebuf(jfb, jnp.asarray(gray[t].numpy())[..., None],
                                jnp.asarray(just_reset.numpy()))
        np.testing.assert_array_equal(fb.numpy(), np.asarray(jfb))
        rebuilt = rl.gather_windows(gray, src, t * n_envs + torch.arange(n_envs))
        np.testing.assert_array_equal(rebuilt.numpy(),
                                      (fb.to(torch.float32) * (1.0 / 255.0)).numpy())
        just_reset = torch.from_numpy(dones[t])


def _obs(n=3, seed=8):
    return np.random.default_rng(seed).uniform(0, 1, (n, HW, HW, K)).astype(np.float32)


@pytest.mark.parametrize("family", FAMILIES)
def test_actor_critic_forward_and_warm_start(family):
    continuous = family == "continuous"
    jm, params = _jax_ac(continuous)
    x = _obs()
    j_out, j_value = jm.apply({"params": params}, jnp.asarray(x))
    model = _port_ac(params)
    with torch.no_grad():
        out, value = model(torch.from_numpy(x))
    np.testing.assert_allclose(value.numpy(), np.asarray(j_value), rtol=1e-5, atol=1e-6)
    if continuous:
        np.testing.assert_allclose(out[0].numpy(), np.asarray(j_out[0]), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(out[1].detach().numpy(), np.asarray(j_out[1]))
        assert model.log_std.dtype == torch.float32
        fresh_ac = rl.ActorCriticCNN(continuous=True)
        assert fresh_ac.log_std.dtype == torch.float32 and (fresh_ac.log_std == -0.7).all()
    else:
        np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=1e-5, atol=1e-6)
    # warm start from a policy: the actor becomes the policy, the rest stays
    jp_model = (JCont if continuous else JPolicy)(dtype=jnp.float32)
    bc = _draw_params(jp_model, 3)
    warm = j_rl.warm_start_from_policy(params, bc)
    policy = (ContinuousPolicyCNN if continuous else PolicyCNN)(dtype=torch.float32)
    policy.load_state_dict(convert.policy_state_dict(bc))
    fresh = _port_ac(params)
    rl.warm_start_from_policy(fresh, policy)
    for k, v in convert.actor_critic_state_dict(warm).items():
        np.testing.assert_array_equal(fresh.state_dict()[k].numpy(), v.numpy(), err_msg=k)
    back = rl.actor_policy_params_from(fresh)
    assert set(back) == set(policy.state_dict())
    with torch.no_grad():
        mean = fresh(torch.from_numpy(x))[0]
        np.testing.assert_allclose((mean[0] if continuous else mean).numpy(),
                                   policy(torch.from_numpy(x)).numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("family", FAMILIES)
def test_make_actor_with_jax_draws(family, monkeypatch):
    continuous = family == "continuous"
    jm, params = _jax_ac(continuous, seed=1)
    x = _obs(6, 9)
    key = jax.random.PRNGKey(11)
    j_action, j_extra = j_rl.make_actor(jm)(jnp.asarray(x), {"rng": key}, params)
    noise = (jax.random.normal(key, (6, 2)) if continuous
             else jax.random.gumbel(key, (6, 9), jnp.float32))
    monkeypatch.setattr(rl, "actor_draws", lambda gen, shape, cont, device: torch.tensor(
        np.asarray(noise)))
    model = _port_ac(params)
    with torch.no_grad():
        action, extra = rl.make_actor(model)(torch.from_numpy(x), {"rng": None}, None)
        det, _ = rl.make_actor(model, sample=False)(torch.from_numpy(x), {}, model)
    if continuous:
        np.testing.assert_allclose(action.numpy(), np.asarray(j_action), rtol=1e-5, atol=1e-6)
        assert extra.shape == (6, 4)
    else:
        np.testing.assert_array_equal(action.numpy(), np.asarray(j_action))
        assert extra.shape == (6, 2)
    np.testing.assert_allclose(extra.numpy(), np.asarray(j_extra), rtol=1e-5, atol=1e-5)
    j_det, _ = j_rl.make_actor(jm, sample=False)(jnp.asarray(x), {}, params)
    np.testing.assert_allclose(det.numpy(), np.asarray(j_det), rtol=1e-5, atol=1e-6)


def _jax_trajectory(jm, params, continuous: bool):
    """A rollout-shaped trajectory: seeded frames and resets, the signals
    the reward reads, and the actor's own draws, log-probabilities and
    values on the windows a rollout with those frames and resets shows."""
    rng = np.random.default_rng(12)
    gray = rng.integers(0, 256, (T, B, HW, HW), dtype=np.uint8)
    dones = _dones(13)
    src = j_rl.window_sources(jnp.asarray(dones), K)
    obs = j_rl.gather_windows(jnp.asarray(gray), src, jnp.arange(T * B))
    actor = j_rl.make_actor(jm)
    action, extra = actor(obs, {"rng": jax.random.PRNGKey(14)}, params)
    traj = {"gray": gray, "done": dones,
            "route_ds": rng.normal(0.3, 0.2, (T, B)).astype(np.float32),
            "collision": rng.uniform(size=(T, B)) < 0.05,
            "offroad": rng.uniform(size=(T, B)) < 0.05,
            "ran_red": rng.uniform(size=(T, B)) < 0.05,
            "red_light": rng.uniform(size=(T, B)) < 0.2,
            "policy_extra": np.asarray(extra).reshape(T, B, -1),
            "action": (rng.integers(0, 9, (T, B)).astype(np.int32) if continuous
                       else np.asarray(action).reshape(T, B))}
    return traj, rng.normal(size=B).astype(np.float32)


@pytest.mark.parametrize("family", FAMILIES)
def test_one_ppo_update_matches_jax(family, monkeypatch):
    continuous = family == "continuous"
    jm, params = _jax_ac(continuous, seed=2)
    cfg_j = j_rl.PPOConfig(update_epochs=2, num_minibatches=2)
    cfg_p = rl.PPOConfig(update_epochs=2, num_minibatches=2)
    traj, last_value = _jax_trajectory(jm, params, continuous)
    model = _port_ac(params)        # converted before JAX's update donates the params
    tx = optax.chain(optax.clip_by_global_norm(cfg_j.max_grad_norm),
                     optax.adam(cfg_j.learning_rate))
    update_rng = jax.random.PRNGKey(15)
    perms = [np.asarray(jax.vmap(lambda k: jax.random.permutation(k, T))(jax.random.split(ek, B)))
             for ek in jax.random.split(update_rng, cfg_j.update_epochs)]
    new_params, _, j_metrics = j_rl.make_ppo_update(jm, tx, cfg_j, K)(
        params, tx.init(params), {k: jnp.asarray(v) for k, v in traj.items()},
        jnp.asarray(last_value), update_rng)

    draws = iter(perms)
    monkeypatch.setattr(rl, "epoch_permutations",
                        lambda gen, n_envs, n_steps, device: torch.from_numpy(next(draws)))
    state = create_train_state(model, AdamConfig(schedule=lambda c: cfg_p.learning_rate,
                                                 clip=cfg_p.max_grad_norm), device="cpu")
    p_traj = {k: torch.from_numpy(np.array(v)) for k, v in traj.items()}
    p_traj["action"] = p_traj["action"].to(torch.int64)
    metrics = rl.make_ppo_update(state, cfg_p, K)(p_traj, torch.from_numpy(last_value), None)
    assert next(draws, None) is None
    assert set(metrics) == set(j_metrics)
    for k, v in j_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-4, atol=1e-5, err_msg=k)
    want = convert.actor_critic_state_dict(new_params)
    for k, v in state.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-5, err_msg=k)
