"""Imagination training of the PyTorch port vs the JAX package on the CPU:
a GRU world model (z 16, hidden 32, 32² frames) and the heads and latent
policies with numpy-drawn weights carried across by ``convert``, and every
random draw of the port (initial weights, minibatch rows, Gumbel and
normal noise) fed from JAX's keys through the port's hooks:

- one ``make_imagination_update`` step per action space, with a single
  head and with a 3-head ensemble under the disagreement penalty, the
  uncertainty stop and the anchor: metrics rtol 1e-5, the policy after
  Adam rtol 1e-4 / atol 1e-5;
- ``train_reward_head`` (one head, and 3 stacked) and ``train_latent_bc``
  (both action spaces) for 6 steps: history rtol 1e-5, weights rtol 1e-4
  / atol 1e-5;
- ``latent_policy_fn`` acts as JAX's on a rollout window;
- ``checkpoint_from_jax`` restores a world model, a recurrent policy, a
  ViT and a stacked reward head in the port."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from carla_imitation_learning_tpu.models import RecurrentPolicy as JRecurrent
from carla_imitation_learning_tpu.models import ViTPolicy as JViT
from carla_imitation_learning_tpu.models.world_model import LatentWorldModel as JWM
from carla_imitation_learning_tpu.training import imagination as j_imag
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch.training import imagination as imag
from carla_imitation_learning_tpu_torch.training.steps import ADAM_BETAS, ADAM_EPS
from test_torch_aux import numpy_params

Z, HID, HW, B, N = 16, 32, 32, 6, 40
PARAMS_TOL = dict(rtol=1e-4, atol=1e-5)


def _wm(space: str, seed: int = 0):
    jm = JWM(z_size=Z, rnn="gru", height=HW, width=HW, hidden_size=HID, dtype=jnp.float32,
             action_space=space)
    params = numpy_params(jm, jm.example_input(1, 3), seed)
    model = convert.model_for_params(params, torch.float32)
    model.load_state_dict(convert.params_state_dict(params))
    return jm, params, model


def _port(params, continuous: bool = False):
    model = convert.model_for_params(params, torch.float32, continuous=continuous)
    model.load_state_dict(convert.params_state_dict(params))
    return model


def _stacked_head_params(e: int, seed: int):
    """E reward heads' numpy-drawn trees stacked on a leading axis, the
    layout of JAX's vmapped ensemble init."""
    return jax.tree_util.tree_map(
        lambda *a: jnp.stack(a),
        *[numpy_params(j_imag.RewardHead(), (jnp.zeros((1, Z)),), seed + i) for i in range(e)])


def _feed(monkeypatch, name: str, values):
    """The port's draw hook ``name`` returns JAX's draws in turn."""
    it = iter(values)
    monkeypatch.setattr(imag, name, lambda *a, **k: torch.as_tensor(np.array(next(it))))


def _feed_inits(monkeypatch, trees):
    """``init_module`` loads the next of JAX's initial trees."""
    it = iter(trees)

    def init(module, generator):
        module.load_state_dict(convert.params_state_dict(next(it)))
        return module

    monkeypatch.setattr(imag, "init_module", init)


def _close_tree(model, params, tol=PARAMS_TOL, what=""):
    want = convert.params_state_dict(params)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), err_msg=f"{what}{k}", **tol)


@pytest.mark.parametrize("space,ensemble", [("discrete", 1), ("discrete", 3),
                                            ("continuous", 1), ("continuous", 3)])
def test_imagination_update_matches(monkeypatch, space, ensemble):
    jm, wm_params, wm = _wm(space)
    continuous = space == "continuous"
    jpolicy = j_imag.ContinuousLatentPolicy() if continuous else j_imag.LatentPolicy()
    p_params = numpy_params(jpolicy, (jnp.zeros((1, Z)),), 1)
    anchor_params = numpy_params(jpolicy, (jnp.zeros((1, Z)),), 2) if ensemble > 1 else None
    rh = (_stacked_head_params(3, 3) if ensemble > 1
          else numpy_params(j_imag.RewardHead(), (jnp.zeros((1, Z)),), 3))
    z0 = np.random.default_rng(4).uniform(-1, 1, (B, Z)).astype(np.float32)
    kw = dict(horizon=4, gamma=0.9, entropy_coef=0.01, explore_std=0.2)
    if ensemble > 1:
        kw.update(disagree_coef=1.0, anchor_coef=0.3, uncertainty_stop=0.25)
    tx = optax.adam(3e-4)
    update = j_imag.make_imagination_update(
        jm, wm_params, j_imag.RewardHead(), rh, jpolicy, tx, ensemble=ensemble,
        anchor_params=anchor_params, **kw)
    key = jax.random.PRNGKey(7)
    new_params, _, j_metrics = update(p_params, tx.init(p_params), jnp.asarray(z0), key)

    keys = jax.random.split(key, kw["horizon"])
    draw = jax.random.normal if continuous else jax.random.gumbel
    shape = (B, 2) if continuous else (B, 9)
    _feed(monkeypatch, "draw_normal" if continuous else "draw_gumbel",
          [draw(k, shape) for k in keys])
    policy = _port(p_params, continuous)
    anchor = None if anchor_params is None else _port(anchor_params, continuous)
    opt = torch.optim.Adam(policy.parameters(), lr=3e-4, betas=ADAM_BETAS, eps=ADAM_EPS)
    head = _port(rh)
    assert isinstance(head, imag.HeadEnsemble if ensemble > 1 else imag.RewardHead)
    p_update = imag.make_imagination_update(wm, head, policy, opt, anchor=anchor, **kw)
    metrics = p_update(torch.from_numpy(z0), None)
    assert set(metrics) == set(j_metrics)
    for k in j_metrics:
        np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    if ensemble > 1:
        assert 0.0 < float(metrics["alive_frac"]) < 1.0   # the stop cut some rows
    _close_tree(policy, new_params)


def _jax_chain(key, steps, shape, n):
    """The minibatch rows JAX's training loops draw: one split per step."""
    out = []
    for _ in range(steps):
        key, ks = jax.random.split(key)
        out.append(jax.random.randint(ks, shape, 0, n))
    return out


@pytest.mark.parametrize("ensemble", [1, 3])
def test_train_reward_head_matches(monkeypatch, ensemble):
    rng = np.random.default_rng(5)
    zs = rng.uniform(-1, 1, (N, Z)).astype(np.float32)
    rewards = rng.normal(size=N).astype(np.float32)
    key = jax.random.PRNGKey(8)
    _, j_params, j_hist = j_imag.train_reward_head(jnp.asarray(zs), jnp.asarray(rewards), key,
                                                   steps=6, batch=8, ensemble=ensemble)
    key, ki = jax.random.split(key)
    head = j_imag.RewardHead()
    inits = ([jax.tree_util.tree_map(lambda a, i=i: a[i], jax.vmap(
        lambda k: head.init(k, jnp.asarray(zs[:1]))["params"])(jax.random.split(ki, ensemble)))
        for i in range(ensemble)] if ensemble > 1
        else [head.init(ki, jnp.asarray(zs[:1]))["params"]])
    _feed_inits(monkeypatch, inits)
    _feed(monkeypatch, "draw_indices",
          _jax_chain(key, 6, (ensemble, 8) if ensemble > 1 else (8,), N))
    got, hist = imag.train_reward_head(torch.from_numpy(zs), torch.from_numpy(rewards), None,
                                       None, steps=6, batch=8, ensemble=ensemble)
    np.testing.assert_allclose(hist, j_hist, rtol=1e-5)
    _close_tree(got, j_params)


@pytest.mark.parametrize("continuous", [False, True])
def test_train_latent_bc_matches(monkeypatch, continuous):
    rng = np.random.default_rng(6)
    zs = rng.uniform(-1, 1, (N, Z)).astype(np.float32)
    targets = (rng.uniform(-1, 1, (N, 2)).astype(np.float32) if continuous
               else rng.integers(0, 9, N).astype(np.int32))
    jpolicy = j_imag.ContinuousLatentPolicy() if continuous else j_imag.LatentPolicy()
    key = jax.random.PRNGKey(9)
    j_params, j_hist = j_imag.train_latent_bc(jpolicy, jnp.asarray(zs), jnp.asarray(targets),
                                              key, steps=6, batch=8, continuous=continuous)
    key, ki = jax.random.split(key)
    init = jpolicy.init(ki, jnp.asarray(zs[:1]))["params"]
    _feed_inits(monkeypatch, [init])
    _feed(monkeypatch, "draw_indices", _jax_chain(key, 6, (8,), N))
    policy = (imag.ContinuousLatentPolicy(Z) if continuous else imag.LatentPolicy(Z))
    got, hist = imag.train_latent_bc(policy, torch.from_numpy(zs), torch.from_numpy(targets),
                                     None, None, steps=6, batch=8, continuous=continuous)
    np.testing.assert_allclose(hist, j_hist, rtol=1e-5)
    _close_tree(got, j_params)


@pytest.mark.parametrize("space", ["discrete", "continuous"])
def test_latent_policy_fn_matches(space):
    jm, wm_params, wm = _wm(space, seed=10)
    continuous = space == "continuous"
    jpolicy = j_imag.ContinuousLatentPolicy() if continuous else j_imag.LatentPolicy()
    p_params = numpy_params(jpolicy, (jnp.zeros((1, Z)),), 11)
    obs = np.random.default_rng(12).random((5, HW, HW, 4), np.float32)
    want = np.asarray(j_imag.latent_policy_fn(jm, wm_params, jpolicy, p_params)(
        jnp.asarray(obs)))
    got = imag.latent_policy_fn(wm, _port(p_params, continuous))(torch.from_numpy(obs))
    if continuous:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("family", ["world_model", "rnn_policy", "vit", "stacked_head"])
def test_checkpoint_from_jax_restores(family):
    if family == "world_model":
        params = _wm("discrete", seed=13)[1]
    elif family == "rnn_policy":
        jm = JRecurrent(hidden=HID, dtype=jnp.float32)
        params = numpy_params(jm, (jm.example_input(1, 64, 64, 2),), 14)
    elif family == "vit":
        jm = JViT(obs_size=4, patch=8, dim=32, depth=2, heads=2, dtype=jnp.float32)
        params = numpy_params(jm, (jm.example_input(1, 64, 64),), 15)
    else:
        params = _stacked_head_params(3, 16)
    opt_state = optax.adam(1e-3).init(params)
    payload = convert.checkpoint_from_jax({"params": params, "opt_state": opt_state,
                                           "step": np.asarray(4)})
    model = convert.model_for_params(params, torch.float32)
    model.load_state_dict(payload["params"])
    assert payload["step"] == 4
    _close_tree(model, params, dict(rtol=0, atol=0))
