"""The recurrent policy of the PyTorch port vs the JAX package on the CPU,
weights drawn with numpy and carried across with ``convert``:

- ``RecurrentPolicy`` over a (B, T) sequence in fp32 (logits and the final
  hidden state rtol 1e-5 / atol 1e-5), ``step`` against the sequence, and
  the bf16 path (logits within 5e-2 as the bf16 ``PolicyCNN`` test holds
  them; the hidden state stays float32);
- ``rnn_bc_loss_fn``: loss and accuracy rtol 1e-5, gradients rtol 1e-4 /
  atol 1e-6;
- ``SequenceDataset``: starts, batches and their order bit for bit over
  two epochs, with ``episode_len`` and ``store.starts`` masks, and the
  continuous actions;
- the rollout's policy carry: a counting policy (h' = h + 1) from one JAX
  carry with an auto-reset inside the window gives the same per-env counts
  as JAX's, so the state resets exactly where JAX's does; a fp32
  ``RecurrentPolicy`` in both rollouts takes the same actions and ends in
  the same hidden state; a continuous recurrent rollout raises;
- ``flax_init_`` draws the cells' hidden kernels orthogonal per gate."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import carla_imitation_learning_tpu.ops.raster_fast as j_raster_fast
from carla_imitation_learning_tpu.data import pipeline as j_pipe
from carla_imitation_learning_tpu.models import RecurrentPolicy as JRecurrent
from carla_imitation_learning_tpu.training import losses as j_losses
from carla_imitation_learning_tpu.training.closed_loop import make_rollout as j_make_rollout
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch.data import pipeline as p_pipe
from carla_imitation_learning_tpu_torch.models import RecurrentPolicy
from carla_imitation_learning_tpu_torch.models.rnn import GRUCell, LSTMCell
from carla_imitation_learning_tpu_torch.training import losses
from carla_imitation_learning_tpu_torch.training.closed_loop import make_rollout
from carla_imitation_learning_tpu_torch.training.steps import flax_init_
from test_torch_aux import numpy_params
from test_torch_rollout import (  # noqa: F401
    J_PARAMS, J_RCFG, N_ENVS, P_PARAMS, P_RCFG, TOWN, start,
)

HID, HW, T = 32, 64, 5


def _pair(jdtype=jnp.float32, dtype=torch.float32, seed=0):
    jm = JRecurrent(hidden=HID, dtype=jdtype)
    params = numpy_params(jm, (jm.example_input(1, HW, HW, T),), seed)
    model = convert.model_for_params(params, dtype)
    model.load_state_dict(convert.params_state_dict(params))
    return jm, params, model


def _frames(seed=1, b=3, t=T):
    return np.random.default_rng(seed).random((b, t, HW, HW, 1), np.float32)


def test_sequence_and_step_match():
    jm, params, model = _pair()
    assert isinstance(model, RecurrentPolicy) and model.hidden == HID
    x = _frames()
    logits_w, h_w = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        logits, h = model(torch.from_numpy(x))
        hs, steps = model.initial_state(3), []
        for t in range(T):
            hs, out = model.step(hs, torch.from_numpy(x[:, t]))
            steps.append(out)
    assert logits.shape == (3, T, 9) and h.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_w), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_w), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), logits.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(hs.numpy(), h.numpy(), rtol=1e-6, atol=1e-6)


def test_bf16_sequence_matches():
    jm, params, model = _pair(jnp.bfloat16, torch.bfloat16, seed=2)
    x = _frames(seed=3)
    logits_w, h_w = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        logits, h = model(torch.from_numpy(x))
    assert logits.dtype == torch.float32 and h.dtype == torch.float32
    assert h_w.dtype == jnp.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_w), rtol=0, atol=5e-2)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_w), rtol=0, atol=5e-2)


def test_rnn_bc_loss_and_gradients_match():
    jm, params, model = _pair(seed=4)
    x = _frames(seed=5)
    y = np.random.default_rng(6).integers(0, 9, (3, T)).astype(np.int32)
    (j_loss, j_m), j_grads = jax.value_and_grad(
        lambda p: j_losses.rnn_bc_loss_fn(p, jm.apply, (jnp.asarray(x), jnp.asarray(y))),
        has_aux=True)(params)
    loss, metrics = losses.rnn_bc_loss_fn(model, (torch.from_numpy(x), torch.from_numpy(y)))
    loss.backward()
    assert set(metrics) == set(j_m) == {"loss", "accuracy"}
    for k in j_m:
        np.testing.assert_allclose(float(metrics[k]), float(j_m[k]), rtol=1e-5, err_msg=k)
    want = convert.rnn_policy_state_dict(j_grads)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def _store(n=90, seed=0):
    store = p_pipe.FrameStore.synthetic(n=n, height=16, width=16, seed=seed)
    starts = np.zeros(n, bool)
    starts[[0, 23, 41, 42, 70]] = True
    store.starts = starts
    store.controls = np.random.default_rng(seed).uniform(-1, 1, (n, 2)).astype(np.float32)
    return store


@pytest.mark.parametrize("kw", [
    dict(episode_len=30, shuffle=True, seed=3), dict(episode_len=None, shuffle=False),
    dict(episode_len=45, shuffle=True, seed=1, continuous_actions=True),
], ids=["episodes", "plain", "continuous"])
def test_sequence_dataset_matches(kw):
    store = _store()
    j = j_pipe.SequenceDataset(store, batch_size=4, seq_len=6, **kw)
    p = p_pipe.SequenceDataset(store, batch_size=4, seq_len=6, device="cpu", **kw)
    np.testing.assert_array_equal(p.starts, j.starts)
    assert len(p) == len(j) > 1
    for _ in range(2):
        for (jf, ja), (pf, pa) in zip(j, p):
            assert pf.dtype == torch.float32 and pf.shape[-1] == 1
            np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))
            np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    with pytest.raises(ValueError, match="controls"):
        p_pipe.SequenceDataset(p_pipe.FrameStore.synthetic(n=20, height=16, width=16), 2,
                               continuous_actions=True, device="cpu")


def _j_recurrent_rollout(policy_fn, init):
    """JAX's recurrent rollout with its fast kernel in interpret mode, as
    ``test_torch_rollout`` builds it."""
    orig = j_raster_fast.rasterize_luma_fast
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_raster_fast, "rasterize_luma_fast", functools.partial(orig, interpret=True))
        return j_make_rollout(J_PARAMS, TOWN, J_RCFG, policy_fn, policy_carry_init=init)


def _p_rollout(policy_fn, init, pool):
    return make_rollout(P_PARAMS, convert.town_from_jax(TOWN), P_RCFG, policy_fn,
                        spawn_pool=convert.spawn_pool_from_jax(pool), device="cpu",
                        policy_carry_init=init)


def test_recurrent_carry_resets_like_jax(start):  # noqa: F811
    """A policy that counts its steps: after 8 steps each env's count is the
    steps since its last auto-reset, in both packages."""
    carry, pool = start
    _, j_roll = _j_recurrent_rollout(lambda obs, h: (jnp.zeros(obs.shape[0], jnp.int32), h + 1),
                                     lambda b: jnp.zeros((b, 1), jnp.float32))
    j_carry, j_traj = j_roll(carry + (jnp.full((N_ENVS, 1), 50.0),), 8)
    _, p_roll = _p_rollout(lambda obs, h: (torch.zeros(obs.shape[0], dtype=torch.int64), h + 1),
                           lambda b: torch.zeros(b, 1), pool)
    p_carry, p_traj = p_roll(convert.carry_from_jax(carry) + (torch.full((N_ENVS, 1), 50.0),),
                             8)
    np.testing.assert_array_equal(p_traj["done"].numpy(), np.asarray(j_traj["done"]))
    assert np.asarray(j_traj["done"]).any()
    np.testing.assert_array_equal(p_carry[3].numpy(), np.asarray(j_carry[3]))
    assert 0 < float(p_carry[3].min()) < 8 < float(p_carry[3].max())


def test_recurrent_policy_rollout_matches(start):  # noqa: F811
    carry, pool = start
    jm, params, model = _pair(seed=7)

    def j_policy(obs, h):
        h, logits = jm.apply({"params": params}, h, obs[..., -1:], method=JRecurrent.step)
        return jnp.argmax(logits, axis=-1).astype(jnp.int32), h

    @torch.no_grad()
    def p_policy(obs, h):
        h, logits = model.step(h, obs[..., -1:])
        return logits.argmax(-1), h

    _, j_roll = _j_recurrent_rollout(j_policy, lambda b: jnp.zeros((b, HID), jnp.float32))
    j_carry, j_traj = j_roll(carry + (jnp.zeros((N_ENVS, HID), jnp.float32),), 8)
    _, p_roll = _p_rollout(p_policy, lambda b: model.initial_state(b), pool)
    init = convert.carry_from_jax(carry) + (model.initial_state(N_ENVS),)
    p_carry, p_traj = p_roll(init, 8)
    for key in ("action", "done"):
        np.testing.assert_array_equal(p_traj[key].numpy(), np.asarray(j_traj[key]), err_msg=key)
    np.testing.assert_allclose(p_carry[3].numpy(), np.asarray(j_carry[3]), rtol=1e-4, atol=1e-4)


def test_continuous_recurrent_rollout_raises():
    with pytest.raises(NotImplementedError, match="recurrent"):
        make_rollout(P_PARAMS, convert.town_from_jax(TOWN), P_RCFG, lambda o, h: (o, h),
                     device="cpu", control_space="continuous",
                     policy_carry_init=lambda b: torch.zeros(b, 1))


@pytest.mark.parametrize("cell_cls,gates", [(LSTMCell, 4), (GRUCell, 3)], ids=["lstm", "gru"])
def test_flax_init_draws_cells_as_flax(cell_cls, gates):
    """``flax_init_``: each gate's (n, n) hidden kernel orthogonal (flax's
    recurrent kernel init), input kernels lecun-normal, biases zero."""
    cell = flax_init_(cell_cls(24, 32), torch.Generator().manual_seed(0))
    w_h = cell.w_h.detach()
    assert w_h.shape == (32, gates * 32)
    for g in range(gates):
        block = w_h[:, 32 * g:32 * (g + 1)]
        np.testing.assert_allclose((block.T @ block).numpy(), np.eye(32), atol=1e-5)
    assert abs(float(cell.w_i.detach().std()) * np.sqrt(24) - 1.0) < 0.1
    for name, p in cell.named_parameters():
        if name.startswith("b_"):
            assert not p.detach().any(), name
