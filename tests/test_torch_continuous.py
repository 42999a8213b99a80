"""Continuous control in the PyTorch port vs the JAX package, fp32 on the
CPU, weights carried across with ``convert``:

- ``control_to_discrete_label`` on a dense grid of the control square and
  on the reference table's exact pairs (where it equals
  ``continuous_to_discrete``);
- the ``ContinuousPolicyCNN`` forward allclose in fp32;
- ``continuous_bc_loss_fn``: loss and metrics rtol 1e-5, gradients rtol
  1e-4 / atol 1e-6;
- a continuous rollout (``control_space="continuous"``) from the JAX carry
  and pool, with the policy's controls scaled past the unit square: the
  executed controls clipped, ``traj["action"]`` the label of the executed
  control, equal to the JAX package's (JAX's kernel B in interpret mode);
- ``DeviceDataset(continuous_labels=...)`` batches bit for bit, their
  alignment with the labelled frame, and the validation messages;
- continuous DAgger: the store's actions and controls stay the expert's."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import carla_imitation_learning_tpu.ops.raster_fast as j_raster_fast
from carla_imitation_learning_tpu.data import actions as j_actions
from carla_imitation_learning_tpu.data.pipeline import DeviceDataset as JDataset
from carla_imitation_learning_tpu.data.pipeline import FrameStore as JStore
from carla_imitation_learning_tpu.models import ContinuousPolicyCNN as JCont
from carla_imitation_learning_tpu.render.pipeline import RenderConfig as JRender
from carla_imitation_learning_tpu.sim import SimParams as JParams
from carla_imitation_learning_tpu.sim import make_town as j_make_town
from carla_imitation_learning_tpu.training import closed_loop as j_loop
from carla_imitation_learning_tpu.training import losses as j_losses
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch.data import actions
from carla_imitation_learning_tpu_torch.data.pipeline import DeviceDataset, FrameStore
from carla_imitation_learning_tpu_torch.models import ContinuousPolicyCNN
from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
from carla_imitation_learning_tpu_torch.sim.world import SimParams
from carla_imitation_learning_tpu_torch.training import closed_loop as p_loop
from carla_imitation_learning_tpu_torch.training import losses
from test_torch_rollout import _frames_close

HW, BATCH = 32, 8
SCALE, SHIFT = [12.0, 1.6], [0.0, 0.5]   # the rollout policy's controls, past the square


def _jax_params(hw: int = HW, seed: int = 0):
    shapes = jax.eval_shape(JCont(dtype=jnp.float32).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, hw, hw, 4)))["params"]
    rng = np.random.default_rng(seed)

    def draw(s):
        scale = 0.1 if len(s.shape) == 1 else 1 / np.sqrt(np.prod(s.shape[:-1]))
        return jnp.asarray((rng.normal(size=s.shape) * scale).astype(np.float32))

    return jax.tree_util.tree_map(draw, shapes)


def _port_model(params):
    model = ContinuousPolicyCNN(dtype=torch.float32)
    model.load_state_dict(convert.policy_state_dict(params))
    return model


def test_label_on_the_control_square():
    g = np.linspace(-1.0, 1.0, 81, dtype=np.float32)
    steer, accel = np.meshgrid(g, g, indexing="ij")
    steer = np.concatenate([steer.ravel(), [0.05, -0.05, 0.0500001, -0.0500001]]).astype(np.float32)
    accel = np.concatenate([accel.ravel(), [0.75, 0.7500001, 0.0, -0.0]]).astype(np.float32)
    throttle, brake = np.maximum(accel, 0), np.maximum(-accel, 0)
    want = j_actions.control_to_discrete_label(jnp.asarray(steer), jnp.asarray(throttle),
                                               jnp.asarray(brake))
    got = actions.control_to_discrete_label(torch.from_numpy(steer), torch.from_numpy(throttle),
                                            torch.from_numpy(brake))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(got.tolist()) == set(range(9))
    # on the reference table's pairs it is the reference map
    for s in (-1.0, -0.05, 0.0, 0.3):
        for thr, brk in ((1.0, 0.0), (0.5, 0.0), (0.0, 1.0)):
            t = lambda v: torch.tensor([v], dtype=torch.float32)  # noqa: E731
            assert int(actions.control_to_discrete_label(t(s), t(thr), t(brk))) == \
                int(actions.continuous_to_discrete(t(s), t(thr), t(brk)))


def test_forward_matches_flax():
    params = _jax_params()
    x = np.random.default_rng(1).uniform(0, 1, (BATCH, HW, HW, 4)).astype(np.float32)
    want = JCont(dtype=jnp.float32).apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = _port_model(params)(torch.from_numpy(x))
    assert got.shape == (BATCH, 2) and got.abs().max() <= 1.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def _store(n: int = 60, seed: int = 0):
    base = JStore.synthetic(n=n, height=HW, width=HW, seed=seed)
    rng = np.random.default_rng(seed)
    labels = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n)], 1).astype(np.float32)
    starts = np.zeros(n, bool)
    starts[[0, 17, 40]] = True
    j = JStore(frames=base.frames, actions=base.actions, traffic=base.traffic,
               sensors=base.sensors, starts=starts)
    p = FrameStore(frames=j.frames, actions=j.actions, traffic=j.traffic, sensors=j.sensors,
                   starts=starts)
    return j, p, labels


def test_loss_and_gradients_match():
    params = _jax_params(seed=2)
    j_store, p_store, labels = _store()
    jb = next(iter(JDataset(j_store, BATCH, continuous_labels=labels)))
    pb = next(iter(DeviceDataset(p_store, BATCH, continuous_labels=labels, device="cpu")))
    apply = JCont(dtype=jnp.float32).apply
    loss_j = j_losses.continuous_bc_loss_fn(1.0, 0.5)

    (_, j_m), j_grads = jax.jit(jax.value_and_grad(
        lambda p: loss_j(p, apply, jb), has_aux=True))(params)
    model = _port_model(params)
    loss, metrics = losses.continuous_bc_loss_fn(1.0, 0.5)(model, pb)
    loss.backward()
    assert set(metrics) == set(j_m)
    for k in j_m:
        np.testing.assert_allclose(float(metrics[k]), float(j_m[k]), rtol=1e-5, err_msg=k)
    want = convert.policy_state_dict(j_grads)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_continuous_batches_and_validation():
    j_store, p_store, labels = _store(seed=3)
    j_ds = JDataset(j_store, BATCH, shuffle=True, seed=2, continuous_labels=labels)
    p_ds = DeviceDataset(p_store, BATCH, shuffle=True, seed=2, continuous_labels=labels,
                         device="cpu")
    for jb, pb in zip(j_ds, p_ds):
        for j, p in zip(jb, pb):
            np.testing.assert_array_equal(p.numpy(), np.asarray(j))
        assert pb[1].dtype == torch.float32 and pb[1].shape == (BATCH, 2)
    # alignment: the label is the row of the labelled frame (start + 4)
    order = p_ds.epoch_indices()[:BATCH]
    x, y = p_ds.make_batch(order)
    idx = p_ds.start_indices(order).numpy()
    np.testing.assert_array_equal(y.numpy(), labels[idx + 4])
    np.testing.assert_array_equal(torch.round(x[..., 0] * 255).numpy(),
                                  p_store.frames[idx].astype(np.float32))
    with pytest.raises(ValueError, match="exclusive"):
        DeviceDataset(p_store, BATCH, continuous_labels=labels, cil=True, device="cpu")
    for bad in (labels[:, 0], labels[:-1]):
        with pytest.raises(ValueError, match=r"\(n_frames, d\)"):
            DeviceDataset(p_store, BATCH, continuous_labels=bad, device="cpu")


@pytest.fixture(scope="module")
def jax_continuous_rollout():
    """The JAX package's continuous rollout (kernel B in interpret mode) of
    3 envs × 8 steps at 64², env 1 close to its episode limit, with the
    policy's steer scaled by 12 and its acceleration moved up by 0.5 and
    scaled by 1.6, so that the clip acts on the steer."""
    town = j_make_town(blocks=2, n_buildings=6, n_lights=2)
    jp = JParams(n_agents=3)
    params = _jax_params(hw=64, seed=4)
    model = JCont(dtype=jnp.float32)
    orig = j_raster_fast.rasterize_luma_fast
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_raster_fast, "rasterize_luma_fast", functools.partial(orig, interpret=True))
        init_fn, roll = j_loop.make_rollout(
            jp, town, JRender(64, 64, max_triangles=256, backend="pallas"),
            lambda obs: (model.apply({"params": params}, obs) + jnp.asarray(SHIFT))
            * jnp.asarray(SCALE),
            control_space="continuous")
        states, framebuf, just_reset = init_fn(jax.random.PRNGKey(3), 3)
        carry = (states.replace(t=jnp.asarray([0, 396, 10], jnp.int32)), framebuf, just_reset)
        _, traj = roll(carry, 8)
    return town, params, carry, j_loop.rollout_spawn_pool(jp, town), traj


def test_continuous_rollout_matches(jax_continuous_rollout):
    town, params, carry, pool, j_traj = jax_continuous_rollout
    model = _port_model(params)
    _, roll = p_loop.make_rollout(SimParams(n_agents=3), convert.town_from_jax(town),
                                  RenderConfig(64, 64, max_triangles=256),
                                  lambda obs: (model(obs) + torch.tensor(SHIFT))
                                  * torch.tensor(SCALE),
                                  spawn_pool=convert.spawn_pool_from_jax(pool),
                                  control_space="continuous", device="cpu")
    _, traj = roll(convert.carry_from_jax(carry), 8)
    for key in ("action", "expert_action", "done", "collision", "offroad", "command"):
        np.testing.assert_array_equal(traj[key].numpy(), np.asarray(j_traj[key]), err_msg=key)
    for key in ("steer", "throttle", "brake", "speed", "sensor", "route_ds"):
        np.testing.assert_allclose(traj[key].numpy(), np.asarray(j_traj[key]), rtol=1e-5,
                                   atol=1e-4, err_msg=key)
    for t in range(8):
        _frames_close(traj["gray"][t].numpy(), np.asarray(j_traj["gray"][t]), f"frame {t}")
    steer, thr, brk = traj["steer"], traj["throttle"], traj["brake"]
    assert steer.abs().max() <= 1.0 and thr.max() <= 1.0 and brk.max() <= 1.0
    assert (thr * brk == 0).all() and (steer.abs() == 1.0).any()
    assert torch.equal(traj["action"], actions.control_to_discrete_label(steer, thr, brk))


def test_continuous_dagger_labels_stay_the_experts():
    """A continuous policy drives a DAgger round: the executed controls are
    the policy's, the store's actions and (steer, accel) controls the
    expert's, env-major."""
    town = convert.town_from_jax(j_make_town(blocks=2, n_buildings=6, n_lights=2))
    model = _port_model(_jax_params(seed=6))
    store, _, traj = p_loop.dagger_iteration(
        SimParams(n_agents=2), town, RenderConfig(32, 32, max_triangles=256),
        lambda obs: model(obs), torch.Generator().manual_seed(0), n_envs=3, n_steps=10,
        control_space="continuous", device="cpu")

    def flat(x):
        return x.transpose(0, 1).reshape((-1,) + tuple(x.shape[2:])).numpy()

    np.testing.assert_array_equal(store.actions, flat(traj["expert_action"]))
    np.testing.assert_array_equal(store.controls[:, 0], flat(traj["expert_steer"]))
    np.testing.assert_array_equal(store.controls[:, 1], flat(traj["expert_accel"]))
    assert (flat(traj["steer"]) != flat(traj["expert_steer"])).any()
    assert not np.isin(flat(traj["throttle"]), [0.0, 0.5, 1.0]).all()


def test_adam_step_from_jax_train_state():
    """``convert.train_state_from_jax(continuous=True)`` builds the tanh
    policy; two Adam steps of ``continuous_bc_loss_fn`` with the clip from
    the JAX state agree at rtol 1e-4 / atol 1e-5."""
    from carla_imitation_learning_tpu.training import steps as j_steps
    from carla_imitation_learning_tpu_torch.training import steps

    cfg = {"LEARNING_RATE": 1e-3, "LR_MILESTONES": [], "gradient_clip_val": 0.5}
    params = _jax_params(seed=9)
    tx = j_steps.make_optimizer(cfg, steps_per_epoch=1)
    jstate = j_steps.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                opt_state=tx.init(params),
                                apply_fn=JCont(dtype=jnp.float32).apply, tx=tx,
                                ema_params=None, ema_decay=0.0)
    pstate = convert.train_state_from_jax(jstate, steps.make_optimizer(cfg, 1), device="cpu",
                                          continuous=True)
    assert isinstance(pstate.model, ContinuousPolicyCNN)
    j_store, p_store, labels = _store(seed=10)
    jb = next(iter(JDataset(j_store, BATCH, continuous_labels=labels)))
    pb = next(iter(DeviceDataset(p_store, BATCH, continuous_labels=labels, device="cpu")))
    j_step = j_steps.make_train_step(j_losses.continuous_bc_loss_fn(), donate=False)
    p_step = steps.make_train_step(losses.continuous_bc_loss_fn())
    for _ in range(2):
        jstate, _ = j_step(jstate, jb, jax.random.PRNGKey(0))
        pstate, _ = p_step(pstate, pb)
    want = convert.policy_state_dict(jstate.params)
    for k, v in pstate.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-5, err_msg=k)
