"""The command-conditioned branched policy (CIL) of the PyTorch port vs
the JAX package, fp32 on the CPU at 32², weights carried across with
``convert``:

- the ``BranchedCILPolicy`` forward (logits and speed) allclose in fp32,
  and ``as_policy_fn`` clipping a command above n_commands − 1 into the
  last branch (a clip, not a wrap);
- ``cil_loss_fn``: loss rtol 1e-5, gradients rtol 1e-4 / atol 1e-6;
- ``DeviceDataset(cil=True)`` batches bit for bit, plain, balanced by
  ``command`` and by ``action_command``;
- one Adam step with the clip at rtol 1e-4 / atol 1e-5 (ROADMAP Queue 3,
  "Adam and near-zero gradients"); ``convert.checkpoint_from_jax``;
- a CIL policy driving ``make_rollout`` through the extras path on a
  goal-directed fleet: actions, commands and flags equal to the JAX
  package's, floats at rtol 1e-5 / atol 1e-4, frames within the fast
  raster's tolerance (JAX's kernel B in interpret mode)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import carla_imitation_learning_tpu.ops.raster_fast as j_raster_fast
from carla_imitation_learning_tpu.data.pipeline import DeviceDataset as JDataset
from carla_imitation_learning_tpu.data.pipeline import FrameStore as JStore
from carla_imitation_learning_tpu.models import BranchedCILPolicy as JCIL
from carla_imitation_learning_tpu.render.pipeline import RenderConfig as JRender
from carla_imitation_learning_tpu.sim import SimParams as JParams
from carla_imitation_learning_tpu.sim import make_town as j_make_town
from carla_imitation_learning_tpu.sim import planner as j_planner
from carla_imitation_learning_tpu.training import closed_loop as j_loop
from carla_imitation_learning_tpu.training import losses as j_losses
from carla_imitation_learning_tpu.training import steps as j_steps
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch.data.pipeline import DeviceDataset, FrameStore
from carla_imitation_learning_tpu_torch.models import BranchedCILPolicy
from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
from carla_imitation_learning_tpu_torch.sim.world import SimParams
from carla_imitation_learning_tpu_torch.training import losses, steps
from carla_imitation_learning_tpu_torch.training.closed_loop import make_rollout
from test_torch_rollout import _frames_close

HW, BATCH, N_CMD = 32, 8, 6
CLIP_CFG = {"LEARNING_RATE": 1e-3, "LR_MILESTONES": [], "gradient_clip_val": 0.5}


def _jax_params(hw: int = HW, seed: int = 0):
    """BranchedCILPolicy params drawn with numpy: kernels normal with std
    sqrt(1 / fan_in), biases normal with std 0.1."""
    model = JCIL(n_commands=N_CMD, dtype=jnp.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            *model.example_input(1, hw, hw))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, s):
        bias = path[-1].key in ("bias", "branch_b1", "branch_b2")
        scale = 0.1 if bias else 1 / np.sqrt(np.prod(s.shape[:-1]))
        return jnp.asarray((rng.normal(size=s.shape) * scale).astype(np.float32))

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _port_model(params, dtype=torch.float32):
    model = BranchedCILPolicy(n_commands=N_CMD, dtype=dtype)
    model.load_state_dict(convert.cil_state_dict(params))
    return model


def _store(n: int = 80, seed: int = 0):
    """A JAX store with every command and action present, and the port's
    store of the same arrays."""
    base = JStore.synthetic(n=n, height=HW, width=HW, seed=seed)
    rng = np.random.default_rng(seed)
    commands = rng.integers(0, N_CMD, n).astype(np.int32)
    sensors = base.sensors.copy()
    sensors[:, 2] = rng.uniform(0, 9, n).astype(np.float32)
    starts = np.zeros(n, bool)
    starts[[0, 23, 50]] = True
    j = JStore(frames=base.frames, actions=base.actions, traffic=base.traffic,
               sensors=sensors, commands=commands, starts=starts)
    p = FrameStore(frames=j.frames, actions=j.actions, traffic=j.traffic, sensors=sensors,
                   commands=commands, starts=starts)
    return j, p


def test_forward_matches_flax():
    params = _jax_params()
    jmodel = JCIL(n_commands=N_CMD, dtype=jnp.float32)
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (BATCH, HW, HW, 4)).astype(np.float32)
    speed = rng.uniform(0, 9, BATCH).astype(np.float32)
    cmd = np.arange(BATCH) % N_CMD
    j_logits, j_speed = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(speed),
                                     jnp.asarray(cmd, jnp.int32))
    model = _port_model(params)
    with torch.no_grad():
        logits, pred = model(torch.from_numpy(x), torch.from_numpy(speed), torch.from_numpy(cmd))
    assert logits.dtype == torch.float32 and pred.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pred.numpy(), np.asarray(j_speed), rtol=1e-5, atol=1e-6)
    # the policy clips commands above the last branch into it
    wild = np.array([0, 5, 7, 9, 3, 12, 6, 1])
    j_act = jmodel.as_policy_fn(params)(
        jnp.asarray(x), {"speed": jnp.asarray(speed), "command": jnp.asarray(wild, jnp.int32)})
    act = model.as_policy_fn()(torch.from_numpy(x), {"speed": torch.from_numpy(speed),
                                                     "command": torch.from_numpy(wild)})
    np.testing.assert_array_equal(act.numpy(), np.asarray(j_act))
    clipped = model.as_policy_fn()(torch.from_numpy(x), {
        "speed": torch.from_numpy(speed), "command": torch.from_numpy(np.minimum(wild, 5))})
    assert torch.equal(act, clipped)


def test_bf16_forward_close():
    """bf16 compute with float32 parameters: within bf16's spread of the
    flax model's bf16 forward."""
    params = _jax_params()
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, (BATCH, HW, HW, 4)).astype(np.float32)
    speed = rng.uniform(0, 9, BATCH).astype(np.float32)
    cmd = np.arange(BATCH) % N_CMD
    j_logits, _ = JCIL(n_commands=N_CMD).apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(speed), jnp.asarray(cmd, jnp.int32))
    with torch.no_grad():
        logits, _ = _port_model(params, torch.bfloat16)(
            torch.from_numpy(x), torch.from_numpy(speed), torch.from_numpy(cmd))
    want = np.asarray(j_logits)
    assert logits.dtype == torch.float32
    assert np.abs(logits.numpy() - want).max() < 3e-2 * np.abs(want).max()


def test_loss_and_gradients_match():
    params = _jax_params()
    j_store, p_store = _store()
    jb = next(iter(JDataset(j_store, BATCH, cil=True)))
    pb = next(iter(DeviceDataset(p_store, BATCH, cil=True, device="cpu")))
    apply = JCIL(n_commands=N_CMD, dtype=jnp.float32).apply

    def wrapped(p):
        return j_losses.cil_loss_fn(0.1)(p, apply, jb)

    (j_loss, j_m), j_grads = jax.jit(jax.value_and_grad(wrapped, has_aux=True))(params)
    model = _port_model(params)
    loss, metrics = losses.cil_loss_fn(0.1)(model, pb)
    loss.backward()
    assert set(metrics) == set(j_m)
    for k in j_m:
        np.testing.assert_allclose(float(metrics[k]), float(j_m[k]), rtol=1e-5, err_msg=k)
    want = convert.cil_state_dict(j_grads)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("balance", [None, "command", "action_command"])
def test_cil_batches_bit_for_bit(balance):
    j_store, p_store = _store(seed=3)
    kw = dict(shuffle=True, seed=4, cil=True)
    if balance:
        kw.update(balanced=True, balance_key=balance)
    j_batches = list(JDataset(j_store, BATCH, **kw))
    p_batches = list(DeviceDataset(p_store, BATCH, device="cpu", **kw))
    assert len(j_batches) == len(p_batches) > 3
    for jb, pb in zip(j_batches, p_batches):
        assert len(pb) == 4
        for name, j, p in zip(("x", "speed", "command", "y"), jb, pb):
            np.testing.assert_array_equal(p.numpy(), np.asarray(j).astype(p.numpy().dtype),
                                          err_msg=name)
        assert pb[2].dtype == torch.int64 and pb[1].dtype == torch.float32
    if balance:
        cmds = np.concatenate([p[2].numpy() for p in p_batches])
        assert len(np.unique(cmds)) == N_CMD


def test_adam_step_and_checkpoint():
    params = _jax_params(seed=5)
    model = JCIL(n_commands=N_CMD, dtype=jnp.float32)
    tx = j_steps.make_optimizer(CLIP_CFG, steps_per_epoch=1)
    jstate = j_steps.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                opt_state=tx.init(params), apply_fn=model.apply, tx=tx,
                                ema_params=None, ema_decay=0.0)
    pstate = convert.train_state_from_jax(jstate, steps.make_optimizer(CLIP_CFG, 1),
                                          device="cpu")
    assert isinstance(pstate.model, BranchedCILPolicy)
    j_store, p_store = _store(seed=6)
    jb = next(iter(JDataset(j_store, BATCH, cil=True)))
    pb = next(iter(DeviceDataset(p_store, BATCH, cil=True, device="cpu")))
    j_step = j_steps.make_train_step(j_losses.cil_loss_fn(0.1), donate=False)
    p_step = steps.make_train_step(losses.cil_loss_fn(0.1))
    for _ in range(2):
        jstate, _ = j_step(jstate, jb, jax.random.PRNGKey(0))
        pstate, _ = p_step(pstate, pb)
    want = convert.cil_state_dict(jstate.params)
    for k, v in pstate.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-5, err_msg=k)
    payload = convert.checkpoint_from_jax(
        {"params": jax.device_get(jstate.params), "opt_state": jax.device_get(jstate.opt_state),
         "step": np.asarray(jstate.step)})
    assert payload["step"] == 2 and set(payload["params"]) == set(want)
    for k in want:
        assert torch.equal(payload["params"][k], want[k]), k


def test_flax_init_draws_branches():
    """``flax_init_`` draws the branch kernels with fan-in K·F (flax's
    variance scaling over a stacked kernel) and zeroes their biases."""
    model = steps.flax_init_(BranchedCILPolicy(n_commands=N_CMD), torch.Generator().manual_seed(0))
    w1 = model.branch_w1.detach()
    assert abs(float(w1.std()) - (1 / np.sqrt(N_CMD * 128))) < 0.1 / np.sqrt(N_CMD * 128)
    assert not model.branch_b1.detach().any() and not model.branch_b2.detach().any()


def test_cil_policy_rollout_matches():
    """3 envs × 8 steps on a 2-lane super-block town with turn fans and the
    JAX planner's tables for 3 goals, goals 0, 1, 2 (env 1 close to its
    episode limit), the fp32 CIL policy driving on speed and command."""
    town = j_make_town(blocks=2, n_buildings=6, n_lights=2, superblocks=True, turn_fans=True,
                       lanes_per_direction=2)
    town = j_planner.plan_to_goals(town, j_planner.sample_goals(town, 5, 3))
    H = W = 32
    jp = JParams(n_agents=3, lane_change_period=160)
    params = _jax_params(hw=H, seed=7)
    jmodel = JCIL(n_commands=N_CMD, dtype=jnp.float32)
    orig = j_raster_fast.rasterize_luma_fast
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_raster_fast, "rasterize_luma_fast", functools.partial(orig, interpret=True))
        init_fn, j_roll = j_loop.make_rollout(jp, town, JRender(H, W, max_triangles=256,
                                                                backend="pallas"),
                                              jmodel.as_policy_fn(params))
        states, framebuf, just_reset = init_fn(jax.random.PRNGKey(3), 3)
        states = states.replace(t=jnp.asarray([0, 396, 10], jnp.int32))
        carry = j_loop.assign_goals((states, framebuf, just_reset), jnp.arange(3) % 3)
        j_carry, j_traj = j_roll(carry, 8)
    model = _port_model(params)
    _, p_roll = make_rollout(SimParams(n_agents=3, lane_change_period=160),
                             convert.town_from_jax(town), RenderConfig(H, W, max_triangles=256),
                             model.as_policy_fn(),
                             spawn_pool=convert.spawn_pool_from_jax(j_loop.rollout_spawn_pool(
                                 jp, town)), device="cpu")
    p_carry, p_traj = p_roll(convert.carry_from_jax(carry), 8)
    for key in ("action", "expert_action", "command", "done", "arrived", "collision",
                "offroad", "traffic"):
        np.testing.assert_array_equal(p_traj[key].numpy(),
                                      np.asarray(j_traj[key]).astype(p_traj[key].numpy().dtype),
                                      err_msg=key)
    for key in ("speed", "sensor", "steer", "throttle", "brake", "route_ds"):
        np.testing.assert_allclose(p_traj[key].numpy(), np.asarray(j_traj[key]), rtol=1e-5,
                                   atol=1e-4, err_msg=key)
    for t in range(8):
        _frames_close(p_traj["gray"][t].numpy(), np.asarray(j_traj["gray"][t]), f"frame {t}")
    np.testing.assert_array_equal(p_carry[0].goal.numpy(), [0, 1, 2])
    assert len(np.unique(p_traj["action"].numpy())) > 1


def test_online_windows_carry_speed_and_command():
    """Online DAgger's CIL buffer: the port's ``gather_windows_at`` with the
    speed and command grids as extras, at the (round, step) indices JAX's
    ``sample_windows(extras=...)`` draws, gives JAX's windows, labels,
    weights, speeds and commands."""
    from carla_imitation_learning_tpu.training import online_dagger as j_od
    from carla_imitation_learning_tpu_torch.training import online_dagger as p_od

    rng = np.random.default_rng(8)
    R, T, B = 2, 10, 3
    frames = rng.integers(0, 256, (R, T, B, 4, 4)).astype(np.uint8)
    labels = rng.integers(0, 9, (R, T, B)).astype(np.int32)
    dones = rng.uniform(size=(R, T, B)) < 0.1
    speeds = rng.uniform(0, 9, (R, T, B)).astype(np.float32)
    commands = rng.integers(0, N_CMD, (R, T, B)).astype(np.int32)
    key = jax.random.PRNGKey(9)
    want = j_od.sample_windows(key, jnp.asarray(frames), jnp.asarray(labels),
                               jnp.asarray(dones), r=jnp.int32(1), k_per_env=5, frame_skip=4,
                               extras=(jnp.asarray(speeds), jnp.asarray(commands)))
    kr, kt = jax.random.split(key)
    r_i = torch.from_numpy(np.array(jax.random.randint(kr, (B, 5), 0, 2))).long()
    t_i = torch.from_numpy(np.array(jax.random.randint(kt, (B, 5), 0, T))).long()
    got = p_od.gather_windows_at(torch.from_numpy(frames), torch.from_numpy(labels),
                                 torch.from_numpy(dones), r_i, t_i, 4,
                                 (torch.from_numpy(speeds), torch.from_numpy(commands)))
    assert len(got) == len(want) == 5
    for name, g, w in zip(("obs", "y", "weight", "speed", "command"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_rollout_passes_rng_and_policy_params():
    """A policy of three parameters gets the extras (with the ``policy_rng``
    generator under ``"rng"``) and ``rollout_fn``'s ``policy_params``; one
    of two gets the extras alone, and the speed and command are the state's
    before the step."""
    from carla_imitation_learning_tpu_torch.sim import world as p_world

    town = convert.town_from_jax(j_make_town(blocks=2, n_buildings=6, n_lights=2))
    params = SimParams(n_agents=2)
    gen = torch.Generator().manual_seed(3)
    seen = []

    def three(obs, extras, p):
        seen.append((extras["rng"] is gen, extras["sensor"].shape, p["action"]))
        return torch.full((obs.shape[0],), p["action"], dtype=torch.int64)

    init_fn, roll = make_rollout(params, town, RenderConfig(32, 32, max_triangles=256), three,
                                 policy_rng=gen, device="cpu")
    carry = init_fn(torch.Generator().manual_seed(0), 2)
    _, traj = roll(carry, 3, policy_params={"action": 7})
    assert seen == [(True, (2, 3), 7)] * 3 and (traj["action"] == 7).all()

    got = []

    def two(obs, extras):
        got.append((set(extras), extras["speed"].clone(), extras["command"].clone()))
        return torch.zeros(obs.shape[0], dtype=torch.int64)

    init_fn, roll = make_rollout(params, town, RenderConfig(32, 32, max_triangles=256), two,
                                 device="cpu")
    carry = init_fn(torch.Generator().manual_seed(0), 2)
    states = carry[0]
    _, traj = roll(carry, 2)
    assert got[0][0] == {"speed", "command", "sensor"}
    assert torch.equal(got[0][1], states.ego_v)
    assert torch.equal(got[0][2], p_world.navigation_command(params, town, states))
    assert torch.equal(torch.stack([c for _, _, c in got]), traj["command"])
