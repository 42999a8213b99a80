"""The slice end to end: one closed-loop ``make_rollout`` in each package
from the same carry and the same spawn pool, over 8 steps, with the expert
and with an fp32 ``PolicyCNN`` in the loop.

The JAX rollout runs its fast Pallas kernel in interpret mode (patched the
way tests/test_render.py does). Tolerances: uint8 frames within the fast
kernel's tolerance (mean|d| < 2e-3, < 1 % of pixels off by more than
2/255); actions and episode flags equal; states and controls allclose in
fp32 (rtol 1e-5, atol 1e-4).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import carla_imitation_learning_tpu.ops.raster_fast as j_raster_fast
from carla_imitation_learning_tpu.models import PolicyCNN as JPolicyCNN
from carla_imitation_learning_tpu.render.pipeline import RenderConfig as JRenderConfig
from carla_imitation_learning_tpu.sim import SimParams as JParams
from carla_imitation_learning_tpu.sim import make_town
from carla_imitation_learning_tpu.training.closed_loop import make_rollout as j_make_rollout
from carla_imitation_learning_tpu.training.closed_loop import rollout_spawn_pool
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch.models import PolicyCNN
from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
from carla_imitation_learning_tpu_torch.sim.world import SimParams
from carla_imitation_learning_tpu_torch.training.closed_loop import make_rollout

H = W = 64
N_ENVS, N_STEPS = 3, 8
TOWN = make_town(blocks=2, n_buildings=6, n_lights=2)
J_PARAMS, P_PARAMS = JParams(n_agents=3), SimParams(n_agents=3)
J_RCFG = JRenderConfig(H, W, max_triangles=256, backend="pallas")
P_RCFG = RenderConfig(H, W, max_triangles=256)
FLAGS = ("action", "expert_action", "done", "collision", "offroad",
         "red_light", "ran_red", "traffic", "command")
FLOATS = ("speed", "sensor", "steer", "throttle", "brake", "expert_steer",
          "expert_accel", "route_ds")


def _j_rollout(policy_fn):
    orig = j_raster_fast.rasterize_luma_fast
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_raster_fast, "rasterize_luma_fast",
                   functools.partial(orig, interpret=True))
        return j_make_rollout(J_PARAMS, TOWN, J_RCFG, policy_fn)


@pytest.fixture(scope="module")
def start():
    """A JAX fleet carry with one env close to its episode limit (so an
    auto-reset from the pool happens inside the window) and the pool."""
    init_fn, _ = _j_rollout(None)
    states, framebuf, just_reset = init_fn(jax.random.PRNGKey(3), N_ENVS)
    states = states.replace(t=jnp.asarray([0, 396, 10], jnp.int32))
    return (states, framebuf, just_reset), rollout_spawn_pool(J_PARAMS, TOWN)


def _frames_close(got_u8, want_u8, what):
    d = np.abs(got_u8.astype(np.float32) - want_u8.astype(np.float32)) / 255.0
    assert d.mean() < 2e-3, f"{what}: mean diff {d.mean()}"
    assert (d > 2 / 255).mean() < 0.01, f"{what}: {(d > 2 / 255).mean():.3%} pixels off"


def _compare(j_out, p_out):
    (j_carry, j_traj), (p_carry, p_traj) = j_out, p_out
    for key in FLAGS:
        np.testing.assert_array_equal(p_traj[key].numpy(),
                                      np.asarray(j_traj[key]).astype(np.int64)
                                      if p_traj[key].dtype == torch.int64
                                      else np.asarray(j_traj[key]), err_msg=key)
    for key in FLOATS:
        np.testing.assert_allclose(p_traj[key].numpy(), np.asarray(j_traj[key]),
                                   rtol=1e-5, atol=1e-4, err_msg=key)
    for t in range(N_STEPS):
        _frames_close(p_traj["gray"][t].numpy(), np.asarray(j_traj["gray"][t]),
                      f"frame {t}")
    _frames_close(p_carry[1].numpy(), np.asarray(j_carry[1]), "final window")
    np.testing.assert_array_equal(p_carry[2].numpy(), np.asarray(j_carry[2]))
    j_state = convert.world_state_from_jax(j_carry[0])
    for f in dataclasses.fields(j_state):
        want, got = getattr(j_state, f.name), getattr(p_carry[0], f.name)
        if got.dtype == torch.int64:
            assert torch.equal(got, want), f.name
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                       atol=1e-4, err_msg=f.name)
    assert np.asarray(j_traj["done"]).any()   # the reset path ran


def test_expert_rollout_matches(start):
    carry, pool = start
    _, j_roll = _j_rollout(None)
    j_out = j_roll(carry, N_STEPS)
    _, p_roll = make_rollout(P_PARAMS, convert.town_from_jax(TOWN), P_RCFG, None,
                             spawn_pool=convert.spawn_pool_from_jax(pool), device="cpu")
    _compare(j_out, p_roll(convert.carry_from_jax(carry), N_STEPS))


def test_policy_rollout_matches(start):
    carry, pool = start
    jmodel = JPolicyCNN(dtype=jnp.float32)
    params = jmodel.init(jax.random.PRNGKey(5), jnp.zeros((1, H, W, 4)))["params"]
    _, j_roll = _j_rollout(
        lambda obs: jnp.argmax(jmodel.apply({"params": params}, obs), axis=-1))
    j_out = j_roll(carry, N_STEPS)
    tmodel = PolicyCNN(dtype=torch.float32)
    tmodel.load_state_dict(convert.policy_state_dict(params))
    _, p_roll = make_rollout(P_PARAMS, convert.town_from_jax(TOWN), P_RCFG,
                             lambda obs: tmodel(obs).argmax(-1),
                             spawn_pool=convert.spawn_pool_from_jax(pool), device="cpu")
    _compare(j_out, p_roll(convert.carry_from_jax(carry), N_STEPS))


def test_entry_points_refuse_missing_card():
    """Entry points default to the card and raise without one; the CPU is
    used only when asked for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_rollout(P_PARAMS, convert.town_from_jax(TOWN), P_RCFG, None)
