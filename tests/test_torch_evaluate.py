"""``evaluate_policy`` of the PyTorch port vs the JAX package: the same
fleet start (the JAX init carry for the same key), the same spawn pool,
the expert driving; every driving metric agrees (counts equal, rates
allclose at rtol 1e-5)."""

import functools

import jax
import numpy as np
import pytest
import torch

import carla_imitation_learning_tpu.ops.raster_fast as j_raster_fast
from carla_imitation_learning_tpu.render.pipeline import RenderConfig as JRenderConfig
from carla_imitation_learning_tpu.sim import SimParams as JParams
from carla_imitation_learning_tpu.sim import make_town
from carla_imitation_learning_tpu.training import closed_loop as j_loop
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
from carla_imitation_learning_tpu_torch.sim.world import SimParams
from carla_imitation_learning_tpu_torch.training.closed_loop import (
    driving_metrics, evaluate_policy, make_rollout,
)

H = W = 64
N_ENVS, N_STEPS = 3, 10
TOWN = make_town(blocks=2, n_buildings=6, n_lights=2)
J_PARAMS, P_PARAMS = JParams(n_agents=3), SimParams(n_agents=3)
P_RCFG = RenderConfig(H, W, max_triangles=256)


def test_driving_metrics_match_jax_evaluate_policy():
    rcfg = JRenderConfig(H, W, max_triangles=256, backend="pallas")
    key = jax.random.PRNGKey(21)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_raster_fast, "rasterize_luma_fast",
                   functools.partial(j_raster_fast.rasterize_luma_fast, interpret=True))
        want = j_loop.evaluate_policy(J_PARAMS, TOWN, rcfg, None, key,
                                      n_envs=N_ENVS, n_steps=N_STEPS)
        init_fn, _ = j_loop.make_rollout(J_PARAMS, TOWN, rcfg, None)
    carry = convert.carry_from_jax(init_fn(key, N_ENVS))
    pool = convert.spawn_pool_from_jax(j_loop.rollout_spawn_pool(J_PARAMS, TOWN))
    _, rollout_fn = make_rollout(P_PARAMS, convert.town_from_jax(TOWN), P_RCFG, None,
                                 spawn_pool=pool, device="cpu")
    _, traj = rollout_fn(carry, N_STEPS)
    got = driving_metrics(P_PARAMS, traj)
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, int):
            assert got[k] == w, k
        else:
            np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-7, err_msg=k)
    assert want["km_driven"] > 0


def test_evaluate_policy_runs_own_fleet():
    """The port's own entry point, from its own generator-drawn resets."""
    model = torch.nn.Linear(4, 9)

    def policy_fn(obs):
        return model(obs.mean(dim=(1, 2))).argmax(-1)

    out = evaluate_policy(P_PARAMS, convert.town_from_jax(TOWN), P_RCFG, policy_fn,
                          torch.Generator().manual_seed(0), n_envs=2, n_steps=6,
                          device="cpu")
    assert out["env_steps"] == 12
    assert all(v is None or np.isfinite(v) for v in out.values())
    assert 0.0 <= out["action_agreement"] <= 1.0
