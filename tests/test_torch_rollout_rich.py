"""The rich-scene collection rollout end to end: one expert ``make_rollout``
per package with ``record_semantic=True`` (the segmentation collection),
from the same carry and spawn pool, on the rich scene (facade bands,
markings, shadows, textures; T = 256), and a second short case with the
fused-quad kernel.

The JAX rollout runs its Pallas kernels in interpret mode, and its
approximate reciprocal is replaced by the exact one the port takes: in
interpret mode JAX computes it through bfloat16, which makes the 1 cm
shadows and 4 mm markings z-fight with the road (see
tests/test_torch_raster_quad_vec.py). Tolerances: ``traj["semantic"]``
equal; uint8 frames within the fast kernel's tolerance (mean|d| < 2e-3,
< 1 % of pixels off by more than 2/255); actions and episode flags equal;
states allclose (rtol 1e-5, atol 1e-4). The quad rollout's frames also stay
within the quad contract of the triangle rollout's (mean|d| < 1e-3, < 0.5 %
off by more than 2/255).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import carla_imitation_learning_tpu.ops.raster as j_raster
import carla_imitation_learning_tpu.ops.raster_fast as j_raster_fast
from carla_imitation_learning_tpu.render.pipeline import RenderConfig as JRenderConfig
from carla_imitation_learning_tpu.sim import SimParams as JParams
from carla_imitation_learning_tpu.sim import make_town
from carla_imitation_learning_tpu.training.closed_loop import make_rollout as j_make_rollout
from carla_imitation_learning_tpu.training.closed_loop import rollout_spawn_pool
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
from carla_imitation_learning_tpu_torch.sim.world import SimParams
from carla_imitation_learning_tpu_torch.training.closed_loop import (
    make_rollout, semantic_stream,
)

H = W = 64
N_ENVS, N_STEPS = 3, 6
TOWN = make_town(blocks=2, n_buildings=6, n_lights=2)
J_PARAMS, P_PARAMS = JParams(n_agents=3), SimParams(n_agents=3)
RICH = dict(max_triangles=256, facade_bands=3, shadows=True, markings=True,
            texture_detail=True)
FLAGS = ("action", "expert_action", "done", "collision", "offroad",
         "red_light", "ran_red", "traffic", "command")
FLOATS = ("speed", "sensor", "steer", "throttle", "brake", "expert_steer",
          "expert_accel", "route_ds")


@pytest.fixture
def jax_exact_interpret():
    """JAX's kernels in interpret mode, with the exact reciprocal."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_raster_fast, "rasterize_luma_fast",
                   functools.partial(j_raster_fast.rasterize_luma_fast, interpret=True))
        mp.setattr(j_raster, "rasterize_pallas_luma",
                   functools.partial(j_raster.rasterize_pallas_luma, interpret=True))
        mp.setattr(pl, "reciprocal", lambda x, approx=False: 1.0 / x)
        jax.clear_caches()
        yield
    jax.clear_caches()


def _frames_close(got_u8, want_u8, what, mean=2e-3, frac=0.01):
    d = np.abs(got_u8.astype(np.float32) - want_u8.astype(np.float32)) / 255.0
    assert d.mean() < mean, f"{what}: mean diff {d.mean()}"
    assert (d > 2 / 255).mean() < frac, f"{what}: {(d > 2 / 255).mean():.3%} pixels off"


def _run_both(quads: bool):
    j_rcfg = JRenderConfig(H, W, backend="pallas", quads=quads, **RICH)
    init_fn, j_roll = j_make_rollout(J_PARAMS, TOWN, j_rcfg, None, record_semantic=True)
    states, framebuf, just_reset = init_fn(jax.random.PRNGKey(4), N_ENVS)
    states = states.replace(t=jnp.asarray([0, 397, 10], jnp.int32))
    carry = (states, framebuf, just_reset)
    j_out = j_roll(carry, N_STEPS)
    pool = convert.spawn_pool_from_jax(rollout_spawn_pool(J_PARAMS, TOWN))
    _, p_roll = make_rollout(P_PARAMS, convert.town_from_jax(TOWN),
                             RenderConfig(H, W, quads=quads, **RICH), None,
                             spawn_pool=pool, device="cpu", record_semantic=True)
    return j_out, p_roll(convert.carry_from_jax(carry), N_STEPS)


def _compare(j_out, p_out):
    (j_carry, j_traj), (p_carry, p_traj) = j_out, p_out
    sem = p_traj["semantic"]
    assert sem.dtype == torch.uint8 and tuple(sem.shape) == (N_STEPS, N_ENVS, H, W)
    np.testing.assert_array_equal(sem.numpy(), np.asarray(j_traj["semantic"]))
    assert int(sem.max()) <= 7 and (sem == 7).any()          # lane markings seen
    for key in FLAGS:
        want = np.asarray(j_traj[key])
        np.testing.assert_array_equal(
            p_traj[key].numpy(), want.astype(np.int64) if p_traj[key].dtype == torch.int64
            else want, err_msg=key)
    for key in FLOATS:
        np.testing.assert_allclose(p_traj[key].numpy(), np.asarray(j_traj[key]),
                                   rtol=1e-5, atol=1e-4, err_msg=key)
    for t in range(N_STEPS):
        _frames_close(p_traj["gray"][t].numpy(), np.asarray(j_traj["gray"][t]), f"frame {t}")
    j_state = convert.world_state_from_jax(j_carry[0])
    for f in dataclasses.fields(j_state):
        want, got = getattr(j_state, f.name), getattr(p_carry[0], f.name)
        if got.dtype == torch.int64:
            assert torch.equal(got, want), f.name
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                       atol=1e-4, err_msg=f.name)
    assert np.asarray(j_traj["done"]).any()   # the reset path ran


def test_rich_collection_rollout_matches(jax_exact_interpret):
    j_out, p_out = _run_both(quads=False)
    _compare(j_out, p_out)
    stream = semantic_stream(p_out[1])
    assert stream.shape == (N_ENVS * N_STEPS, H, W) and stream.dtype == np.uint8
    np.testing.assert_array_equal(stream[N_STEPS], p_out[1]["semantic"][0, 1].numpy())


def test_rich_quad_rollout_matches(jax_exact_interpret):
    j_out, p_out = _run_both(quads=True)
    _compare(j_out, p_out)
    tri = _run_both(quads=False)[1]
    _frames_close(p_out[1]["gray"].numpy(), tri[1]["gray"].numpy(),
                  "quad vs triangle rollout", mean=1e-3, frac=0.005)
