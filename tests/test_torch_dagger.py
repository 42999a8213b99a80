"""Collection noise, policy extras and host-mediated DAgger in the port,
held against the JAX package on the CPU.

- The noise schedule: the port's shaping of JAX's own draws equals JAX's
  ``_noise_schedule`` (rtol 1e-5, atol 1e-6: the two sum the triangle
  convolution in different orders), and the port's schedule keeps the
  bounds, burst structure and determinism of ``tests/test_noise_injection.py``.
- A noisy expert collection from one converted carry, 3 envs × 24 steps at
  64² with an auto-reset inside: JAX derives its draws from the fleet's
  keys, and the port's ``noise_draws`` is patched to return those draws.
  Actions, labels and starts equal; executed and clean steer, sensors and
  the state log allclose in fp32 (rtol 1e-5, atol 1e-4); frames within the
  fast kernel's tolerance. The JAX rollout runs its fast Pallas kernel in
  interpret mode, as ``tests/test_torch_collect.py`` does.
- ``policy_extra``, ``dagger_iteration``, a tiny ``run_dagger`` and the
  quality harness's DAgger rungs on the port alone.
"""

import functools
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import carla_imitation_learning_tpu.ops.raster_fast as j_raster_fast
import carla_imitation_learning_tpu.training.closed_loop as j_cl
from carla_imitation_learning_tpu.render.pipeline import RenderConfig as JRenderConfig
from carla_imitation_learning_tpu.sim import SimParams as JParams
from carla_imitation_learning_tpu.sim import make_town
from carla_imitation_learning_tpu.sim.world import make_spawn_pool, pack_spawn_pool, reset_env
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch.data.actions import continuous_to_discrete
from carla_imitation_learning_tpu_torch.data.frame_log import STATE_COLUMNS
from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
from carla_imitation_learning_tpu_torch.sim.world import SimParams
from carla_imitation_learning_tpu_torch.training import closed_loop as p_cl
from carla_imitation_learning_tpu_torch.training import dagger

ROOT = Path(__file__).resolve().parents[1]
H = W = 64
N_ENVS, N_STEPS = 3, 24
TOWN = make_town(blocks=2, n_buildings=6, n_lights=2)
P_TOWN = convert.town_from_jax(TOWN)
J_PARAMS, P_PARAMS = JParams(n_agents=3), SimParams(n_agents=3)
J_RCFG = JRenderConfig(H, W, max_triangles=256, backend="pallas")
P_RCFG = RenderConfig(H, W, max_triangles=256)
J_NOISE = j_cl.NoiseConfig(prob=0.1, duration=8, magnitude=0.6, seed=7)
P_NOISE = p_cl.NoiseConfig(prob=0.1, duration=8, magnitude=0.6, seed=7)
# the port-only runs: a smaller frame and short episodes
SMALL_PARAMS = SimParams(n_agents=3, episode_len=20)
SMALL_RCFG = RenderConfig(32, 32, max_triangles=256)


def _jax_draws(key, n_steps, n_envs, ncfg):
    """The draws JAX's ``_noise_schedule`` makes from ``key``."""
    kb, ks, km = jax.random.split(key, 3)
    starts = jax.random.bernoulli(kb, ncfg.prob, (n_steps, n_envs))
    sign = jnp.where(jax.random.bernoulli(ks, 0.5, (n_steps, n_envs)), 1.0, -1.0)
    mag = jax.random.uniform(km, (n_steps, n_envs), minval=0.3, maxval=1.0)
    return tuple(torch.from_numpy(np.array(a)) for a in (starts, sign, mag))


@pytest.mark.parametrize("duration", [8, 20, 2], ids=["d8", "d20", "d2_widened_to_3"])
def test_noise_shape_matches_jax_schedule(duration):
    jcfg = j_cl.NoiseConfig(prob=0.05, duration=duration, magnitude=0.6, seed=7)
    pcfg = p_cl.NoiseConfig(prob=0.05, duration=duration, magnitude=0.6, seed=7)
    key = jax.random.PRNGKey(duration)
    want = np.asarray(j_cl._noise_schedule(key, 100, 16, jcfg))
    got = p_cl.noise_shape(*_jax_draws(key, 100, 16, jcfg), pcfg)
    assert got.dtype == torch.float32 and got.shape == (100, 16)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_schedule_shape_bounds_and_determinism():
    sched = p_cl._noise_schedule(torch.Generator().manual_seed(3), 100, 16, P_NOISE).numpy()
    assert sched.shape == (100, 16)
    assert np.all(np.abs(sched) <= P_NOISE.magnitude + 1e-6)
    active = np.abs(sched) > 1e-6
    assert 0.05 < active.mean() < 0.8
    n_bursts = (np.diff(active.astype(int), axis=0) == 1).sum()
    assert active.sum() > 3 * max(n_bursts, 1)
    again = p_cl._noise_schedule(torch.Generator().manual_seed(3), 100, 16, P_NOISE).numpy()
    np.testing.assert_array_equal(sched, again)


def test_noise_generator_follows_seed_and_fleet():
    states = p_cl.reset_env(SMALL_PARAMS, P_TOWN, torch.Generator().manual_seed(0), 4)
    other = p_cl.reset_env(SMALL_PARAMS, P_TOWN, torch.Generator().manual_seed(1), 4)

    def draw(ncfg, s):
        return p_cl._noise_schedule(p_cl.noise_generator(ncfg, s), 50, 4, ncfg)

    assert torch.equal(draw(P_NOISE, states), draw(P_NOISE, states))
    assert not torch.equal(draw(P_NOISE, states), draw(P_NOISE, other))
    reseeded = p_cl.NoiseConfig(prob=0.1, duration=8, magnitude=0.6, seed=8)
    assert not torch.equal(draw(P_NOISE, states), draw(reseeded, states))


@pytest.fixture(scope="module")
def start():
    """A JAX fleet carry (env 1 six steps from its episode limit, a random
    frame window) and the default spawn pool, built under jit."""
    states = jax.jit(jax.vmap(lambda k: reset_env(J_PARAMS, TOWN, k)))(
        jax.random.split(jax.random.PRNGKey(3), N_ENVS))
    states = states.replace(t=jnp.asarray([0, J_PARAMS.episode_len - 6, 10], jnp.int32))
    framebuf = np.random.default_rng(3).integers(0, 256, (N_ENVS, H, W, 4), dtype=np.uint8)
    pool = pack_spawn_pool(jax.jit(lambda: make_spawn_pool(
        J_PARAMS, TOWN, jax.random.PRNGKey(0x5EED), 1024))())
    return (states, jnp.asarray(framebuf), jnp.zeros(N_ENVS, bool)), pool


@pytest.fixture(scope="module")
def noisy_collections(start):
    carry, pool = start
    key = jax.random.fold_in(jax.random.PRNGKey(J_NOISE.seed),
                             jnp.sum(carry[0].rng.astype(jnp.uint32)))
    draws = _jax_draws(key, N_STEPS, N_ENVS, J_NOISE)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_raster_fast, "rasterize_luma_fast",
                   functools.partial(j_raster_fast.rasterize_luma_fast, interpret=True))
        mp.setattr(j_cl, "rollout_spawn_pool", lambda params, town: pool)
        j_make, p_make = j_cl.make_rollout, p_cl.make_rollout

        def j_make_rollout(*a, **kw):
            _, rollout_fn = j_make(*a, **kw)
            return (lambda rng, n: carry), rollout_fn

        p_carry, p_pool = convert.carry_from_jax(carry), convert.spawn_pool_from_jax(pool)

        def p_make_rollout(*a, **kw):
            _, rollout_fn = p_make(*a, spawn_pool=p_pool, **kw)
            return (lambda gen, n: p_carry), rollout_fn

        mp.setattr(j_cl, "make_rollout", j_make_rollout)
        mp.setattr(p_cl, "make_rollout", p_make_rollout)
        mp.setattr(p_cl, "noise_draws", lambda gen, n_steps, n_envs, ncfg: draws)
        j_out = j_cl.collect_dataset(J_PARAMS, TOWN, J_RCFG, jax.random.PRNGKey(0), N_ENVS,
                                     N_STEPS, noise=J_NOISE)
        p_out = p_cl.collect_dataset(P_PARAMS, P_TOWN, P_RCFG, torch.Generator(), N_ENVS,
                                     N_STEPS, noise=P_NOISE, device="cpu")
    return j_out, p_out, p_cl.noise_shape(*draws, P_NOISE)


def test_noisy_collection_matches(noisy_collections):
    (j_store, j_state, j_traj), (p_store, p_state, p_traj), sched = noisy_collections
    assert np.asarray(j_traj["done"]).any() and p_store.starts.sum() > N_ENVS
    assert bool((sched != 0).any())
    for key in ("actions", "traffic", "commands", "starts"):
        np.testing.assert_array_equal(getattr(p_store, key), getattr(j_store, key),
                                      err_msg=key)
    for key in ("sensors", "controls"):
        np.testing.assert_allclose(getattr(p_store, key), getattr(j_store, key),
                                   rtol=1e-5, atol=1e-4, err_msg=key)
    for col in STATE_COLUMNS:
        np.testing.assert_allclose(getattr(p_state, col), getattr(j_state, col),
                                   rtol=1e-5, atol=1e-4, err_msg=col)
    for key in ("steer", "clean_steer"):
        np.testing.assert_allclose(p_traj[key].numpy(), np.asarray(j_traj[key]),
                                   rtol=1e-5, atol=1e-4, err_msg=key)
    d = np.abs(p_store.frames.astype(np.float32) - j_store.frames.astype(np.float32)) / 255
    assert d.mean() < 2e-3 and (d > 2 / 255).mean() < 0.01


def test_noise_perturbs_only_the_executed_steer(noisy_collections):
    _, (store, state, traj), sched = noisy_collections
    clean, steer = traj["clean_steer"], traj["steer"]
    assert torch.equal(steer, torch.where(sched != 0, torch.clamp(clean + sched, -1, 1), clean))
    assert bool((steer != clean).any())
    # the labels, the policy-side action and the state log stay clean
    labels = continuous_to_discrete(clean, traj["throttle"], traj["brake"]).to(torch.int64)
    assert torch.equal(traj["expert_action"], labels) and torch.equal(traj["action"], labels)
    np.testing.assert_array_equal(state.steer, clean.T.reshape(-1).numpy().astype(np.float64))
    rederived = continuous_to_discrete(torch.from_numpy(state.steer),
                                       torch.from_numpy(state.throttle),
                                       torch.from_numpy(state.brake))
    np.testing.assert_array_equal(store.actions, rederived.numpy().astype(np.int32))


def test_policy_extra_is_recorded():
    def policy_fn(obs):
        return torch.zeros(obs.shape[0], dtype=torch.int64), obs.mean((1, 2, 3))

    init_fn, rollout_fn = p_cl.make_rollout(SMALL_PARAMS, P_TOWN, SMALL_RCFG, policy_fn,
                                            device="cpu")
    _, traj = rollout_fn(init_fn(torch.Generator().manual_seed(0), 3), 5)
    assert traj["policy_extra"].shape == (5, 3)
    assert torch.equal(traj["action"], torch.zeros(5, 3, dtype=torch.int64))
    # step 0's window is the first frame repeated: its mean is the frame's
    first = traj["gray"][0].to(torch.float32) * (1.0 / 255.0)
    torch.testing.assert_close(traj["policy_extra"][0], first.mean((1, 2)))
    _, traj = p_cl.make_rollout(SMALL_PARAMS, P_TOWN, SMALL_RCFG, None, device="cpu")[1](
        init_fn(torch.Generator().manual_seed(0), 3), 2)
    assert "policy_extra" not in traj and "clean_steer" not in traj


def test_dagger_iteration_equals_collect_dataset():
    torch.manual_seed(0)
    model = dagger.PolicyCNN(dtype=torch.float32)

    def policy_fn(obs):
        return model(obs).argmax(-1)

    outs = [fn(SMALL_PARAMS, P_TOWN, SMALL_RCFG, policy_fn=policy_fn,
               generator=torch.Generator().manual_seed(4), n_envs=3, n_steps=12, device="cpu")
            for fn in (p_cl.dagger_iteration, p_cl.collect_dataset)]
    (a, sa, ta), (b, sb, tb) = outs
    for key in ("frames", "actions", "traffic", "sensors", "commands", "starts", "controls"):
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key), err_msg=key)
    for col in STATE_COLUMNS:
        np.testing.assert_array_equal(getattr(sa, col), getattr(sb, col), err_msg=col)
    assert torch.equal(ta["action"], tb["action"])


def test_run_dagger_tiny():
    out = dagger.run_dagger(SMALL_PARAMS, P_TOWN, SMALL_RCFG, torch.Generator().manual_seed(0),
                            rounds=2, n_envs=3, n_steps=24, epochs_per_round=1, batch_size=16,
                            noise=P_NOISE, device="cpu")
    rounds = out["rounds"]
    assert [r["round"] for r in rounds] == [0, 1]
    assert [r["dataset_frames"] for r in rounds] == [72, 144]
    for r in rounds:
        assert np.isfinite(r["train_loss"]) and np.isfinite(r["driving_score"])
        assert r["env_steps"] == 3 * 100
    assert rounds[0]["action_agreement"] < 1.0 or rounds[1]["action_agreement"] < 1.0
    # goals plan over the turn-fan graph, which this town lacks
    with pytest.raises(ValueError, match="turn_fans"):
        dagger.run_dagger(SMALL_PARAMS, P_TOWN, SMALL_RCFG, torch.Generator(), n_goals=2,
                          device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dagger.run_dagger(SMALL_PARAMS, P_TOWN, SMALL_RCFG, torch.Generator())


def test_driving_quality_dagger_rungs_tiny(tmp_path):
    """The quality harness's DAgger rungs and ``--noise`` at a toy size."""
    spec = importlib.util.spec_from_file_location(
        "driving_quality_torch", ROOT / "benchmarks_torch" / "driving_quality.py")
    dq = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(dq)
    out = tmp_path / "dq.json"
    dq.main(["--device", "cpu", "--envs", "2", "--steps", "6", "--collect-envs", "2",
             "--collect-steps", "10", "--epochs", "1", "--batch", "8", "--dagger", "2",
             "--noise", "--out", str(out)])
    report = json.loads(out.read_text())
    run = report["runs"]["0"]
    for tier in ("bc", "dagger_r1", "dagger_r2", "dagger"):
        assert np.isfinite(run[tier]["driving_score"]), tier
        assert report["summary"][tier]["driving_score"]["values"] == [run[tier]["driving_score"]]
    assert run["dagger"] == run["dagger_r2"] and run["dagger_frames"] == 3 * 20
    assert np.isfinite(run["dagger_r2_final_loss"])
    assert report["config"]["noise"] and report["config"]["dagger"] == 2
