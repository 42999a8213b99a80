"""Data collection: ``collect_dataset`` in each package from one converted
carry, 3 envs × 24 steps at 64², one env near its episode limit so an
auto-reset falls inside the window; then a BC step on the collected store
and a tiny CPU run of ``benchmarks_torch/driving_quality.py``.

Each package's ``make_rollout`` is wrapped so that ``init_fn`` returns the
shared carry and both rollouts draw from one spawn pool; the
JAX rollout runs its fast Pallas kernel in interpret mode, as
``tests/test_torch_rollout.py`` does. Tolerances: actions, traffic,
commands, episode starts and labels equal; sensors, the ``StateLog``
columns and controls allclose in fp32 (rtol 1e-5, atol 1e-4); frames within
the fast kernel's tolerance (mean|d| < 2e-3, < 1 % of pixels off by more
than 2/255).
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
from carla_imitation_learning_tpu.models import PolicyCNN as JPolicyCNN
from carla_imitation_learning_tpu.render.pipeline import RenderConfig as JRenderConfig
from carla_imitation_learning_tpu.sim import SimParams as JParams
from carla_imitation_learning_tpu.sim import make_town
from carla_imitation_learning_tpu.sim.world import make_spawn_pool, pack_spawn_pool, reset_env
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch.data.frame_log import STATE_COLUMNS
from carla_imitation_learning_tpu_torch.data.pipeline import DeviceDataset
from carla_imitation_learning_tpu_torch.models import PolicyCNN
from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
from carla_imitation_learning_tpu_torch.sim.world import SimParams
from carla_imitation_learning_tpu_torch.training import closed_loop as p_cl
from carla_imitation_learning_tpu_torch.training import losses, steps

ROOT = Path(__file__).resolve().parents[1]
H = W = 64
N_ENVS, N_STEPS = 3, 24
TOWN = make_town(blocks=2, n_buildings=6, n_lights=2)
J_PARAMS, P_PARAMS = JParams(n_agents=3), SimParams(n_agents=3)
J_RCFG = JRenderConfig(H, W, max_triangles=256, backend="pallas")
P_RCFG = RenderConfig(H, W, max_triangles=256)


def _interpret(mp):
    mp.setattr(j_raster_fast, "rasterize_luma_fast",
               functools.partial(j_raster_fast.rasterize_luma_fast, interpret=True))


@pytest.fixture(scope="module")
def start():
    """A JAX fleet carry (fresh resets, env 1 six steps from its episode
    limit, a random frame window), a spawn pool, and fp32 policy weights."""
    states = jax.jit(jax.vmap(lambda k: reset_env(J_PARAMS, TOWN, k)))(
        jax.random.split(jax.random.PRNGKey(3), N_ENVS))
    states = states.replace(t=jnp.asarray([0, J_PARAMS.episode_len - 6, 10], jnp.int32))
    framebuf = np.random.default_rng(3).integers(0, 256, (N_ENVS, H, W, 4), dtype=np.uint8)
    just_reset = jnp.zeros(N_ENVS, bool)
    # normal weights of lecun_normal's scale, drawn with numpy (flax's own
    # initializer takes seconds to compile)
    shapes = jax.eval_shape(JPolicyCNN(dtype=jnp.float32).init, jax.random.PRNGKey(5),
                            jnp.zeros((1, H, W, 4)))["params"]
    rng = np.random.default_rng(5)
    weights = jax.tree_util.tree_map(
        lambda s: (rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32),
        shapes)
    # the default pool's draw, built under jit (eagerly it takes seconds)
    pool = pack_spawn_pool(jax.jit(lambda: make_spawn_pool(
        J_PARAMS, TOWN, jax.random.PRNGKey(0x5EED), 1024))())
    return (states, jnp.asarray(framebuf), just_reset), pool, weights


def _j_collect(mp, carry, pool, policy_fn):
    orig = j_cl.make_rollout
    _interpret(mp)
    mp.setattr(j_cl, "rollout_spawn_pool", lambda params, town: pool)

    def make_rollout(*a, **kw):
        _, rollout_fn = orig(*a, **kw)
        return (lambda rng, n: carry), rollout_fn

    mp.setattr(j_cl, "make_rollout", make_rollout)
    return j_cl.collect_dataset(J_PARAMS, TOWN, J_RCFG, jax.random.PRNGKey(0), N_ENVS,
                                N_STEPS, policy_fn=policy_fn)


def _p_collect(mp, carry, pool, policy_fn):
    orig = p_cl.make_rollout

    def make_rollout(*a, **kw):
        _, rollout_fn = orig(*a, spawn_pool=pool, **kw)
        return (lambda gen, n: carry), rollout_fn

    mp.setattr(p_cl, "make_rollout", make_rollout)
    return p_cl.collect_dataset(P_PARAMS, convert.town_from_jax(TOWN), P_RCFG,
                                torch.Generator().manual_seed(0), N_ENVS, N_STEPS,
                                policy_fn=policy_fn, device="cpu")


def _frames_close(got_u8, want_u8, what):
    d = np.abs(got_u8.astype(np.float32) - want_u8.astype(np.float32)) / 255.0
    assert d.mean() < 2e-3, f"{what}: mean diff {d.mean()}"
    assert (d > 2 / 255).mean() < 0.01, f"{what}: {(d > 2 / 255).mean():.3%} pixels off"


def _compare(j_out, p_out):
    (j_store, j_state, j_traj), (p_store, p_state, _) = j_out, p_out
    assert np.asarray(j_traj["done"]).any()          # the reset path ran
    assert p_store.starts.sum() > N_ENVS               # ... and is marked
    for key in ("actions", "traffic", "commands", "starts"):
        got, want = getattr(p_store, key), getattr(j_store, key)
        np.testing.assert_array_equal(got, want, err_msg=key)
        assert got.dtype == want.dtype, key
    for key in ("sensors", "controls"):
        got, want = getattr(p_store, key), getattr(j_store, key)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4, err_msg=key)
        assert got.dtype == want.dtype, key
    for col in STATE_COLUMNS:
        got, want = getattr(p_state, col), getattr(j_state, col)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4, err_msg=col)
        assert got.dtype == want.dtype == np.float64, col
    assert p_store.frames.dtype == np.uint8 and p_store.frames.shape == j_store.frames.shape
    for i in range(0, len(p_store), N_STEPS):           # one env stream at a time
        _frames_close(p_store.frames[i:i + N_STEPS], j_store.frames[i:i + N_STEPS],
                      f"frames {i}")


@pytest.fixture(scope="module")
def expert_collection(start):
    carry, pool, _ = start
    with pytest.MonkeyPatch.context() as mp:
        j_out = _j_collect(mp, carry, pool, None)
        p_out = _p_collect(mp, convert.carry_from_jax(carry),
                           convert.spawn_pool_from_jax(pool), None)
    return j_out, p_out


def test_expert_collection_matches(expert_collection):
    j_out, p_out = expert_collection
    _compare(j_out, p_out)
    np.testing.assert_array_equal(p_out[0].actions, p_out[2]["action"].T.reshape(-1))


def test_policy_collection_matches(start):
    """The DAgger form: the policy drives, the expert labels."""
    carry, pool, weights = start
    jmodel = JPolicyCNN(dtype=jnp.float32)
    pmodel = PolicyCNN(dtype=torch.float32)
    pmodel.load_state_dict(convert.policy_state_dict(weights))
    with pytest.MonkeyPatch.context() as mp:
        j_out = _j_collect(mp, carry, pool, lambda obs: jnp.argmax(
            jmodel.apply({"params": weights}, obs), axis=-1))
        p_out = _p_collect(mp, convert.carry_from_jax(carry),
                           convert.spawn_pool_from_jax(pool),
                           lambda obs: pmodel(obs).argmax(-1))
    _compare(j_out, p_out)
    np.testing.assert_array_equal(p_out[2]["action"].numpy(),
                                  np.asarray(j_out[2]["action"]).astype(np.int64))
    # the policy drove: its actions are not the labels everywhere
    assert (p_out[2]["action"] != p_out[2]["expert_action"]).any()


def test_bc_step_on_collected_store(expert_collection):
    store, state, _ = expert_collection[1]
    assert len(store) == len(state) == N_ENVS * N_STEPS
    assert store.frames.shape == (N_ENVS * N_STEPS, H, W)
    ds = DeviceDataset(store, 8, shuffle=True, device="cpu")
    tstate = steps.create_train_state(PolicyCNN(dtype=torch.float32),
                                      steps.make_optimizer({"gradient_clip_val": 0.5}),
                                      generator=torch.Generator().manual_seed(0),
                                      device="cpu")
    before = [p.detach().clone() for p in tstate.model.parameters()]
    _, metrics = steps.make_train_step(losses.bc_loss_fn)(tstate, next(iter(ds)))
    assert np.isfinite(float(metrics["loss"])) and tstate.step == 1
    assert any(not torch.equal(a, b) for a, b in zip(before, tstate.model.parameters()))


def test_collect_refuses():
    town = convert.town_from_jax(TOWN)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(NotImplementedError):
        p_cl.collect_dataset(P_PARAMS, town, P_RCFG, gen, device="cpu",
                             cameras=("camera", "FL"))
    with pytest.raises(ValueError, match="control_space"):
        p_cl.collect_dataset(P_PARAMS, town, P_RCFG, gen, device="cpu", control_space="joystick")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            p_cl.collect_dataset(P_PARAMS, town, P_RCFG, gen)


def test_driving_quality_harness_tiny(tmp_path):
    """The quality harness at a toy size on the CPU writes all three rungs."""
    spec = importlib.util.spec_from_file_location(
        "driving_quality_torch", ROOT / "benchmarks_torch" / "driving_quality.py")
    dq = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(dq)
    out = tmp_path / "dq.json"
    dq.main(["--device", "cpu", "--envs", "2", "--steps", "6", "--collect-envs", "2",
             "--collect-steps", "10", "--epochs", "1", "--batch", "8", "--out", str(out)])
    report = json.loads(out.read_text())
    run = report["runs"]["0"]
    for tier in ("expert", "untrained", "bc"):
        assert np.isfinite(run[tier]["driving_score"]), tier
        assert report["summary"][tier]["driving_score"]["values"] == [run[tier]["driving_score"]]
    assert run["expert"]["action_agreement"] == 1.0
    assert run["dataset_frames"] == 20 and run["train_steps"] == 1
    assert np.isfinite(run["bc_final_loss"])
    with pytest.raises(SystemExit):
        dq.main(["--device", "cpu", "--out", str(ROOT / "reports" / "x.json")])
