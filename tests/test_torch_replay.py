"""The episode recorder (``training/replay.py``) and the ``replay``
experiment, on the CPU:

- a record of the port's own rollout replays its dynamics exactly (speed,
  flags, sensors, the final state bit for bit), with an auto-reset inside
  the episode; any env of it replays alone; the re-render at the rollout's
  config gives the rollout's frames, and with a new camera and size the
  exact branch's RGB and class planes; collection noise rides on the
  recorded controls;
- a record written by the JAX package (states and controls of a JAX
  fleet) loads in the port and replays there allclose to JAX's own replay
  in fp32 (rtol 1e-5, atol 1e-4; flags equal), and a record written by
  the port loads in the JAX package, in JAX's dtypes, and replays there
  allclose to the port's; both through auto-resets, with one spawn pool;
- ``run replay`` through the CLI records the expert, replays exactly and
  writes the GIF; ``-o record=`` replays the JAX package's record.
"""

import contextlib
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_imitation_learning_tpu.render.pipeline import RenderConfig as JRenderConfig
from carla_imitation_learning_tpu.sim import SimParams as JParams
from carla_imitation_learning_tpu.sim import world as j_world
from carla_imitation_learning_tpu.sim.town import make_town as j_make_town
from carla_imitation_learning_tpu.training import closed_loop as j_cl
from carla_imitation_learning_tpu.training import replay as j_rp
from carla_imitation_learning_tpu_torch import cli, convert
from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig, make_renderer
from carla_imitation_learning_tpu_torch.sim.town import make_town
from carla_imitation_learning_tpu_torch.sim.world import SimParams
from carla_imitation_learning_tpu_torch.training import closed_loop as p_cl
from carla_imitation_learning_tpu_torch.training import replay as p_rp

HW, T = 32, 256
TOWN_KW = dict(blocks=2, n_buildings=6, n_lights=2)
N_ENVS, N_STEPS = 3, 24
P_PARAMS, J_PARAMS = SimParams(n_agents=3), JParams(n_agents=3)
RCFG = RenderConfig(HW, HW, max_triangles=T)
FLOATS = ("speed", "sensor")
FLAGS = ("collision", "offroad", "done", "red_light", "traffic")


def _near_end(states):
    """Every other env six steps from its episode limit."""
    t = torch.where(torch.arange(states.t.shape[0]) % 2 == 0, P_PARAMS.episode_len - 6,
                    states.t)
    return states.replace(t=t)


def _record(noise=None, seed=0):
    town = make_town(**TOWN_KW)
    init_fn, rollout_fn = p_cl.make_rollout(P_PARAMS, town, RCFG, None, device="cpu",
                                            noise=noise)
    states, framebuf, just_reset = init_fn(torch.Generator().manual_seed(seed), N_ENVS)
    carry = (_near_end(states), framebuf, just_reset)
    final, traj = rollout_fn(carry, N_STEPS)
    rec = p_rp.record_from_rollout(carry[0], traj, params=P_PARAMS, town_kwargs=TOWN_KW,
                                   rcfg=RCFG, meta={"driver": "expert"})
    return rec, final[0], traj


@pytest.fixture(scope="module")
def recorded():
    return _record()


def test_replay_reproduces_the_rollout(recorded):
    rec, final, traj = recorded
    assert rec.n_steps == N_STEPS and rec.n_envs == N_ENVS and rec.controls.dtype == np.float32
    assert bool(traj["done"].any())                   # an auto-reset is inside
    replay_fn = p_rp.make_replay(*p_rp.rebuild_world(rec), None, device="cpu")
    states, out = replay_fn(rec.states0, rec.controls)
    for k in FLOATS + FLAGS:
        assert torch.equal(out[k], traj[k]), k
    for f in dataclasses.fields(states):
        assert torch.equal(getattr(states, f.name), getattr(final, f.name)), f.name


def test_select_envs_replays_alone(recorded):
    rec, _, traj = recorded
    for idx in (1, [2, 0]):
        sub = p_rp.select_envs(rec, idx)
        out = p_rp.replay_record(sub, render=False, device="cpu")
        cols = np.atleast_1d(idx)
        assert sub.n_envs == len(cols)
        for k in FLOATS + FLAGS:
            assert torch.equal(out[k], traj[k][:, cols]), k


def test_rerender(recorded):
    """At the rollout's own config the replay renders the rollout's frames;
    a new camera and size render the exact branch's planes."""
    rec, _, traj = recorded
    out = p_rp.replay_record(rec, device="cpu",
                             render_override={"fast": True, "rgb": False, "lod_px": 2.0})
    assert torch.equal(p_cl._quantize(out["gray"]), traj["gray"])
    sub = p_rp.select_envs(rec, 1)
    over = {"height": 48, "width": 40, "rgb": True, "semantic": True, "backend": "jax",
            "fast": False}
    side = p_rp.replay_record(sub, camera="FL", render_override=over, device="cpu")
    assert tuple(side["rgb"].shape) == (N_STEPS, 1, 48, 40, 3)
    assert tuple(side["semantic_rgb"].shape) == (N_STEPS, 1, 48, 40, 3)
    want = make_renderer(P_PARAMS, make_town(**TOWN_KW), p_rp.render_config({**rec.render, **over}),
                         device="cpu", camera="FL")(sub.states0)
    assert torch.equal(side["semantic"][0], want["semantic"])
    assert torch.equal(side["rgb"][0], want["rgb"])
    front = p_rp.replay_record(sub, render_override=over, device="cpu")
    assert not torch.equal(front["rgb"], side["rgb"])
    with pytest.raises(TypeError):
        p_rp.render_config({**rec.render, "exposure": 2.0})


def test_noise_rides_on_the_executed_controls():
    rec, _, traj = _record(noise=p_cl.NoiseConfig(prob=0.2, duration=4, seed=3), seed=1)
    steer = torch.from_numpy(rec.controls[..., 0])
    assert torch.equal(steer, traj["steer"]) and not torch.equal(steer, traj["clean_steer"])
    out = p_rp.replay_record(rec, render=False, device="cpu")
    assert torch.equal(out["speed"], traj["speed"])


def test_saved_record_round_trips(recorded, tmp_path):
    rec, _, _ = recorded
    back = p_rp.load_record(p_rp.save_record(tmp_path / "ep.npz", rec))
    np.testing.assert_array_equal(back.controls, rec.controls)
    for f in dataclasses.fields(rec.states0):
        a, b = getattr(back.states0, f.name), getattr(rec.states0, f.name)
        assert a.dtype == b.dtype and torch.equal(a, b), f.name
    assert (back.sim, back.town, back.render, back.meta) == \
        (rec.sim, rec.town, rec.render, rec.meta)
    with np.load(tmp_path / "ep.npz") as z:           # the JAX package's dtypes
        assert z["state0_rng"].dtype == np.uint32 and z["state0_t"].dtype == np.int32
        assert z["state0_ego_pos"].dtype == np.float32
        arrays = {k: z[k] for k in z.files if k != "state0_goal"}
    np.savez(tmp_path / "old.npz", **arrays)          # a record from before goals
    assert (p_rp.load_record(tmp_path / "old.npz").states0.goal == -1).all()


@pytest.fixture(scope="module")
def jax_world():
    """The JAX town, its default spawn pool (built under jit) and the
    record of a fleet with random controls, every other env near its
    episode limit."""
    town = j_make_town(**TOWN_KW)
    pool = j_world.pack_spawn_pool(jax.jit(lambda: j_world.make_spawn_pool(
        J_PARAMS, town, jax.random.PRNGKey(0x5EED), 1024))())
    states = jax.jit(jax.vmap(lambda k: j_world.reset_env(J_PARAMS, town, k)))(
        jax.random.split(jax.random.PRNGKey(7), N_ENVS))
    states = states.replace(t=jnp.where(jnp.arange(N_ENVS) % 2 == 0,
                                        J_PARAMS.episode_len - 6, 0).astype(jnp.int32))
    rng = np.random.default_rng(7)
    controls = np.stack([rng.uniform(-0.3, 0.3, (N_STEPS, N_ENVS)),
                         rng.uniform(0.3, 1.0, (N_STEPS, N_ENVS)),
                         (rng.random((N_STEPS, N_ENVS)) < 0.1).astype(np.float64)],
                        -1).astype(np.float32)
    rec = j_rp.EpisodeRecord(
        states0=jax.tree_util.tree_map(np.asarray, states), controls=controls,
        sim=dataclasses.asdict(J_PARAMS), town=dict(TOWN_KW),
        render=dataclasses.asdict(JRenderConfig(HW, HW, max_triangles=T)),
        meta={"driver": "random"})
    return town, pool, rec


def _j_replay(mp, pool, rec):
    mp.setattr(j_cl, "rollout_spawn_pool", lambda params, town: pool)
    return j_rp.replay_record(rec, render=False)


def _close(got, want):
    for k in FLOATS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-4,
                                   err_msg=k)
    for k in FLAGS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_jax_record_replays_in_the_port(jax_world, tmp_path):
    _, pool, rec = jax_world
    path = j_rp.save_record(tmp_path / "jax.npz", rec)
    with pytest.MonkeyPatch.context() as mp:
        want = _j_replay(mp, pool, rec)
    assert np.asarray(want["done"]).any()
    back = p_rp.load_record(path)
    assert back.render["backend"] == "jax"            # kept, and ignored on replay
    got = p_rp.replay_record(back, render=False, device="cpu",
                             spawn_pool=convert.spawn_pool_from_jax(pool))
    _close(got, want)


def test_port_record_replays_in_jax(recorded, jax_world, tmp_path):
    rec, _, traj = recorded
    _, pool, _ = jax_world
    p_pool = p_cl.rollout_spawn_pool(P_PARAMS, make_town(**TOWN_KW))
    path = p_rp.save_record(tmp_path / "port.npz", rec)
    j_rec = j_rp.load_record(path)
    with pytest.MonkeyPatch.context() as mp:
        want = _j_replay(mp, (jnp.asarray(p_pool.numpy()),) + tuple(pool[1:]), j_rec)
    _close(p_rp.replay_record(rec, render=False, device="cpu"), want)
    np.testing.assert_array_equal(np.asarray(want["done"]), traj["done"].numpy())


def _cli(*args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["run", *args, "--json"]) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_replay_experiment(jax_world, tmp_path):
    """``run replay`` records the expert and replays it; ``-o record=``
    replays the JAX package's record (the port's pool on both passes)."""
    tiny = ["-o", "device=cpu", "-o", "sim.n_agents=2", "-o", "sim.town.blocks=2",
            "-o", "sim.town.n_buildings=4", "-o", f"render.height={HW}",
            "-o", f"render.width={HW}", "-o", f"render.max_triangles={T}",
            "-o", "n_envs=3", "-o", "n_steps=30", "-o", "out_height=40", "-o", "out_width=40"]
    res = _cli("-o", "experiment=replay", "-o", f"log_dir={tmp_path / 'a'}", *tiny)
    assert res["replay_speed_max_abs_diff"] == 0.0
    assert (res["n_envs"], res["n_steps"]) == (3, 30) and 0 < res["record_bytes"] < 20_000
    rec = j_rp.load_record(res["record"])              # loads in the JAX package
    assert rec.meta["driver"] == "expert" and rec.controls.shape == (30, 3, 3)
    from PIL import Image

    with Image.open(res["gif"]) as gif:
        # RGB | class plane; PIL folds identical successive frames into one
        assert gif.size == (80, 40) and 1 < gif.n_frames <= 30
    _, _, jrec = jax_world
    path = j_rp.save_record(tmp_path / "jax.npz", jrec)
    res = _cli("replay", "-o", f"record={path}", "-o", f"log_dir={tmp_path / 'b'}",
               "-o", "make_gif=False", *tiny)
    assert res["replay_speed_max_abs_diff"] == 0.0 and res["n_steps"] == N_STEPS
    assert "gif" not in res
