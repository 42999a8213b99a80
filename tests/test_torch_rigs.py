"""The camera rig and surround view of the port against the JAX package:

- every ``CAMERA_PRESETS`` entry: the rig yaw bit for bit against XLA's
  ``ego_yaw + jnp.deg2rad(offset)``, the projected setup of
  ``make_scene_setup(camera=...)`` against JAX's ``camera_from_ego`` /
  ``project_triangles`` (``valid`` equal, bbox and zmin allclose, edge and
  depth rows within rtol 1e-5 of the size of their terms, as
  ``tests/test_torch_render.py`` holds them) and its fast frame against
  JAX's interpret-mode kernel B within the fast-raster tolerance (mean|d| <
  2e-3, < 1 % of pixels off by more than 2/255);
- ``update_framebuf`` with K = 3 views (and K = 1), reset refill included,
  equal to JAX's; ``gather_windows`` and ``DeviceDataset(extra_frames=...)``
  batches bit for bit, and the shape check;
- ``collect_multicamera`` in both packages from one fleet state and spawn
  pool: starts equal, the state log allclose (rtol 1e-5, atol 1e-4), every
  view within the fast-raster tolerance; the surround rollout's first
  view is the single-camera rollout;
- ``_surround_cams``; a whole ``bc_surround`` run through ``cli.py run``
  against the JAX experiment from one initial state (both collections
  replaced by one synthetic rig log), metrics at rtol 1e-4;
- the registry: the port's experiments are the JAX package's 30, and
  ``cli.py list`` prints one line for each.
"""

import contextlib
import functools
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import carla_imitation_learning_tpu.ops.raster_fast as j_rf
from carla_imitation_learning_tpu import compose as j_compose
from carla_imitation_learning_tpu import experiments as j_ex
from carla_imitation_learning_tpu.data import frame_log as j_fl
from carla_imitation_learning_tpu.data import pipeline as j_pipe
from carla_imitation_learning_tpu.models import PolicyCNN as JPolicyCNN
from carla_imitation_learning_tpu.render import camera as j_camera
from carla_imitation_learning_tpu.render import geometry as j_geo
from carla_imitation_learning_tpu.render.pipeline import RenderConfig as JRenderConfig
from carla_imitation_learning_tpu.sim import SimParams as JParams
from carla_imitation_learning_tpu.sim import agents as j_agents
from carla_imitation_learning_tpu.sim import make_town
from carla_imitation_learning_tpu.sim import world as j_world
from carla_imitation_learning_tpu.training import closed_loop as j_cl
from carla_imitation_learning_tpu_torch import cli, convert
from carla_imitation_learning_tpu_torch import experiments as p_ex
from carla_imitation_learning_tpu_torch.config import compose as p_compose
from carla_imitation_learning_tpu_torch.data import frame_log as p_fl
from carla_imitation_learning_tpu_torch.data import pipeline as p_pipe
from carla_imitation_learning_tpu_torch.ops import raster_fast as p_rf
from carla_imitation_learning_tpu_torch.render import camera as p_camera
from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig, make_scene_setup
from carla_imitation_learning_tpu_torch.sim.world import SimParams
from carla_imitation_learning_tpu_torch.training import closed_loop as p_cl
from carla_imitation_learning_tpu_torch.utils import checkpoint as p_ckpt
from test_torch_aux import numpy_params
from test_torch_aux_experiments import _same_history, template_train_state

HW, T, N_ENVS = 32, 256, 2
TOWN = make_town(blocks=2, n_buildings=6, n_lights=2)
P_TOWN = convert.town_from_jax(TOWN)
J_PARAMS, P_PARAMS = JParams(n_agents=3), SimParams(n_agents=3)
PRESETS = sorted(j_camera.CAMERA_PRESETS)
TINY = ["sim.n_agents=2", "sim.town.blocks=2", "sim.town.n_buildings=4",
        f"render.height={HW}", f"render.width={HW}", f"render.max_triangles={T}"]


def _frames_close(got, want, what):
    d = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert d.mean() < 2e-3, f"{what}: mean diff {d.mean()}"
    assert (d > 2 / 255).mean() < 0.01, f"{what}: {(d > 2 / 255).mean():.3%} pixels off"


def _fleet(seed=0, near_end=False):
    """A JAX fleet from reset; with ``near_end`` every other env is six
    steps from its episode limit."""
    reset = jax.vmap(lambda k: j_world.reset_env(J_PARAMS, TOWN, k))
    st = jax.jit(reset)(jax.random.split(jax.random.PRNGKey(seed), N_ENVS))
    if near_end:
        st = st.replace(t=jnp.where(jnp.arange(N_ENVS) % 2 == 0,
                                    J_PARAMS.episode_len - 6, 0).astype(jnp.int32))
    return st


@pytest.fixture(scope="module")
def fleet():
    return _fleet(seed=4)


def test_presets_equal_jax():
    assert p_camera.CAMERA_PRESETS == j_camera.CAMERA_PRESETS


@pytest.mark.parametrize("preset", PRESETS)
def test_rig_yaw_matches_xla(preset):
    """The offset heading equals the JAX package's compiled form bit for bit."""
    off = j_camera.CAMERA_PRESETS[preset][0]
    yaw = np.random.default_rng(1).uniform(-np.pi, np.pi, 257).astype(np.float32)
    want = jax.jit(lambda y: y + jnp.deg2rad(off))(jnp.asarray(yaw))
    got = p_camera.rig_yaw(torch.from_numpy(yaw), off)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@functools.cache
def _j_static():
    return j_geo.build_static_scene(TOWN)


def _j_setup(st, preset):
    """JAX's setup of one env as its ``make_renderer`` builds it for ``preset``."""
    off, fov = j_camera.CAMERA_PRESETS[preset]
    static = _j_static()
    phases = j_agents.light_phases(TOWN, st.t.astype(jnp.float32) * J_PARAMS.dt,
                                   J_PARAMS.light_green, J_PARAMS.light_yellow,
                                   J_PARAMS.light_red)
    ap, ay = j_agents.agent_positions(TOWN, st.agents_route, st.agents_s)
    tris, colors, classes = j_geo.assemble_scene(static, TOWN.lights_pos, phases, ap, ay, T)
    cam = j_camera.camera_from_ego(st.ego_pos, st.ego_yaw, yaw_offset_deg=off)
    cullable = ((classes == j_geo.SEM_BUILDING) | (classes == j_geo.SEM_VEHICLE)
                | (classes == j_geo.SEM_PEDESTRIAN))
    setup = j_camera.project_triangles(tris, colors, classes, cam, HW, HW, fov or 90.0, 0.5,
                                       cullable=cullable)
    return tris, cam, setup


_J_FAST = jax.jit(jax.vmap(lambda s: j_rf.rasterize_luma_fast(
    s, HW, HW, lod_px=2.0, quads=False, interpret=True)))


@pytest.mark.parametrize("preset", PRESETS)
def test_preset_setup_and_frame_match(fleet, preset):
    got = make_scene_setup(P_PARAMS, P_TOWN, RenderConfig(HW, HW, max_triangles=T),
                           device="cpu", camera=preset)(convert.world_state_from_jax(fleet))
    j_setups = []
    for b in range(N_ENVS):
        st = jax.tree_util.tree_map(lambda a: a[b], fleet)
        tris, jcam, setup = _j_setup(st, preset)
        j_setups.append(setup)
        np.testing.assert_array_equal(got.valid[b].numpy(), np.asarray(setup.valid))
        for name in ("bbox", "zmin"):
            np.testing.assert_allclose(getattr(got, name)[b].numpy(),
                                       np.asarray(getattr(setup, name)), rtol=1e-5,
                                       atol=1e-4, err_msg=name)
        # rows cancel far below their terms on edge-on triangles, where
        # XLA's contracted multiply-adds and torch's separate ones differ
        rel = np.asarray(tris, np.float64) - np.asarray(jcam.pos, np.float64)
        v = np.stack([rel @ np.asarray(jcam.right), rel @ np.asarray(jcam.down),
                      rel @ np.asarray(jcam.forward)], -1)
        vn = np.abs(v).max(-1) * (HW / 2.0 + 1.0)
        term = np.stack([vn[:, 1] * vn[:, 2], vn[:, 2] * vn[:, 0], vn[:, 0] * vn[:, 1]], 1)
        scales = {"edges": term[..., None],
                  "znum": (np.abs(v[..., 2]) * term).sum(1)[..., None]}
        for name, scale in scales.items():
            g, w = getattr(got, name)[b].numpy(), np.asarray(getattr(setup, name))
            assert (np.abs(g - w) <= 1e-5 * scale + 1e-4).all(), name
    j_gray = _J_FAST(jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *j_setups))
    p_gray = p_rf.rasterize_luma_fast(got, HW, HW, lod_px=2.0)
    assert float(p_gray.std()) > 0.01
    _frames_close(p_gray.numpy(), np.asarray(j_gray), preset)


def test_unknown_camera_takes_the_forward_pose(fleet):
    ps = convert.world_state_from_jax(fleet)
    rcfg = RenderConfig(HW, HW, max_triangles=T)
    a = make_scene_setup(P_PARAMS, P_TOWN, rcfg, device="cpu", camera="fl")(ps)
    b = make_scene_setup(P_PARAMS, P_TOWN, rcfg, device="cpu")(ps)
    assert torch.equal(a.edges, b.edges) and torch.equal(a.valid, b.valid)


@pytest.mark.parametrize("k", [1, 3])
def test_update_framebuf_matches(k):
    rng = np.random.default_rng(k)
    fb = rng.integers(0, 256, (4, 8, 8, 4 * k), dtype=np.uint8)
    gray = rng.integers(0, 256, (4, 8, 8, k) if k > 1 else (4, 8, 8), dtype=np.uint8)
    reset = np.array([False, True, False, True])
    want = j_cl.update_framebuf(jnp.asarray(fb), jnp.asarray(gray), jnp.asarray(reset))
    got = p_cl.update_framebuf(torch.from_numpy(fb), torch.from_numpy(gray),
                               torch.from_numpy(reset))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    g = gray.reshape(4, 8, 8, k)
    assert (got[1].numpy() == np.tile(g[1], (1, 1, 4))).all()        # refilled
    np.testing.assert_array_equal(got[0, ..., -k:].numpy(), g[0])      # newest last
    np.testing.assert_array_equal(got[0, ..., :-k].numpy(), fb[0, ..., k:])


def _rig_stores(n=60, k=3, seed=0):
    j_store, p_store = (pipe.FrameStore.synthetic(n, 16, 16, seed=seed)
                        for pipe in (j_pipe, p_pipe))
    rng = np.random.default_rng(seed)
    starts = rng.random(n) < 0.1
    starts[0] = True
    j_store.starts, p_store.starts = starts, starts.copy()
    extra = [rng.integers(0, 256, (n, 16, 16), dtype=np.uint8) for _ in range(k - 1)]
    return j_store, p_store, extra


def test_gather_windows_stacked_matches():
    _, p_store, extra = _rig_stores()
    frames = np.stack([p_store.frames, *extra], -1)
    idx = np.array([0, 5, 17, 40, 55])
    for dtype in ("float32", "bfloat16"):
        want = j_pipe.gather_windows(jnp.asarray(frames), jnp.asarray(idx), 4, dtype)
        got = p_pipe.gather_windows(torch.from_numpy(frames), torch.from_numpy(idx), 4,
                                    getattr(torch, dtype))
        assert tuple(got.shape) == want.shape == (5, 16, 16, 12)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    # channel t·K + c: time-major, camera-minor
    np.testing.assert_array_equal(got[1, ..., 3 * 2 + 1].float().numpy(),
                                  (torch.from_numpy(extra[0][5 + 2]).to(torch.bfloat16)
                                   * torch.tensor(1 / 255, dtype=torch.bfloat16)).float())


@pytest.mark.parametrize("kind", ["plain", "cil", "continuous"])
def test_device_dataset_extra_frames_matches(kind):
    j_store, p_store, extra = _rig_stores(seed=2)
    labels = np.random.default_rng(3).normal(size=(len(p_store), 2)).astype(np.float32)
    kw = {"cil": {"cil": True}, "continuous": {"continuous_labels": labels}}.get(kind, {})
    j_ds = j_pipe.DeviceDataset(j_store, 8, shuffle=True, seed=4, extra_frames=extra, **kw)
    p_ds = p_pipe.DeviceDataset(p_store, 8, shuffle=True, seed=4, extra_frames=extra,
                                device="cpu", **kw)
    assert len(p_ds) == len(j_ds) and p_ds.n_samples == j_ds.n_samples
    for jb, pb in zip(j_ds, p_ds):
        assert pb[0].shape == (8, 16, 16, 12)
        for a, b in zip(pb, jb):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(a.numpy().dtype))


def test_device_dataset_extra_frames_shape_check():
    j_store, p_store, extra = _rig_stores()
    bad = [extra[0], extra[1][:, :8]]
    with pytest.raises(ValueError, match="extra_frames"):
        j_pipe.DeviceDataset(j_store, 8, extra_frames=bad)
    with pytest.raises(ValueError, match="extra_frames"):
        p_pipe.DeviceDataset(p_store, 8, extra_frames=bad, device="cpu")


@pytest.fixture(scope="module")
def multicamera():
    """``collect_multicamera`` of each package from one fleet state (every
    other env six steps from its limit) and one spawn pool, 2 envs × 12
    steps of the forward and rear views in RGB on the exact path."""
    cams, n_steps = ("camera", "RR"), 12
    pool = j_world.pack_spawn_pool(jax.jit(lambda: j_world.make_spawn_pool(
        J_PARAMS, TOWN, jax.random.PRNGKey(0x5EED), 1024))())
    states = _fleet(seed=5, near_end=True)
    keys = jax.random.split(jax.random.PRNGKey(0), N_ENVS)

    def reset_env(params, town, key):
        """The fleet's env whose key this is: ``collect_multicamera``
        resets one env per key of ``split(rng, n_envs)``."""
        env = jnp.argmax(jnp.all(keys == key, axis=-1))
        return jax.tree_util.tree_map(lambda a: a[env], states)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_world, "make_spawn_pool", lambda *a: None)
        mp.setattr(j_world, "pack_spawn_pool", lambda p: pool)
        mp.setattr(j_cl, "reset_env", reset_env)
        want = j_cl.collect_multicamera(J_PARAMS, TOWN, JRenderConfig(HW, HW, max_triangles=T),
                                        jax.random.PRNGKey(0), cameras=cams, n_envs=N_ENVS,
                                        n_steps=n_steps)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(p_cl, "reset_env", lambda *a: convert.world_state_from_jax(states))
        mp.setattr(p_cl, "rollout_spawn_pool", lambda *a: convert.spawn_pool_from_jax(pool))
        got = p_cl.collect_multicamera(P_PARAMS, P_TOWN, RenderConfig(HW, HW, max_triangles=T),
                                       torch.Generator().manual_seed(0), cameras=cams,
                                       n_envs=N_ENVS, n_steps=n_steps, device="cpu")
    return cams, n_steps, want, got


def test_collect_multicamera_matches_jax(multicamera):
    cams, n_steps, (j_frames, j_log, j_starts), (p_frames, p_log, p_starts) = multicamera
    np.testing.assert_array_equal(p_starts, j_starts)
    assert p_starts.sum() > N_ENVS                    # an auto-reset is marked
    for col in p_fl.STATE_COLUMNS:
        np.testing.assert_allclose(getattr(p_log, col), getattr(j_log, col), rtol=1e-5,
                                   atol=1e-4, err_msg=col)
    assert list(p_frames) == list(cams) and set(j_frames) == set(cams)
    for cam in cams:
        assert p_frames[cam].shape == (N_ENVS * n_steps, HW, HW)
        assert p_frames[cam].dtype == np.uint8
        _frames_close(p_frames[cam] / 255.0, j_frames[cam] / 255.0, cam)
    assert not np.array_equal(p_frames["camera"], p_frames["RR"])


def test_surround_rollout_keeps_the_single_view(fleet):
    """The surround rollout's first view and its dynamics are the
    single-camera rollout's; its window holds all three views."""
    rcfg = RenderConfig(HW, HW, max_triangles=T)
    runs = {}
    for cams in (("camera",), ("camera", "FL", "FR")):
        init_fn, rollout_fn = p_cl.make_rollout(P_PARAMS, P_TOWN, rcfg, None, device="cpu",
                                                cameras=cams)
        carry = init_fn(torch.Generator().manual_seed(1), N_ENVS)
        runs[cams] = rollout_fn(carry, 5)
    (c1, t1), (c3, t3) = runs.values()
    for key in ("gray", "speed", "action", "done"):
        assert torch.equal(t1[key], t3[key]), key
    assert "views" not in t1 and tuple(t3["views"].shape) == (5, N_ENVS, HW, HW, 3)
    assert torch.equal(t3["views"][..., 0], t3["gray"])
    assert tuple(c3[1].shape) == (N_ENVS, HW, HW, 12)
    assert torch.equal(c3[1][..., ::3], c1[1])
    streams = p_cl.extra_view_streams(t3)
    assert len(streams) == 2 and streams[0].shape == (N_ENVS * 5, HW, HW)
    np.testing.assert_array_equal(streams[1][:5], t3["views"][:, 0, ..., 2].numpy())


def test_surround_cams():
    for compose, ex in ((j_compose, j_ex), (p_compose, p_ex)):
        assert ex._surround_cams(compose("config")) == ("camera",)
        cfg = compose("config", overrides=["surround_cameras=['camera', 'SL', 'RR']"])
        assert ex._surround_cams(cfg) == ("camera", "SL", "RR")
        with pytest.raises(ValueError, match="unknown camera preset"):
            ex._surround_cams(compose("config", overrides=["surround_cameras=['camera', 'fl']"]))


def test_registry_equals_jax():
    assert set(p_ex.EXPERIMENTS) == set(j_ex.EXPERIMENTS) and len(p_ex.EXPERIMENTS) == 30
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["list"]) == 0
    assert len(out.getvalue().splitlines()) == 30


def _rig_log(n_envs=2, n_steps=40, seed=3):
    """A synthetic three-view rig log (frames per camera, state log,
    starts), the same in each package's types."""
    rng = np.random.default_rng(seed)
    n = n_envs * n_steps
    frames = {c: rng.integers(0, 256, (n, HW, HW), dtype=np.uint8)
              for c in ("camera", "FL", "FR")}
    cols = {"steer": rng.uniform(-1, 1, n), "throttle": rng.uniform(0, 1, n),
            "brake": (rng.random(n) < 0.2).astype(np.float64),
            "trafficlight": rng.integers(0, 2, n).astype(np.float64),
            "current_steer": rng.uniform(-0.5, 0.5, n), "speed_long": rng.uniform(0, 9, n),
            "speed": rng.uniform(0, 9, n)}
    starts = np.zeros(n, bool)
    starts[::n_steps] = True
    starts[13] = True
    return frames, (j_fl.StateLog(**cols), p_fl.StateLog(**cols)), starts


def test_bc_surround_run_matches_jax(tmp_path, monkeypatch):
    """Both runs start from one state of numpy-drawn weights: the JAX
    experiment's ``create_train_state`` hands it out, the port's run
    resumes it from a checkpoint."""
    frames, (j_log, p_log), starts = _rig_log()
    extra = [*TINY, "n_envs=2", "n_steps=40", "eval_envs=2", "eval_steps=4",
             "image_height=32", "image_width=32", "NUM_EPOCHS=1", "BATCH_SIZE=8",
             "compute_dtype=float32"]

    def over(pkg, *more):
        return ["model=imitation", "experiment=bc_surround", f"data_dir={tmp_path / 'data'}",
                f"log_dir={tmp_path / pkg}", *extra, *more]

    jmodel = JPolicyCNN(obs_size=12, dtype=jnp.float32)
    example = (jnp.zeros((1, HW, HW, 12)),)
    weights = numpy_params(jmodel, example, seed=21)
    init = template_train_state(jmodel, None, example, optax.adam(1e-3), params=weights)
    ppath = tmp_path / "init_port"
    p_ckpt.save_pytree(ppath, convert.checkpoint_from_jax(
        {"params": init.params, "opt_state": init.opt_state, "step": init.step}))
    monkeypatch.setattr(j_ex, "create_train_state", functools.partial(
        template_train_state, params=weights))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_cl, "collect_multicamera", lambda *a, **k: (frames, j_log, starts))
        mp.setattr(j_cl, "evaluate_policy", lambda *a, **k: {})
        jres = j_ex.EXPERIMENTS["bc_surround"](j_compose("config", overrides=over("jax")))
    args = ["run"]
    for o in over("port", f"resume_checkpoint={ppath}", "device=cpu"):
        args += ["-o", o]
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(p_cl, "collect_multicamera", lambda *a, **k: (frames, p_log, starts))
        assert cli.main([*args, "--json"]) == 0
    pres = json.loads(out.getvalue().strip().splitlines()[-1])
    _same_history(pres, jres, epochs=1)
    assert pres["cameras"] == jres["cameras"] == ["camera", "FL", "FR"]
    assert pres["eval"]["env_steps"] == 8 and 0.0 <= pres["eval"]["driving_score"] <= 1.0
