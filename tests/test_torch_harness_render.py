"""The port's ``rollout_breakdown`` harness against the JAX package: its
scene setup (an evolving camera 0.4 m along the route), the ``lists_only``
front end (quad fusion, primitive table, band lists) and the
``render_only`` frame.

The JAX side mirrors ``benchmarks/rollout_breakdown.py:132-163`` (nested in
its ``main``) over the JAX package's public functions, with the fast
kernel in interpret mode; the fleet is the JAX package's ``reset_env``
carried across with ``convert``. Tolerances: the fast raster's
(``tests/test_raster_fast.py``), mean|d| < 2e-3 and < 1 % of pixels off by
more than 2/255; list counts equal; poses and table sums allclose in fp32.
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

from carla_imitation_learning_tpu.ops import raster_fast as j_fast
from carla_imitation_learning_tpu.render import geometry as j_geo
from carla_imitation_learning_tpu.render.camera import camera_from_ego, project_triangles
from carla_imitation_learning_tpu.render.pipeline import RenderConfig as JRenderConfig
from carla_imitation_learning_tpu.sim import SimParams as JParams
from carla_imitation_learning_tpu.sim import agents as j_agents
from carla_imitation_learning_tpu.sim import make_town as j_make_town
from carla_imitation_learning_tpu.sim import world as j_world
from carla_imitation_learning_tpu.sim.town import route_point as j_route_point
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch.ops import raster_fast as p_fast
from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
from carla_imitation_learning_tpu_torch.sim.world import SimParams

ROOT = Path(__file__).resolve().parents[1]
H = W = 64
T = 256
N_ENVS, STEPS = 2, 2
TOWN_KW = dict(blocks=2, n_buildings=6, n_lights=2)


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"{name}_torch_harness", ROOT / "benchmarks_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


breakdown = _load("rollout_breakdown")


def _check_b_tolerance(got, want, what):
    d = np.abs(got - want)
    assert d.mean() < 2e-3, f"{what}: mean diff {d.mean()}"
    assert (d > 2 / 255).mean() < 0.01, f"{what}: {(d > 2 / 255).mean():.3%} pixels off"


@pytest.fixture(scope="module")
def world():
    town = j_make_town(**TOWN_KW)
    params = JParams(n_agents=3)
    rcfg = JRenderConfig(height=H, width=W, backend="pallas", fast=True, rgb=False,
                         max_triangles=T, lod_px=-1.0)
    states = jax.jit(jax.vmap(lambda k: j_world.reset_env(params, town, k)))(
        jax.random.split(jax.random.PRNGKey(2), N_ENVS))
    static = j_geo.build_static_scene(town, facade_bands=rcfg.facade_bands)

    def scene_setup(s, dt_s):
        """``benchmarks/rollout_breakdown.py:132-148``."""
        s_adv = s.replace(ego_s=s.ego_s + dt_s)
        pos, yaw = j_route_point(town, s_adv.ego_route, s_adv.ego_s)
        phases = j_agents.light_phases(
            town, s.t.astype(jnp.float32) * params.dt,
            params.light_green, params.light_yellow, params.light_red)
        ap, ay = j_agents.agent_positions(town, s.agents_route, s.agents_s)
        tris, colors, classes = j_geo.assemble_scene(
            static, town.lights_pos, phases, ap, ay, T, shadows=rcfg.shadows)
        cullable = ((classes == j_geo.SEM_BUILDING) | (classes == j_geo.SEM_VEHICLE))
        cam = camera_from_ego(pos, yaw)
        return s_adv, project_triangles(tris, colors, classes, cam, W, H,
                                        90.0, 0.5, cullable=cullable)

    def lists(setup):
        """``:157-162``: the kernel's front end."""
        prims = j_fast.fuse_prims(setup)
        tris = j_fast.pack_setup_prims(prims)
        _idx, count = j_fast.tile_lists_fast(prims, H, T, width=W,
                                             lod_px=max(rcfg.lod_px, 0.0))
        return tris, count

    j_setup_fn = jax.jit(jax.vmap(lambda s: scene_setup(s, breakdown.ADVANCE_M)))
    j_lists_fn = jax.jit(jax.vmap(lists))
    frames, setups, counts, sums, advanced = [], [], [], [], []
    s = states
    for _ in range(STEPS):
        s, setup = j_setup_fn(s)
        tris, count = j_lists_fn(setup)
        frames.append(np.stack([np.asarray(j_fast.rasterize_luma_fast(
            jax.tree_util.tree_map(lambda a, b=b: a[b], setup), H, W,
            lod_px=rcfg.lod_px, interpret=True)) for b in range(N_ENVS)]))
        setups.append(setup)
        count = count.reshape(N_ENVS, -1)       # a (rows, 1) column per env
        counts.append(np.asarray(count))
        sums.append(np.asarray(jnp.sum(tris[:, 0], -1) + jnp.sum(count, -1)))
        advanced.append(np.asarray(s.ego_s))
    p_town = convert.town_from_jax(town)
    p_rcfg = RenderConfig(height=H, width=W, fast=True, rgb=False, max_triangles=T,
                          lod_px=-1.0)
    return dict(town=town, p_town=p_town, p_rcfg=p_rcfg, states=states, frames=frames,
                setups=setups, counts=counts, sums=sums, advanced=advanced)


def test_scene_setup_matches_jax(world):
    """The port's evolving camera: poses, quad rows and the render of its
    own setup against the JAX mirror's frame, step by step."""
    p_setup_fn = breakdown.make_scene_setup(SimParams(n_agents=3), world["p_town"],
                                            world["p_rcfg"], torch.device("cpu"))
    s = convert.world_state_from_jax(world["states"])
    for step in range(STEPS):
        s, setup = p_setup_fn(s, breakdown.ADVANCE_M)
        np.testing.assert_allclose(s.ego_s.numpy(), world["advanced"][step], rtol=1e-6)
        assert setup.pair_ok is not None and setup.zinv is not None
        np.testing.assert_array_equal(setup.pair_ok.numpy(),
                                      np.asarray(world["setups"][step].pair_ok))
        got = p_fast.rasterize_luma_fast(setup, H, W, lod_px=-1.0, quads=True).numpy()
        _check_b_tolerance(got, world["frames"][step], f"step {step}")


def test_lists_only_counts_equal(world):
    """The ``lists_only`` front end on each step's JAX setup: band counts
    equal, table and count sums allclose."""
    for step in range(STEPS):
        setup = convert.setup_from_jax(world["setups"][step])
        prims = p_fast.fuse_prims(setup)
        tbl = p_fast.pack_setup_prims(prims)
        _, count = p_fast.tile_lists_fast(prims, H, T, width=W, lod_px=0.0)
        np.testing.assert_array_equal(count.numpy(), world["counts"][step])
        acc = tbl[:, 0].sum(-1) + count.sum(-1).to(torch.float32)
        np.testing.assert_allclose(acc.numpy(), world["sums"][step], rtol=1e-5)


@pytest.mark.parametrize("do_kernel", [False, True], ids=["lists_only", "render_only"])
def test_render_loop_accumulates_like_jax(world, do_kernel):
    """``make_render_loop`` over STEPS steps from the converted fleet: the
    accumulator of its front end (or of its frames) against the JAX
    mirror's, and the fleet advanced as far."""
    setup_fn = breakdown.make_scene_setup(SimParams(n_agents=3), world["p_town"],
                                          world["p_rcfg"], torch.device("cpu"))
    loop = breakdown.make_render_loop(setup_fn, world["p_rcfg"], do_kernel)
    s0 = convert.world_state_from_jax(world["states"])
    s, acc = loop((s0, torch.zeros(N_ENVS)), STEPS)
    np.testing.assert_allclose(s.ego_s.numpy(), world["advanced"][-1], rtol=1e-6)
    if do_kernel:
        want = sum(f.sum((1, 2)) for f in world["frames"])
        np.testing.assert_allclose(acc.numpy(), want, atol=2e-3 * H * W * STEPS)
    else:
        np.testing.assert_allclose(acc.numpy(), sum(world["sums"]), rtol=1e-4)


def test_lod_minus_one_culls_nothing(world):
    """The harness hands ``lod_px=-1`` to the render: in the port as in the
    JAX package (``lod_px > 0`` gates the cull) it equals ``lod_px=0``,
    kernel B and C alike, and the port's frame at −1 holds to the JAX
    frame at −1."""
    setup = convert.setup_from_jax(world["setups"][0])
    for quads in (False, True):
        a = p_fast.rasterize_luma_fast(setup, H, W, lod_px=-1.0, quads=quads)
        b = p_fast.rasterize_luma_fast(setup, H, W, lod_px=0.0, quads=quads)
        assert torch.equal(a, b), quads
    two = p_fast.rasterize_luma_fast(setup, H, W, lod_px=2.0, quads=True)
    _, c_m1 = p_fast.tile_lists_fast(p_fast.fuse_prims(setup), H, T, width=W, lod_px=-1.0)
    _, c_2 = p_fast.tile_lists_fast(p_fast.fuse_prims(setup), H, T, width=W, lod_px=2.0)
    assert (c_m1 >= c_2).all() and two.shape == (N_ENVS, H, W)
    _check_b_tolerance(p_fast.rasterize_luma_fast(setup, H, W, lod_px=-1.0,
                                                  quads=True).numpy(),
                       world["frames"][0], "lod -1")


def test_report_keys_and_derived():
    sec = {"full": 0.010, "expert": 0.007, "sim_only": 0.002, "lists_only": 0.003,
           "render_only": 0.0045}
    out = breakdown.report(8, False, -1.0, sec)
    assert set(out) == {"envs", "rich", "lod_px", "ms_per_fleet_step",
                        "env_steps_per_sec_full", "derived_ms"}
    assert list(out["ms_per_fleet_step"]) == list(breakdown.COMPONENTS)
    assert out["env_steps_per_sec_full"] == pytest.approx(800.0)
    assert out["derived_ms"]["policy_fwd"] == pytest.approx(3.0)
    assert out["derived_ms"]["raster_kernel"] == pytest.approx(1.5)


def test_rollout_breakdown_main_toy(tmp_path, monkeypatch):
    """All five components and the report at 2 envs, a 32² camera and
    pairs of 1 and 2 steps."""
    monkeypatch.setattr(breakdown, "marginal", functools.partial(
        breakdown.marginal, n_small=1, n_big=2, reps=1))
    monkeypatch.setattr(breakdown, "render_config", lambda rich, lod: RenderConfig(
        height=32, width=32, fast=True, rgb=False, max_triangles=512, lod_px=lod))
    out = tmp_path / "rb.json"
    res = breakdown.main(["--device", "cpu", "--envs", "2", "--out", str(out)])
    saved = json.loads(out.read_text())
    assert saved["ms_per_fleet_step"].keys() == set(breakdown.COMPONENTS)
    assert all(np.isfinite(v) for v in res["ms_per_fleet_step"].values())
    assert saved["lod_px"] == -1.0 and saved["rich"] is False and saved["device"] == "cpu"
