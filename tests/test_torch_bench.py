"""The port's headline benchmark (``carla_imitation_learning_tpu_torch/
bench.py``, ``cli bench``) against the JAX package's root ``bench.py``.

- The gate's scene on the bench town (3 blocks, 24 buildings, 8 lights, 15
  agents, 512 triangles, 128², fov 90, near 0.5, no culling) from one JAX
  reset: the port's setup (``bench_setup``) against JAX's
  ``project_triangles`` at ``tests/test_torch_render.py``'s projection
  tolerance (valid equal; bbox and zmin rtol 1e-5 / atol 1e-4; edge and
  depth rows within 1e-5 of their terms' size), and the port's plain
  exact frame (``rasterize_plain``, the gate's reference, and
  ``rasterize_exact``'s plain path) against ``rasterize_jax`` at max|d| <
  1e-5 with the semantic planes equal.
- The port's plain fast frame against JAX's ``rasterize_luma_fast`` run in
  interpret mode on the same JAX setup, at ``tests/test_torch_raster_fast.py``'s
  tolerance (mean|d| < 2e-3, < 1 % of pixels off by more than 2/255).
- The gate, and the three timed functions at a small size (8 envs, batch
  8, 64², short protocols), give finite positive figures on the CPU.
- ``main``'s last line has the JAX bench's keys and metric, with
  ``vs_baseline`` null; ``cli bench`` without a card raises.
"""

import ast
import functools
import json
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_imitation_learning_tpu.ops.raster_fast import rasterize_luma_fast as j_fast
from carla_imitation_learning_tpu.render import geometry as j_geo
from carla_imitation_learning_tpu.render.camera import camera_from_ego, project_triangles
from carla_imitation_learning_tpu.render.jax_raster import rasterize_jax
from carla_imitation_learning_tpu.sim import SimParams, make_town
from carla_imitation_learning_tpu.sim import agents as j_agents
from carla_imitation_learning_tpu.sim.world import reset_env
from carla_imitation_learning_tpu_torch import bench, cli, convert
from carla_imitation_learning_tpu_torch.ops import raster as p_raster
from carla_imitation_learning_tpu_torch.ops import raster_fast as p_fast
from carla_imitation_learning_tpu_torch.render import geometry as p_geo
from carla_imitation_learning_tpu_torch.render.plain_raster import rasterize_plain

ROOT = pathlib.Path(__file__).resolve().parents[1]
H = W = 128
T = 512


@pytest.fixture(scope="module")
def scene():
    """JAX's gate scene from PRNGKey(0) (state, camera, triangles, setup)
    and the port's setup of the same state."""
    town = make_town(**bench.BENCH_TOWN)
    params = SimParams(n_agents=15)
    static = j_geo.build_static_scene(town)

    @jax.jit
    def jax_scene(key):     # the JAX bench's gate, bench.py:63-73, in one program
        st = reset_env(params, town, key)
        phases = j_agents.light_phases(town, st.t.astype(jnp.float32) * params.dt,
                                       params.light_green, params.light_yellow,
                                       params.light_red)
        ap, ay = j_agents.agent_positions(town, st.agents_route, st.agents_s)
        tris, colors, classes = j_geo.assemble_scene(static, town.lights_pos, phases, ap, ay, T)
        cam = camera_from_ego(st.ego_pos, st.ego_yaw)
        return st, cam, tris, project_triangles(tris, colors, classes, cam, W, H, 90.0, 0.5)

    st, cam, tris, setup = jax_scene(jax.random.PRNGKey(0))

    p_params, p_town = bench.bench_world(torch.device("cpu"))
    p_setup = bench.bench_setup(p_params, p_town, p_geo.build_static_scene(p_town),
                                convert.world_state_from_jax(st), H)
    return {"cam": cam, "tris": tris, "setup": setup, "p_setup": p_setup}


def test_bench_setup_matches_project_triangles(scene):
    got, setup = scene["p_setup"], scene["setup"]
    np.testing.assert_array_equal(got.valid[0].numpy(), np.asarray(setup.valid))
    for name in ("bbox", "zmin"):
        np.testing.assert_allclose(getattr(got, name)[0].numpy(), np.asarray(getattr(setup, name)),
                                   rtol=1e-5, atol=1e-4, err_msg=name)
    # XLA contracts the cross products into FMAs and torch does not: edge and
    # depth rows agree relative to their terms' size (tests/test_torch_render.py)
    cam = scene["cam"]
    rel = np.asarray(scene["tris"], np.float64) - np.asarray(cam.pos, np.float64)
    v = np.stack([rel @ np.asarray(cam.right), rel @ np.asarray(cam.down),
                  rel @ np.asarray(cam.forward)], -1)
    vn = np.abs(v).max(-1) * (W / 2.0 + 1.0)
    term = np.stack([vn[:, 1] * vn[:, 2], vn[:, 2] * vn[:, 0], vn[:, 0] * vn[:, 1]], 1)
    scales = {"edges": term[..., None], "znum": (np.abs(v[..., 2]) * term).sum(1)[..., None]}
    for name, scale in scales.items():
        g, w = getattr(got, name)[0].numpy(), np.asarray(getattr(setup, name))
        assert (np.abs(g - w) <= 1e-5 * scale + 1e-4).all(), name


def test_plain_exact_frame_matches_rasterize_jax(scene):
    rgb_j, sem_j, _ = rasterize_jax(scene["setup"], H, W)
    for fn in (rasterize_plain, p_raster.rasterize_exact):
        rgb_p, sem_p, _ = fn(scene["p_setup"], H, W)
        np.testing.assert_array_equal(sem_p[0].numpy(), np.asarray(sem_j))
        assert np.abs(rgb_p[0].numpy() - np.asarray(rgb_j)).max() < 1e-5, fn.__name__
    assert (np.asarray(sem_j) != 0).mean() > 0.3     # the scene is in view


def test_plain_fast_frame_matches_jax_interpret(scene):
    want = np.asarray(j_fast(scene["setup"], H, W, interpret=True))
    got = p_fast.rasterize_luma_fast(convert.setup_from_jax(
        jax.tree_util.tree_map(lambda x: x[None], scene["setup"])), H, W)[0].numpy()
    d = np.abs(got - want)
    assert d.mean() < 2e-3, d.mean()
    assert (d > 2 / 255).mean() < 0.01, (d > 2 / 255).mean()


def test_parity_gate_on_the_cpu():
    res = bench.assert_kernel_parity(1, device="cpu")
    assert res["exact_max_abs_diff"] < 1e-5
    assert res["fast_worst_frac_over_2_255"] < 0.01


SMALL = {
    "bench_closed_loop": functools.partial(bench.bench_closed_loop, 8, hw=64, lengths=(2, 6),
                                           repeats=1),
    "bench_bc_images": functools.partial(bench.bench_bc_images, 8, 64, lengths=(1, 2),
                                         repeats=1),
    "bench_bc_fused": functools.partial(bench.bench_bc_fused, 8, 64, lengths=(1, 2), repeats=1),
}


@pytest.mark.parametrize("name", list(SMALL))
def test_timed_function_small(name):
    rate = SMALL[name](device="cpu")
    assert math.isfinite(rate) and rate > 0


def _jax_headline_dict() -> dict:
    """The dict the JAX bench's ``main`` prints: {key: source of its value}."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    d = next(n for n in ast.walk(main) if isinstance(n, ast.Dict))
    return {k.value: ast.unparse(v) for k, v in zip(d.keys, d.values)}


def test_main_last_line_has_the_jax_keys(monkeypatch, capsys):
    """``main`` on the CPU with the timed functions (tested above) patched to
    record their calls and return a rate."""
    calls = []
    for name in SMALL:
        monkeypatch.setattr(bench, name, lambda device, name=name: (
            calls.append((name, device.type)), 1234.56)[1])
    monkeypatch.setattr(bench, "assert_kernel_parity",
                        lambda **kw: pytest.fail("the gate runs on the card only"))
    assert cli.main(["bench", "--device", "cpu"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    out = json.loads(last)
    want = _jax_headline_dict()
    assert list(out) == list(want)
    assert repr(out["metric"]) == want["metric"] and out["unit"] == "env-steps/sec"
    assert out["vs_baseline"] is None and out["value"] == 1234.6
    assert calls == [("bench_bc_images", "cpu"), ("bench_bc_fused", "cpu"),
                     ("bench_closed_loop", "cpu")]


def test_cli_bench_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["bench"])
