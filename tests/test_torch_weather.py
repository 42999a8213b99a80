"""Rain and sun of the PyTorch port vs the JAX package: the rain hash bit
for bit (inputs near 2³² included), ``apply_rain`` on gray and RGB frames
from keys and steps whose streak phases go negative (equal to 1e-6), the
sun's exposure scale, and all three renderer branches with fog, rain and
sun against JAX's ``make_renderer`` on the same fleet states, at the
raster tolerances: the fast branch (kernel B) mean|d| < 2e-3 with under 1 %
of pixels off by more than 2/255 (JAX's kernels run in interpret mode,
whose reciprocal goes through bfloat16), the exact branches max|d| < 1e-5
with the class ids equal."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import carla_imitation_learning_tpu.ops.raster as j_raster
import carla_imitation_learning_tpu.ops.raster_fast as j_raster_fast
from carla_imitation_learning_tpu.render import weather as j_weather
from carla_imitation_learning_tpu.render.pipeline import RenderConfig as JRenderConfig
from carla_imitation_learning_tpu.render.pipeline import make_renderer as j_make_renderer
from carla_imitation_learning_tpu.sim import SimParams as JParams
from carla_imitation_learning_tpu.sim import make_town
from carla_imitation_learning_tpu.sim import world as j_world
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch.render import weather as p_weather
from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig, make_renderer
from carla_imitation_learning_tpu_torch.sim.world import SimParams

H = W = 64
RNG = np.random.default_rng(0)
KEYS = RNG.integers(0, 2 ** 32, (5, 2), dtype=np.uint64).astype(np.uint32)
# a step past H / 4 makes the streak phase y − 4t negative on every row
STEPS = np.asarray([0, 3, 17, 250, 399], np.int32)
TOWN = make_town(blocks=2, n_buildings=6, n_lights=2)
J_PARAMS, P_PARAMS = JParams(n_agents=3), SimParams(n_agents=3)


def test_hash_bit_for_bit():
    x = np.concatenate([RNG.integers(0, 2 ** 32, 4096, dtype=np.uint64),
                        np.arange(2 ** 32 - 64, 2 ** 32, dtype=np.uint64),
                        np.arange(64, dtype=np.uint64)]).astype(np.uint32)
    want = np.asarray(j_weather._hash_u32(jnp.asarray(x))).astype(np.int64)
    got = p_weather._hash_u32(torch.as_tensor(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)
    # the low 32 bits of a negative int64 hash like its uint32 wrap
    neg = torch.as_tensor([-1, -5, -(2 ** 31)], dtype=torch.int64)
    np.testing.assert_array_equal(p_weather._hash_u32(neg).numpy(),
                                  p_weather._hash_u32(neg & 0xFFFFFFFF).numpy())


@pytest.mark.parametrize("channels", [0, 3])
@pytest.mark.parametrize("intensity", [0.8, 0.6, 0.0])
def test_apply_rain_matches(channels, intensity):
    shape = (len(STEPS), 40, 48) + ((channels,) if channels else ())
    img = RNG.uniform(0, 1, shape).astype(np.float32)
    want = jax.vmap(lambda i, k, t: j_weather.apply_rain(i, k, t, intensity))(
        img, KEYS, STEPS)
    got = p_weather.apply_rain(torch.as_tensor(img), torch.as_tensor(KEYS.astype(np.int64)),
                               torch.as_tensor(STEPS.astype(np.int64)), intensity)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    if intensity:
        assert (got.numpy() > img * (1.0 - 0.18 * intensity) + 0.1).any()  # streaks drawn


@pytest.fixture(scope="module")
def fleet():
    """Three JAX fleet states at steps with negative streak phases."""
    st = jax.jit(jax.vmap(lambda k: j_world.reset_env(J_PARAMS, TOWN, k)))(
        jax.random.split(jax.random.PRNGKey(9), 3))
    return st.replace(t=jnp.asarray([0, 40, 399], jnp.int32))


def _render_both(fleet, **kw):
    """One fleet rendered by JAX's ``make_renderer`` (its kernels in
    interpret mode) and by the port's, with fog, rain and sun on."""
    kw = dict(max_triangles=256, fog_density=0.02, rain=0.8, sun=0.25, **kw)
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((j_raster_fast, "rasterize_luma_fast"),
                          (j_raster, "rasterize_pallas_luma"), (j_raster, "rasterize_pallas")):
            mp.setattr(mod, name, functools.partial(getattr(mod, name), interpret=True))
        render = j_make_renderer(J_PARAMS, TOWN, JRenderConfig(H, W, backend="pallas", **kw))
        want = jax.jit(jax.vmap(render))(fleet)
    got = make_renderer(P_PARAMS, convert.town_from_jax(TOWN), RenderConfig(H, W, **kw),
                        device="cpu")(convert.world_state_from_jax(fleet))
    return got, want


def test_fast_branch_rain_and_sun(fleet):
    got, want = _render_both(fleet, rgb=False, fast=True, lod_px=0.0)
    d = np.abs(got["gray"].numpy() - np.asarray(want["gray"]))
    assert d.mean() < 2e-3 and (d > 2 / 255).mean() < 0.01, d.mean()
    assert got["gray"].max() <= 0.25 + 1e-6  # the sun scales the frame last


@pytest.mark.parametrize("rgb", [False, True])
def test_exact_branches_rain_and_sun(fleet, rgb):
    got, want = _render_both(fleet, rgb=rgb)
    np.testing.assert_array_equal(got["semantic"].numpy(), np.asarray(want["semantic"]))
    for key in ("gray", "rgb") if rgb else ("gray",):
        assert np.abs(got[key].numpy() - np.asarray(want[key])).max() < 1e-5, key


def test_sun_scales_exposure(fleet):
    """Sun alone is the frame times ``sun``, bit for bit; rain alone is
    ``apply_rain`` of the dry frame."""
    state = convert.world_state_from_jax(fleet)
    town = convert.town_from_jax(TOWN)
    base = RenderConfig(H, W, max_triangles=256, rgb=False, fast=True, lod_px=0.0)
    dry = make_renderer(P_PARAMS, town, base, device="cpu")(state)["gray"]
    night = make_renderer(P_PARAMS, town, dataclasses.replace(base, sun=0.2),
                          device="cpu")(state)["gray"]
    wet = make_renderer(P_PARAMS, town, dataclasses.replace(base, rain=0.6),
                        device="cpu")(state)["gray"]
    assert torch.equal(night, dry * 0.2)
    assert torch.equal(wet, p_weather.apply_rain(dry, state.rng, state.t, 0.6))
