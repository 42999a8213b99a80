"""The plain reference held against the port on the CPU at a tiny size:
the frozen simulator step for step, the plain z-buffer against kernel B's
plain version, the float32 policies, and three behaviour-cloning steps."""

import dataclasses

import numpy as np
import pytest
import torch

from perfbench.kinds import policy as policy_lib
from perfbench.reference import closed_loop as ref_loop
from perfbench.reference.raster import rasterize_gray
from perfbench.reference.train import bc_steps, windows

TOWN = {"blocks": 3, "n_buildings": 24, "n_lights": 8}
RENDER = {"height": 128, "width": 128, "max_triangles": 512, "lod_px": 2.0}


def _fields(state):
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}


def test_frozen_sim_follows_the_port_step_for_step():
    from carla_imitation_learning_tpu_torch.sim.town import make_town
    from carla_imitation_learning_tpu_torch.sim.world import SimParams, reset_env, step_env
    from carla_imitation_learning_tpu_torch.training.closed_loop import (
        control_from_discrete, rollout_spawn_pool,
    )
    from carla_imitation_learning_tpu_torch.sim.world import pick_fresh_packed

    params, town = SimParams(n_agents=15), make_town(**TOWN)
    pool = rollout_spawn_pool(params, town)
    ref = ref_loop.RefLoop({"n_agents": 15}, TOWN, RENDER, "cpu")
    st = reset_env(params, town, torch.Generator().manual_seed(7), 16)
    rst = ref.reset(torch.Generator().manual_seed(7), 16)
    near_end = torch.arange(16) % 2 == 0
    st = st.replace(t=torch.where(near_end, params.episode_len - 3, st.t))
    rst = rst.replace(t=st.t.clone())
    actions = torch.Generator().manual_seed(8)
    resets = 0
    for _ in range(12):
        a = torch.randint(0, 9, (16,), generator=actions)
        st, info = step_env(params, town, st, control_from_discrete(a),
                            pick_fresh_packed(pool, params, st))
        rst, rinfo = ref.step(rst, a)
        resets += int(info["done"].sum())
        for k, v in _fields(st).items():
            assert torch.equal(v, getattr(rst, k)), k
        for k in ("done", "collision", "offroad", "speed"):
            assert torch.equal(info[k], rinfo[k]), k
    assert resets > 0


def test_plain_frame_matches_kernel_b_plain_version():
    from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig, make_renderer
    from carla_imitation_learning_tpu_torch.sim.town import make_town
    from carla_imitation_learning_tpu_torch.sim.world import SimParams, reset_env

    params, town = SimParams(n_agents=15), make_town(**TOWN)
    render = make_renderer(params, town, RenderConfig(**RENDER, rgb=False, fast=True), "cpu")
    st = reset_env(params, town, torch.Generator().manual_seed(3), 6)
    got = torch.clamp(render(st)["gray"] * 255.0 + 0.5, 0, 255).to(torch.uint8)
    ref = ref_loop.RefLoop({"n_agents": 15}, TOWN, RENDER, "cpu")
    want, covering, kept = ref.frame(ref.reset(torch.Generator().manual_seed(3), 6))
    off = ((got.to(torch.int16) - want.to(torch.int16)).abs() > 2).float().mean()
    assert float(off) < 1e-3
    assert bool((covering > 0).all()) and bool((kept > 0).all())


def test_lod_drops_small_triangles():
    edges = torch.tensor([[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [-1.0, -1.0, 8.0]]])[None]
    znum = torch.tensor([[[0.0, 0.0, 80.0]]])
    colors = torch.ones(1, 1, 3)
    valid = torch.ones(1, 1, dtype=torch.bool)
    zmin = torch.full((1, 1), 10.0)
    big = torch.tensor([[[0.0, 8.0, 0.0, 8.0]]])
    small = torch.tensor([[[0.0, 1.0, 0.0, 1.0]]])
    g_big, c_big = rasterize_gray(edges, znum, colors, valid, big, zmin, 8, 8, lod_px=2.0)
    g_small, c_small = rasterize_gray(edges, znum, colors, valid, small, zmin, 8, 8, lod_px=2.0)
    assert int(c_big) > 0 and int(c_small) == 0
    assert float(g_big[0, 0, 0]) == pytest.approx(1.0 / (1.0 + 0.004 * 10.0), rel=1e-5)


def _cfg(name, depth=None):
    import json

    from perfbench import harness

    cfg = json.loads((harness.BENCH_DIR / "configs" / f"{name}.json").read_text())
    cfg["compute_dtype"] = "float32"
    if depth is not None:
        cfg["port"] = {**cfg["port"], "kwargs": {**cfg["port"]["kwargs"], "depth": depth}}
        cfg["reference"] = {**cfg["reference"],
                            "sizes": {**cfg["reference"]["sizes"], "depth": depth}}
    return cfg


@pytest.mark.parametrize("name,hw", [("convnet1", 128), ("deit_tiny", 128), ("deit_tiny", 64)])
def test_float32_policy_matches_the_port(name, hw):
    model, weights, reference = policy_lib.build(_cfg(name), 11, torch.device("cpu"))
    x = torch.rand(3, hw, hw, 4, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        torch.testing.assert_close(model(x), reference(weights, x), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["convnet1", "deit_tiny"])
def test_three_bc_steps_match_the_port(name):
    from carla_imitation_learning_tpu_torch.data.pipeline import DeviceDataset, FrameStore
    from carla_imitation_learning_tpu_torch.training import bc_loss_fn
    from carla_imitation_learning_tpu_torch.training.steps import (
        create_train_state, make_fused_epoch, make_optimizer,
    )

    model, weights, reference = policy_lib.build(_cfg(name, depth=2 if name != "convnet1"
                                                      else None), 5, torch.device("cpu"))
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (40, 64, 64), dtype=np.uint8)
    actions = rng.integers(0, 9, 40).astype(np.int32)
    ds = DeviceDataset(FrameStore(frames, actions, np.zeros(40, np.int32),
                                  np.zeros((40, 3), np.float32)), batch_size=6, device="cpu")
    state = create_train_state(model, make_optimizer({"LEARNING_RATE": 1e-3,
                                                      "gradient_clip_val": 0.5}), device="cpu")
    order = torch.as_tensor(rng.integers(0, ds.n_samples, (3, 6)))
    _, _, m = make_fused_epoch(bc_loss_fn, ds.pure_batch)(state, order)
    batches = [windows(torch.from_numpy(frames), torch.from_numpy(actions), row) for row in order]
    losses, _, params = bc_steps(reference, weights, batches)
    torch.testing.assert_close(m["loss"], torch.tensor(losses), rtol=1e-4, atol=1e-5)
    for k, p in state.model.named_parameters():
        torch.testing.assert_close(p.detach(), params[k], rtol=1e-4, atol=2e-5)
