"""The multi-task ``AuxNet`` of the PyTorch port vs the JAX package, fp32
on the CPU at 32², weights drawn with numpy and carried across with
``convert``:

- the forward with and without the seg decoder: every output allclose
  (rtol 1e-5 / atol 1e-6), at 32² and, for the seg net, at 64²;
- ``aux_loss_fn`` and ``aux_seg_loss_fn``: loss and every metric at rtol
  1e-5 (accuracy exact), gradients rtol 1e-4 / atol 1e-6;
- ``mean_iou`` on fp32 logits, classes absent from the batch included:
  rtol 1e-6;
- ``DeviceDataset(aux=True)`` batches and ``AuxSegDataset`` batches (seg
  labels, speed-dropout masks) bit for bit;
- ``evaluate_policy`` of an ``AuxNet`` policy, a 3-env fleet for 8 steps
  through the extras path from one converted carry: actions and flags
  equal, floats at rtol 1e-5 / atol 1e-4, frames within the fast raster's
  tolerance (JAX's kernel B in interpret mode), the driving metrics at
  rtol 1e-4."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import carla_imitation_learning_tpu.ops.raster_fast as j_raster_fast
from carla_imitation_learning_tpu.data import pipeline as j_pipe
from carla_imitation_learning_tpu.models import AuxNet as JAux
from carla_imitation_learning_tpu.render.pipeline import RenderConfig as JRender
from carla_imitation_learning_tpu.sim import SimParams as JParams
from carla_imitation_learning_tpu.sim import make_town as j_make_town
from carla_imitation_learning_tpu.training import closed_loop as j_loop
from carla_imitation_learning_tpu.training import losses as j_losses
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch.data import pipeline as p_pipe
from carla_imitation_learning_tpu_torch.models import AuxNet
from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
from carla_imitation_learning_tpu_torch.sim.world import SimParams
from carla_imitation_learning_tpu_torch.training import closed_loop as p_loop
from carla_imitation_learning_tpu_torch.training import losses
from test_torch_rollout import _frames_close

HW, BATCH, SEG = 32, 6, 8


def numpy_params(model, example, seed: int = 0):
    """Flax params of ``model`` drawn with numpy: kernels normal with std
    sqrt(1 / fan_in) (fan-in over all but the last axis), biases normal
    with std 0.1."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *example)["params"]
    rng = np.random.default_rng(seed)

    def draw(path, s):
        scale = 0.1 if path[-1].key == "bias" else 1 / np.sqrt(np.prod(s.shape[:-1]))
        return jnp.asarray((rng.normal(size=s.shape) * scale).astype(np.float32))

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _pair(hw=HW, seg=SEG, seed=0):
    jmodel = JAux(image_hw=hw, seg_classes=seg, dtype=jnp.float32)
    params = numpy_params(jmodel, (jmodel.example_input(1),), seed)
    model = convert.model_for_params(params, torch.float32)
    model.load_state_dict(convert.aux_state_dict(params))
    return jmodel, params, model


def _inputs(hw=HW, seed=1, n=BATCH):
    rng = np.random.default_rng(seed)
    frames = rng.random((n, hw, hw, 4), np.float32)
    sensor = rng.normal(size=(n, 3)).astype(np.float32)
    y = np.stack([rng.integers(0, 2, n), rng.integers(0, 9, n)], 1).astype(np.int32)
    seg_y = rng.integers(0, SEG, (n, hw, hw)).astype(np.int32)
    seg_y[:, :, :4] = 7                   # one class dominates a stripe
    seg_y[seg_y == 5] = 4                 # class 5 absent from the batch
    return frames, sensor, y, seg_y


@pytest.mark.parametrize("hw,seg", [(32, 0), (32, SEG), (64, SEG)])
def test_forward_matches(hw, seg):
    jmodel, params, model = _pair(hw, seg)
    assert isinstance(model, AuxNet) and (model.seg is None) == (seg == 0)
    frames, sensor, _, _ = _inputs(hw)
    want = jmodel.apply({"params": params}, (jnp.asarray(frames), jnp.asarray(sensor)))
    with torch.no_grad():
        got = model(torch.from_numpy(frames), torch.from_numpy(sensor))
    assert len(got) == len(want) == (4 if seg else 3)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def _jax_loss_and_grads(loss_j, jmodel, params, batch):
    def wrapped(p):
        return loss_j(p, jmodel.apply, batch)
    return jax.jit(jax.value_and_grad(wrapped, has_aux=True))(params)


@pytest.mark.parametrize("seg", [0, SEG])
def test_loss_metrics_and_gradients_match(seg):
    jmodel, params, model = _pair(seg=seg)
    frames, sensor, y, seg_y = _inputs()
    if seg:
        weights = (0.3, 0.2, 1.0, 0.5)
        loss_j, loss_p = j_losses.aux_seg_loss_fn(*weights), losses.aux_seg_loss_fn(*weights)
        jb = ((jnp.asarray(frames), jnp.asarray(sensor)), jnp.asarray(y), jnp.asarray(seg_y))
        pb = ((torch.from_numpy(frames), torch.from_numpy(sensor)), torch.from_numpy(y),
              torch.from_numpy(seg_y))
    else:
        weights = (0.3, 0.2, 1.0)
        loss_j, loss_p = j_losses.aux_loss_fn(*weights), losses.aux_loss_fn(*weights)
        jb = ((jnp.asarray(frames), jnp.asarray(sensor)), jnp.asarray(y))
        pb = ((torch.from_numpy(frames), torch.from_numpy(sensor)), torch.from_numpy(y))
    (j_loss, j_m), j_grads = _jax_loss_and_grads(loss_j, jmodel, params, jb)
    loss, metrics = loss_p(model, pb)
    loss.backward()
    assert set(metrics) == set(j_m)
    for k in j_m:
        rtol = 0 if k == "accuracy" else 1e-5
        np.testing.assert_allclose(float(metrics[k]), float(j_m[k]), rtol=rtol, err_msg=k)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-5)
    want = convert.aux_state_dict(j_grads)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_mean_iou_matches():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(3, 16, 16, SEG)).astype(np.float32)
    logits[..., 6] = -10.0               # class 6 never predicted
    for labels in (rng.integers(0, SEG, (3, 16, 16)), np.full((3, 16, 16), 2),
                   np.argmax(logits, -1)):
        labels = labels.astype(np.int32)
        labels[labels == 6] = 1           # ... and never labelled: union 0
        want = float(j_losses.mean_iou(jnp.asarray(logits), jnp.asarray(labels)))
        got = losses.mean_iou(torch.from_numpy(logits), torch.from_numpy(labels))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6)
    assert float(losses.mean_iou(torch.from_numpy(logits),
                                 torch.from_numpy(np.argmax(logits, -1)))) == 1.0


def _stores(n=90, seed=0):
    """A JAX store with episode starts and sensors away from zero, and the
    port's store of the same arrays."""
    j = j_pipe.FrameStore.synthetic(n=n, height=HW, width=HW, seed=seed)
    j.sensors = np.random.default_rng(seed).uniform(0.5, 5.0, (n, 3)).astype(np.float32)
    starts = np.zeros(n, bool)
    starts[[0, 31, 60]] = True
    j.starts = starts
    p = p_pipe.FrameStore(frames=j.frames, actions=j.actions, traffic=j.traffic,
                          sensors=j.sensors, starts=starts)
    return j, p


def test_aux_batches_match():
    j, p = _stores()
    jd = j_pipe.DeviceDataset(j, 8, frame_skip=4, shuffle=True, seed=3, aux=True)
    pd = p_pipe.DeviceDataset(p, 8, frame_skip=4, shuffle=True, seed=3, aux=True, device="cpu")
    assert len(jd) == len(pd) > 3
    for ((jx, js), jy), ((px, ps), py) in zip(jd, pd):
        np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
        assert py.dtype == torch.int32
        np.testing.assert_array_equal(py.numpy(), np.asarray(jy))
    idx = np.arange(5)
    (jx, _), jy = jd.pure_batch(jnp.asarray(idx))
    (px, _), py = pd.pure_batch(torch.from_numpy(idx))
    np.testing.assert_array_equal(py.numpy(), np.asarray(jy))


@pytest.mark.parametrize("dropout", [0.0, 0.4])
def test_aux_seg_batches_match(dropout):
    j, p = _stores()
    sem = np.random.default_rng(5).integers(0, SEG, (len(j), HW, HW)).astype(np.uint8)
    jd = j_pipe.AuxSegDataset(j_pipe.DeviceDataset(j, 8, frame_skip=4, shuffle=True, seed=1,
                                                   aux=True), sem, speed_dropout=dropout,
                              seed=2)
    pd = p_pipe.AuxSegDataset(p_pipe.DeviceDataset(p, 8, frame_skip=4, shuffle=True, seed=1,
                                                   aux=True, device="cpu"), sem,
                              speed_dropout=dropout, seed=2)
    n = 0
    for epoch in range(2):
        for ((jx, js), jy, jseg), ((px, ps), py, pseg) in zip(jd, pd):
            np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
            np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
            np.testing.assert_array_equal(py.numpy(), np.asarray(jy))
            assert pseg.dtype == torch.int32
            np.testing.assert_array_equal(pseg.numpy(), np.asarray(jseg))
            n += int((ps[:, 1:] == 0).all(-1).sum())
    assert (n > 0) == (dropout > 0)
    with pytest.raises(ValueError, match="aux=True"):
        p_pipe.AuxSegDataset(p_pipe.DeviceDataset(p, 8, device="cpu"), sem)


def _capturing(roll, out: dict):
    def wrapped(carry, n_steps, *a):
        carry, traj = roll(carry, n_steps, *a)
        out["traj"] = traj
        return carry, traj
    return wrapped


def test_aux_policy_evaluate_matches():
    """``evaluate_policy`` of a 3-env fleet for 8 steps on a tiny town, the
    fp32 AuxNet driving on its frames and the rollout's sensor vector,
    both packages started from one converted carry (``make_rollout``
    patched to hand it out)."""
    town = j_make_town(blocks=2, n_buildings=6, n_lights=2)
    jp, pp = JParams(n_agents=3), SimParams(n_agents=3)
    jmodel, params, model = _pair(seg=0, seed=7)
    j_cap, p_cap = {}, {}
    orig = j_raster_fast.rasterize_luma_fast
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_raster_fast, "rasterize_luma_fast", functools.partial(orig, interpret=True))
        init_fn, j_roll = j_loop.make_rollout(jp, town, JRender(HW, HW, max_triangles=256,
                                                                backend="pallas"),
                                              jmodel.as_policy_fn(params))
        carry = init_fn(jax.random.PRNGKey(3), 3)
        mp.setattr(j_loop, "make_rollout",
                   lambda *a, **k: (lambda rng, n: carry, _capturing(j_roll, j_cap)))
        want = j_loop.evaluate_policy(jp, town, None, None, jax.random.PRNGKey(0), n_envs=3,
                                      n_steps=8)
    _, p_roll = p_loop.make_rollout(pp, convert.town_from_jax(town),
                                    RenderConfig(HW, HW, max_triangles=256),
                                    model.as_policy_fn(),
                                    spawn_pool=convert.spawn_pool_from_jax(
                                        j_loop.rollout_spawn_pool(jp, town)), device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(p_loop, "make_rollout", lambda *a, **k: (
            lambda gen, n: convert.carry_from_jax(carry), _capturing(p_roll, p_cap)))
        got = p_loop.evaluate_policy(pp, None, None, None, torch.Generator(), n_envs=3,
                                     n_steps=8, device="cpu")
    j_traj, p_traj = j_cap["traj"], p_cap["traj"]
    for key in ("action", "expert_action", "done", "collision", "offroad", "traffic"):
        np.testing.assert_array_equal(p_traj[key].numpy(),
                                      np.asarray(j_traj[key]).astype(p_traj[key].numpy().dtype),
                                      err_msg=key)
    for key in ("speed", "sensor", "steer", "throttle", "brake"):
        np.testing.assert_allclose(p_traj[key].numpy(), np.asarray(j_traj[key]), rtol=1e-5,
                                   atol=1e-4, err_msg=key)
    for t in range(8):
        _frames_close(p_traj["gray"][t].numpy(), np.asarray(j_traj["gray"][t]), f"frame {t}")
    assert set(got) == set(want)
    for k, v in want.items():
        if v is None:
            assert got[k] is None, k
        else:
            np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4, atol=1e-6, err_msg=k)
