"""The dual-stream raw+segment policy and the on-the-fly augmentation of
the PyTorch port vs the JAX package, fp32 on the CPU:

- ``DualStreamCNN`` at 64² (weights drawn with numpy, carried across
  with ``convert``): logits rtol 1e-5 / atol 1e-6; ``dual_stream_loss_fn``
  loss and accuracy, gradients rtol 1e-4 / atol 1e-6; the port's
  ``ConvTrunk`` keeps ConvNet1's state-dict names at its default width;
- ``paired_sequential_iterator`` on a synthetic log with a semantic
  camera: every split's ``(x, x_seg, y)`` batches bit for bit;
  ``rebase_stream``'s selection and its refusal of a missing frame;
- every augment op fed the JAX package's draws (flip with its relabel,
  crop offsets, brightness/contrast, noise): flip and labels exact, the
  others rtol 1e-5 / atol 1e-6 (the bilinear upsample: JAX renormalises
  its taps at the borders, torch clamps the coordinate; both give the edge
  pixel); ``augment_batch`` of JAX's key, and ``bc_augmented_loss_fn``'s
  loss and gradients with those draws;
- a whole ``bc_raw_segment`` run on a synthetic 32² log with a semantic
  camera, the port's against the JAX package's from one initial state
  carried across as a checkpoint: per-epoch and test metrics at rtol 1e-4
  (as ``tests/test_torch_aux_experiments.py`` holds ``bc_aux``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_imitation_learning_tpu import compose as j_compose
from carla_imitation_learning_tpu import experiments as j_ex
from carla_imitation_learning_tpu.data import pipeline as j_pipe
from carla_imitation_learning_tpu.models import DualStreamCNN as JDual
from carla_imitation_learning_tpu.models import PolicyCNN as JPolicy
from carla_imitation_learning_tpu.ops import augment as j_aug
from carla_imitation_learning_tpu.training import losses as j_losses
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch.config import compose as p_compose
from carla_imitation_learning_tpu_torch.data import frame_log as p_fl
from carla_imitation_learning_tpu_torch.data import pipeline as p_pipe
from carla_imitation_learning_tpu_torch.models import DualStreamCNN, PolicyCNN
from carla_imitation_learning_tpu_torch.ops import augment as p_aug
from carla_imitation_learning_tpu_torch.training import losses
from test_torch_aux import numpy_params
from test_torch_aux_experiments import _run_both, _same_history, template_train_state

HW = 64


def test_dual_stream_forward_loss_and_gradients_match():
    jmodel = JDual(dtype=jnp.float32)
    params = numpy_params(jmodel, jmodel.example_input(1, HW, HW), seed=3)
    model = convert.model_for_params(params, torch.float32)
    assert isinstance(model, DualStreamCNN)
    model.load_state_dict(convert.dual_stream_state_dict(params))
    rng = np.random.default_rng(0)
    x, xs = rng.random((2, 5, HW, HW, 4), np.float32)
    y = rng.integers(0, 9, 5).astype(np.int32)
    want = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(xs))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(xs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    (j_loss, j_m), j_grads = jax.jit(jax.value_and_grad(
        lambda p: j_losses.dual_stream_loss_fn(p, jmodel.apply, (x, xs, y)),
        has_aux=True))(params)
    loss, metrics = losses.dual_stream_loss_fn(
        model, (torch.from_numpy(x), torch.from_numpy(xs), torch.from_numpy(y)))
    loss.backward()
    np.testing.assert_allclose(float(metrics["loss"]), float(j_loss), rtol=1e-5)
    assert float(metrics["accuracy"]) == float(j_m["accuracy"])
    want_g = convert.dual_stream_state_dict(j_grads)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    assert set(PolicyCNN().state_dict()) == set(
        convert.policy_state_dict(numpy_params(JPolicy(), (JPolicy().example_input(1),))))


def _overrides(root, *extra):
    return ["model=imitation", f"data_dir={root}", f"image_height={HW}", f"image_width={HW}",
            "BATCH_SIZE=8", *extra]


def test_paired_batches_match(tmp_path):
    p_fl.write_synthetic_log(tmp_path, log="Log1", cameras=("camera", "semantic"), n_frames=60,
                             height=HW, width=HW, seed=5)
    p_fl.split_frames(tmp_path / "raw" / "Log1", tmp_path / "processed" / "Log1",
                      ratio=(0.8, 0.1, 0.1), shuffle=False)
    jl = j_pipe.paired_sequential_iterator(j_compose("config", overrides=_overrides(tmp_path)))
    pl = p_pipe.paired_sequential_iterator(p_compose("config", overrides=_overrides(tmp_path)),
                                           device="cpu")
    for name in ("train_dataloader", "val_dataloader", "test_dataloader"):
        assert len(pl[name]) == len(jl[name]) > 0
        for jb, pb in zip(jl[name], pl[name]):
            for j, p in zip(jb, pb):
                np.testing.assert_array_equal(p.numpy(), np.asarray(j), err_msg=name)
        # the semantic stream really is the other camera's, frame for frame
        x, xs, _ = next(iter(pl[name]))
        assert not torch.equal(x, xs)


def test_rebase_stream():
    frames = np.arange(10)[:, None, None].repeat(2, 1).repeat(2, 2).astype(np.uint8)
    ids = np.arange(3, 13)
    for target in (np.array([5, 6, 12]), None):
        np.testing.assert_array_equal(p_pipe.rebase_stream(frames, ids, target),
                                      j_pipe.rebase_stream(frames, ids, target))
    with pytest.raises(ValueError, match="missing"):
        p_pipe.rebase_stream(frames, ids, np.array([2, 4]))


def _batch(n=4, hw=40, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n, hw, hw, 4), np.float32),
            rng.integers(0, 9, n).astype(np.int32))


def jax_draws(key, x: np.ndarray) -> p_aug.AugmentDraws:
    """The draws ``augment_batch(key, ...)`` of the JAX package makes for a
    batch shaped like ``x``, as the port's ``AugmentDraws``."""
    B, H, W, _ = x.shape
    k1, k2, k3, k4 = jax.random.split(key, 4)
    _, ky, kx = jax.random.split(k2, 3)
    ch, cw = int(H * 0.85), int(W * 0.85)
    kb, kc = jax.random.split(k3)

    def t(a):
        return torch.from_numpy(np.array(a))

    return p_aug.AugmentDraws(
        flip=t(jax.random.bernoulli(k1, 0.5, (B,))),
        y0=t(jax.random.randint(ky, (B,), 0, H - ch + 1)),
        x0=t(jax.random.randint(kx, (B,), 0, W - cw + 1)),
        b=t(jax.random.uniform(kb, (B, 1, 1, 1), minval=-0.15, maxval=0.15)),
        c=t(jax.random.uniform(kc, (B, 1, 1, 1), minval=0.85, maxval=1.15)),
        eps=t(jax.random.normal(k4, x.shape, jnp.float32)))


def test_augment_ops_match_jax_draws():
    x, y = _batch()
    key = jax.random.PRNGKey(7)
    d = jax_draws(key, x)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    X, Y = torch.from_numpy(x), torch.from_numpy(y)
    jx, jy = j_aug.random_hflip_with_labels(k1, jnp.asarray(x), jnp.asarray(y))
    px, py = p_aug.hflip_with_labels(X, Y, d.flip)
    np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(py.numpy(), np.asarray(jy))
    assert d.flip.any() and not d.flip.all()
    relabel = {0: 2, 1: 1, 2: 0, 3: 5, 4: 4, 5: 3, 6: 8, 7: 7, 8: 6}
    flipped = p_aug.hflip_with_labels(X, torch.tensor([0, 3, 7, 8]),
                                      torch.ones(4, dtype=torch.bool))[1]
    assert flipped.tolist() == [relabel[a] for a in (0, 3, 7, 8)]
    for name, jout, pout in (
            ("crop", j_aug.random_crop_resize(k2, jnp.asarray(x)),
             p_aug.crop_resize(X, d.y0, d.x0)),
            ("jitter", j_aug.random_brightness_contrast(k3, jnp.asarray(x)),
             p_aug.brightness_contrast(X, d.b, d.c)),
            ("noise", j_aug.random_noise(k4, jnp.asarray(x)), p_aug.add_noise(X, d.eps))):
        np.testing.assert_allclose(pout.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    jx, jy = j_aug.augment_batch(key, jnp.asarray(x), jnp.asarray(y))
    px, py = p_aug.augment_with(d, X, Y)
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(py.numpy(), np.asarray(jy))


def test_augment_generator_forms():
    """The generator forms keep shapes, the [0, 1] range and the label
    alphabet, and repeat under one seed."""
    x, y = _batch(n=16)
    X, Y = torch.from_numpy(x), torch.from_numpy(y)
    outs = [p_aug.augment_batch(torch.Generator().manual_seed(3), X, Y) for _ in range(2)]
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    ax, ay = outs[0]
    assert ax.shape == X.shape and 0.0 <= float(ax.min()) and float(ax.max()) <= 1.0
    assert set(ay.tolist()) <= set(range(9))
    g = torch.Generator().manual_seed(0)
    for out in (p_aug.random_crop_resize(g, X), p_aug.random_noise(g, X),
                p_aug.random_brightness_contrast(g, X),
                p_aug.random_hflip_with_labels(g, X, Y)[0]):
        assert out.shape == X.shape


def test_bc_augmented_loss_matches(monkeypatch):
    x, y = _batch(n=4, hw=32, seed=2)
    jmodel = JPolicy(dtype=jnp.float32)
    params = numpy_params(jmodel, (jmodel.example_input(1, 32, 32),), seed=4)
    model = PolicyCNN(dtype=torch.float32)
    model.load_state_dict(convert.policy_state_dict(params))
    key = jax.random.PRNGKey(12)
    (j_loss, j_m), j_grads = jax.jit(jax.value_and_grad(
        lambda p: j_losses.bc_augmented_loss_fn()(p, jmodel.apply, (x, y), key),
        has_aux=True))(params)
    d = jax_draws(key, x)
    monkeypatch.setattr(p_aug, "augment_draws", lambda gen, xx, *a: d)
    loss, metrics = losses.bc_augmented_loss_fn()(
        model, (torch.from_numpy(x), torch.from_numpy(y)), torch.Generator())
    loss.backward()
    np.testing.assert_allclose(float(metrics["loss"]), float(j_loss), rtol=1e-5)
    assert float(metrics["accuracy"]) == float(j_m["accuracy"])
    want = convert.policy_state_dict(j_grads)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    # evaluation passes no generator: no augmentation
    j_eval = j_losses.bc_augmented_loss_fn()(params, jmodel.apply, (x, y), None)[1]
    with torch.no_grad():
        p_eval = losses.bc_augmented_loss_fn()(model, (torch.from_numpy(x),
                                                       torch.from_numpy(y)))[1]
    np.testing.assert_allclose(float(p_eval["loss"]), float(j_eval["loss"]), rtol=1e-5)


def test_bc_raw_segment_run_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(j_ex, "create_train_state", template_train_state)
    jres, pres = _run_both(
        tmp_path, "bc_raw_segment", "dual",
        lambda: JDual(dtype=jnp.float32),
        lambda: JDual().example_input(1, 32, 32),
        lambda cfg: j_pipe.paired_sequential_iterator(cfg))
    _same_history(pres, jres)
