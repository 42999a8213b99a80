"""SSIM, MS-SSIM and the latent world model of the PyTorch port vs the JAX
package, fp32 on the CPU, weights drawn with numpy and carried across with
``convert``:

- ``ssim`` (both of its means) and ``ms_ssim`` at 32² (2 levels) and 64²
  (3 levels), rtol 1e-5;
- ``FrameEncoder`` and ``FrameDecoder`` alone, and ``LatentWorldModel``'s
  forward (recon, z, z_pred, frames_pred) for the LSTM and the GRU, with
  discrete and continuous actions, rtol 1e-5 / atol 1e-6;
- ``imagine`` and ``imagine_frames`` over a 5-step plan;
- ``world_model_loss_fn`` under MSE and MS-SSIM: loss and metrics rtol
  1e-5, gradients rtol 1e-4 / atol 1e-6 (under MS-SSIM against JAX's
  gradients in float64, as the test says why, and the port's float64
  gradients against those at rtol 1e-6);
- ``convert.model_for_params`` reads each tree's architecture back."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_imitation_learning_tpu.models.world_model import (
    FrameDecoder as JDecoder, FrameEncoder as JEncoder, LatentWorldModel as JWM,
)
from carla_imitation_learning_tpu.ops import ssim as j_ssim
from carla_imitation_learning_tpu.training import losses as j_losses
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch.models import FrameDecoder, FrameEncoder, LatentWorldModel
from carla_imitation_learning_tpu_torch.ops import ssim as p_ssim
from carla_imitation_learning_tpu_torch.training import losses
from test_torch_aux import numpy_params

Z, HID, HW, T = 16, 32, 32, 4
FWD = dict(rtol=1e-5, atol=1e-6)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or FWD))


@pytest.mark.parametrize("hw", [32, 64])
def test_ssim_and_ms_ssim_match(hw):
    rng = np.random.default_rng(hw)
    x = rng.random((3, hw, hw, 1), np.float32)
    y = np.clip(x + 0.1 * rng.normal(size=x.shape), 0, 1).astype(np.float32)
    for got, want in zip(p_ssim.ssim(_t(x), _t(y)), j_ssim.ssim(jnp.asarray(x), jnp.asarray(y))):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(p_ssim.ms_ssim(_t(x), _t(y))),
                               float(j_ssim.ms_ssim(jnp.asarray(x), jnp.asarray(y))), rtol=1e-5)
    np.testing.assert_allclose(float(p_ssim.ms_ssim_loss(_t(x), _t(x))), 0.0, atol=1e-6)
    odd = rng.random((2, hw + 3, hw + 1, 1), np.float32)
    np.testing.assert_array_equal(p_ssim._downsample2(_t(odd)).numpy(),
                                  np.asarray(j_ssim._downsample2(jnp.asarray(odd))))


def test_encoder_and_decoder_match():
    """At 48 × 40 (not square, SAME padding at odd sizes on the way down)
    and 48² out."""
    jenc, jdec = JEncoder(z_size=Z, dtype=jnp.float32), JDecoder(48, 48, dtype=jnp.float32)
    x = np.random.default_rng(1).random((2, 48, 40, 1), np.float32)
    z = np.random.default_rng(3).normal(size=(2, Z)).astype(np.float32)
    pe = numpy_params(jenc, (jnp.asarray(x),), seed=1)
    pd = numpy_params(jdec, (jnp.asarray(z),), seed=2)
    enc = FrameEncoder(1, 48, 40, Z, dtype=torch.float32)
    enc.load_state_dict(convert.frame_encoder_state_dict(pe))
    dec = FrameDecoder(48, 48, 1, Z, dtype=torch.float32)
    dec.load_state_dict(convert.frame_decoder_state_dict(pd))
    with torch.no_grad():
        _close(enc(_t(x)), jenc.apply({"params": pe}, jnp.asarray(x)))
        got = dec(_t(z))
    assert got.shape == (2, 48, 48, 1)
    _close(got, jdec.apply({"params": pd}, jnp.asarray(z)))


def _pair(rnn: str, space: str, seed: int = 0):
    jm = JWM(z_size=Z, rnn=rnn, height=HW, width=HW, hidden_size=HID, dtype=jnp.float32,
             action_space=space)
    params = numpy_params(jm, jm.example_input(1, T), seed)
    model = convert.model_for_params(params, torch.float32)
    model.load_state_dict(convert.params_state_dict(params))
    return jm, params, model


def _inputs(space: str, seed: int = 5, b: int = 2, t: int = T):
    rng = np.random.default_rng(seed)
    frames = rng.random((b, t, HW, HW, 1), np.float32)
    actions = (rng.integers(0, 9, (b, t)).astype(np.int32) if space == "discrete"
               else rng.uniform(-1, 1, (b, t, 2)).astype(np.float32))
    return frames, actions


CASES = [("lstm", "discrete"), ("gru", "discrete"), ("lstm", "continuous"),
         ("gru", "continuous")]


@pytest.mark.parametrize("rnn,space", CASES)
def test_world_model_forward_matches(rnn, space):
    jm, params, model = _pair(rnn, space)
    assert isinstance(model, LatentWorldModel)
    assert (model.rnn, model.action_space, model.hidden_size, model.height) == \
        (rnn, space, HID, HW)
    frames, actions = _inputs(space)
    want = jm.apply({"params": params}, jnp.asarray(frames), jnp.asarray(actions))
    with torch.no_grad():
        got = model(_t(frames), _t(actions))
    for name, g, w in zip(("recon", "z", "z_pred", "frames_pred"), got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **FWD)


@pytest.mark.parametrize("rnn,space", CASES)
def test_imagine_matches(rnn, space):
    jm, params, model = _pair(rnn, space, seed=3)
    frames, actions = _inputs(space, seed=7, t=5)
    f0 = frames[:, 0]
    want_z = jm.apply({"params": params}, jnp.asarray(f0), method=lambda m, f: m.encoder(f))
    zs_w, frames_w = jm.apply({"params": params}, jnp.asarray(f0), jnp.asarray(actions),
                              method=jm.imagine_frames)
    with torch.no_grad():
        zs, imagined = model.imagine_frames(_t(f0), _t(actions))
        zs_direct = model.imagine(model.encoder(_t(f0)), _t(actions))
    _close(model.encoder(_t(f0)), want_z)
    _close(zs, zs_w)
    _close(zs_direct, zs_w)
    _close(imagined, frames_w)
    assert float(zs.abs().max()) <= 1.0


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64``. The JAX package's
    world model and SSIM name ``jnp.float32`` for their fp32 islands (the
    encoder's Dense, the sigmoid, the one-hot, SSIM's casts); swapped in for
    their module's ``jnp`` under x64, the same code runs in float64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _jax_float64_grads(params, frames, actions, image_loss, monkeypatch):
    """JAX's ``world_model_loss_fn`` gradients with every step in float64:
    x64 on, the params and frames cast up, a float64 ``LatentWorldModel``,
    and ``_Float64Numpy`` for the world model's and SSIM's ``jnp``."""
    from carla_imitation_learning_tpu.models import world_model as j_wm

    f64 = _Float64Numpy()
    with jax.enable_x64(True), monkeypatch.context() as mp:
        mp.setattr(j_wm, "jnp", f64)
        mp.setattr(j_ssim, "jnp", f64)
        jm = JWM(z_size=Z, rnn="lstm", height=HW, width=HW, hidden_size=HID,
                 dtype=jnp.float64)
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)), params)
        loss_j = j_losses.world_model_loss_fn(image_loss=image_loss)
        (_, m64), grads = jax.jit(jax.value_and_grad(
            lambda p: loss_j(p, jm.apply, (jnp.asarray(frames, jnp.float64),
                                           jnp.asarray(actions))), has_aux=True))(p64)
        assert all(g.dtype == jnp.float64 for g in jax.tree_util.tree_leaves(grads))
        return {k: float(v) for k, v in m64.items()}, jax.tree_util.tree_map(np.asarray, grads)


@pytest.mark.parametrize("image_loss", ["mse", "ms_ssim"])
def test_world_model_loss_and_gradients_match(image_loss, monkeypatch):
    """Loss and metrics against JAX's; gradients against JAX's under MSE.
    Under MS-SSIM the gradients are held against JAX's in float64: on the
    untrained decoder's near-flat reconstructions (std 0.003 about 0.48)
    SSIM's variances blur(x²) − blur(x)² cancel to ~3e-5 of their terms,
    and JAX's fp32 blur rounds high on average (+3.4e-8 on blur(x²), the
    port's −2e-10), so JAX's fp32 mean SSIM per level is 7e-5 off float64
    (the port's 2e-6) and its last bias gradient 1.8e-3 (ROADMAP Queue 3).
    The port's own float64 gradients agree with JAX's float64 to rtol
    1e-6 (``convert`` carries them across in fp32)."""
    jm, params, model = _pair("lstm", "discrete", seed=4)
    frames, actions = _inputs("discrete", seed=9)
    loss_j = j_losses.world_model_loss_fn(image_loss=image_loss)
    (j_loss, j_m), j_grads = jax.jit(jax.value_and_grad(
        lambda p: loss_j(p, jm.apply, (jnp.asarray(frames), jnp.asarray(actions))),
        has_aux=True))(params)
    loss_fn = losses.world_model_loss_fn(image_loss=image_loss)
    loss, metrics = loss_fn(model, (_t(frames), _t(actions)))
    loss.backward()
    assert set(metrics) == set(j_m)
    for k in j_m:
        np.testing.assert_allclose(float(metrics[k]), float(j_m[k]), rtol=1e-5, err_msg=k)
    want = convert.world_model_state_dict(j_grads)
    if image_loss == "ms_ssim":
        m64, g64 = _jax_float64_grads(params, frames, actions, image_loss, monkeypatch)
        want = convert.world_model_state_dict(g64)
        ref = convert.model_for_params(params, torch.float64).to(torch.float64)
        ref.load_state_dict(convert.params_state_dict(params))
        loss64, metrics64 = loss_fn(ref, (_t(frames).to(torch.float64), _t(actions)))
        loss64.backward()
        for k in m64:
            np.testing.assert_allclose(float(metrics64[k]), m64[k], rtol=1e-12, err_msg=k)
        for name, p in ref.named_parameters():
            np.testing.assert_allclose(p.grad.to(torch.float32).numpy(), want[name].numpy(),
                                       rtol=1e-6, atol=1e-12, err_msg=f"float64 {name}")
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
