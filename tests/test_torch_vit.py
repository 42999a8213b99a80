"""The ViT policy of the PyTorch port vs the JAX package on the CPU, dim 32,
depth 2, heads 2, patch 8, weights drawn with numpy (LayerNorm scales and
position embeddings included) and carried across with ``convert``:

- fp32 logits rtol 1e-5 / atol 1e-5 at 64² on its own 8 × 8 grid, at 40²
  (zero-padded to 48², the valid-fraction pool), at 64² and 40² with a
  16² grid resized down to 8² and 5² (antialiased bilinear, as
  ``jax.image.resize``), and at 96² with the 8² grid resized up to 12²;
- the BC loss and its gradients (rtol 1e-5; rtol 1e-4 / atol 1e-6)
  through attention, the GELU and both LayerNorms;
- bf16 logits within 5e-2, as the bf16 ``PolicyCNN`` test holds them;
- ``convert.model_for_params`` reads the architecture back and
  ``flax_init_`` draws the position embeddings with std 0.02."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_imitation_learning_tpu.models import ViTPolicy as JViT
from carla_imitation_learning_tpu.training import losses as j_losses
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch.models import ViTPolicy
from carla_imitation_learning_tpu_torch.training import losses, steps

ARCH = dict(obs_size=4, patch=8, dim=32, depth=2, heads=2)


def numpy_params(model, example, seed: int):
    """Flax params drawn with numpy: kernels with std sqrt(1 / fan_in) over
    all but the last axis (the attention kernels over their flattened
    input), biases and LayerNorm offsets std 0.1, LayerNorm scales
    1 ± 0.1, the position embeddings std 0.5 so that their resize shows."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), example)["params"]
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "pos_emb":
            a = 0.5 * rng.normal(size=s.shape)
        elif name == "scale":
            a = 1.0 + 0.1 * rng.normal(size=s.shape)
        elif name == "bias":
            a = 0.1 * rng.normal(size=s.shape)
        else:
            parent = path[-2].key
            fan_in = (np.prod(s.shape[:2]) if parent == "out" else
                      s.shape[0] if parent in ("query", "key", "value") else
                      np.prod(s.shape[:-1]))
            a = rng.normal(size=s.shape) / np.sqrt(fan_in)
        return jnp.asarray(a.astype(np.float32))

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _pair(pos_grid: int, jdtype=jnp.float32, dtype=torch.float32, seed=0):
    jm = JViT(**ARCH, pos_grid=pos_grid, dtype=jdtype)
    params = numpy_params(jm, jm.example_input(1, 64, 64), seed)
    model = convert.model_for_params(params, dtype)
    model.load_state_dict(convert.params_state_dict(params))
    return jm, params, model


def _obs(hw: int, seed: int = 1, b: int = 3):
    return np.random.default_rng(seed).random((b, hw, hw, 4), np.float32)


@pytest.mark.parametrize("hw,pos_grid", [(64, 8), (40, 8), (64, 16), (40, 16), (96, 8)],
                         ids=["own_grid", "padded", "down_8", "padded_down_5", "up_12"])
def test_forward_matches(hw, pos_grid):
    jm, params, model = _pair(pos_grid)
    assert isinstance(model, ViTPolicy) and len(model.blocks) == 2
    assert (model.patch, model.dim, model.pos_grid, model.blocks[0].heads) == (8, 32, pos_grid, 2)
    x = _obs(hw)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (3, 9)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_loss_and_gradients_match():
    jm, params, model = _pair(16, seed=2)
    x = _obs(40, seed=3)
    y = np.random.default_rng(4).integers(0, 9, 3).astype(np.int32)
    (_, j_m), j_grads = jax.value_and_grad(
        lambda p: j_losses.bc_loss_fn(p, jm.apply, (jnp.asarray(x), jnp.asarray(y))),
        has_aux=True)(params)
    loss, metrics = losses.bc_loss_fn(model, (torch.from_numpy(x), torch.from_numpy(y)))
    loss.backward()
    for k in j_m:
        np.testing.assert_allclose(float(metrics[k]), float(j_m[k]), rtol=1e-5, err_msg=k)
    want = convert.vit_state_dict(j_grads)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_bf16_forward_matches():
    jm, params, model = _pair(16, jnp.bfloat16, torch.bfloat16, seed=5)
    x = _obs(64, seed=6)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-2)


def test_flax_init_draws_position_embeddings():
    model = steps.flax_init_(ViTPolicy(**ARCH),
                             torch.Generator().manual_seed(0))
    pos = model.pos_emb.detach()
    assert abs(float(pos.std()) - 0.02) < 0.002
    assert float(model.blocks[0].ln1.weight.detach().min()) == 1.0
    w = model.blocks[0].query.weight.detach()
    assert abs(float(w.std()) * np.sqrt(32) - 1.0) < 0.15
