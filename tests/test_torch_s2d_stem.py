"""The space-to-depth stem of the PyTorch port's ``models/cnn.py`` against
the JAX package's, fp32 on the CPU, weights carried across with ``convert``:

- the folded input and ``s2d_stem_kernel`` equal JAX's exactly (and the
  kernel's inverse gives the standard weight back);
- ``PolicyCNN(s2d_stem=True)`` and ``ContinuousPolicyCNN(s2d_stem=True)``
  with converted weights equal JAX's within 1e-5, and the port's s2d stem
  with ``convert_params_to_s2d`` weights equals its standard stem within
  1e-5;
- the tiny-input fallback: on a map smaller than the k7 kernel the JAX
  package builds the standard stem, and the port's s2d trunk runs the
  standard SAME conv with its weight unfolded;
- ``convert`` tells the s2d tree by its first kernel's input channels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_imitation_learning_tpu.models import cnn as j_cnn
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch.models import cnn

ATOL = 1e-5


def _x(shape, seed):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 32, 35, 4), (1, 128, 128, 4), (3, 7, 9, 8)])
def test_folded_input_and_kernel_equal_jax(shape):
    x = _x(shape, 0)
    want = np.asarray(j_cnn._space_to_depth_stem_input(jnp.asarray(x)))
    got = cnn.space_to_depth_stem_input(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got.shape[-1] == 9 * shape[-1]
    np.testing.assert_array_equal(got, want)
    w7 = np.random.default_rng(1).normal(size=(7, 7, shape[-1], 16)).astype(np.float32)
    want_k = np.asarray(j_cnn.s2d_stem_kernel(jnp.asarray(w7)))          # (3, 3, 9C, O)
    w7_t = torch.from_numpy(np.ascontiguousarray(np.transpose(w7, (3, 2, 0, 1))))
    got_k = cnn.s2d_stem_kernel(w7_t)
    np.testing.assert_array_equal(got_k.numpy(), np.transpose(want_k, (3, 2, 0, 1)))
    np.testing.assert_array_equal(cnn.s2d_stem_kernel_inverse(got_k).numpy(), w7_t.numpy())


def _jax_params(model, hw, seed):
    return model.init(jax.random.PRNGKey(seed), jnp.zeros((1, hw, hw, 4)))["params"]


@pytest.mark.parametrize("family", ["discrete", "continuous"])
def test_s2d_policy_matches_jax_and_standard_stem(family):
    hw = 64
    j_cls = j_cnn.PolicyCNN if family == "discrete" else j_cnn.ContinuousPolicyCNN
    p_cls = cnn.PolicyCNN if family == "discrete" else cnn.ContinuousPolicyCNN
    std_params = _jax_params(j_cls(dtype=jnp.float32), hw, 3)
    s2d_params = j_cnn.convert_params_to_s2d(std_params)
    x = _x((3, hw, hw, 4), 4)
    want = np.asarray(j_cls(dtype=jnp.float32, s2d_stem=True).apply(
        {"params": s2d_params}, jnp.asarray(x)))
    model = convert.model_for_params(s2d_params, torch.float32,
                                     continuous=family == "continuous")
    assert isinstance(model, p_cls) and model.trunk.s2d_stem
    assert tuple(model.trunk.convs[0].weight.shape) == (16, 36, 3, 3)
    model.load_state_dict(convert.params_state_dict(s2d_params))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        standard = p_cls(dtype=torch.float32)
        standard.load_state_dict(convert.policy_state_dict(std_params))
        folded = p_cls(dtype=torch.float32, s2d_stem=True)
        folded.load_state_dict(cnn.convert_params_to_s2d(standard.state_dict()))
        std_out = standard(torch.from_numpy(x)).numpy()
        fold_out = folded(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=ATOL)
    np.testing.assert_allclose(fold_out, std_out, rtol=1e-5, atol=ATOL)
    # the state dict keeps the standard names
    assert list(folded.state_dict()) == list(standard.state_dict())


def test_tiny_input_fallback():
    """At 5×5 the JAX package's s2d PolicyCNN is the standard one (a 7×7
    kernel under SAME padding); ``convert`` builds the standard port model
    for its tree, and the port's s2d trunk, given the folded weight, falls
    back to the same function."""
    x = _x((2, 5, 5, 4), 6)
    jm = j_cnn.PolicyCNN(dtype=jnp.float32, s2d_stem=True)
    params = _jax_params(jm, 5, 7)
    assert np.asarray(params["ConvTrunk_0"]["Conv_0"]["kernel"]).shape == (7, 7, 4, 16)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    model = convert.model_for_params(params, torch.float32)
    assert not model.trunk.s2d_stem
    model.load_state_dict(convert.params_state_dict(params))
    folded = cnn.PolicyCNN(dtype=torch.float32, s2d_stem=True)
    folded.load_state_dict(cnn.convert_params_to_s2d(model.state_dict()))
    with torch.no_grad():
        np.testing.assert_allclose(model(torch.from_numpy(x)).numpy(), want, rtol=1e-5,
                                   atol=ATOL)
        np.testing.assert_allclose(folded(torch.from_numpy(x)).numpy(), want, rtol=1e-5,
                                   atol=ATOL)
