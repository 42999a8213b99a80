"""PyTorch port of ``PolicyCNN`` vs the flax model, with converted weights.

Tolerance: float32 logits allclose with atol 1e-4 (different convolution
algorithms sum in different orders). The default bf16 models round at
other places in the two frameworks, so they are held to the bf16 scale:
atol 5e-2 on logits of order 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_imitation_learning_tpu.models import PolicyCNN as JPolicyCNN
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch.models import PolicyCNN


def _models(hw, jdtype, tdtype, seed=0):
    jmodel = JPolicyCNN(dtype=jdtype)
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, hw, hw, 4)))["params"]
    tmodel = PolicyCNN(dtype=tdtype)
    tmodel.load_state_dict(convert.policy_state_dict(params), strict=True)
    return jmodel, params, tmodel


def _obs(hw, batch=3, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (batch, hw, hw, 4)) / 255.0).astype(np.float32)


@pytest.mark.parametrize("hw", [64, 128])
def test_fp32_logits_match(hw):
    jmodel, params, tmodel = _models(hw, jnp.float32, torch.float32)
    x = _obs(hw)
    want = np.asarray(jmodel.apply({"params": params}, x))
    with torch.no_grad():
        got = tmodel(torch.as_tensor(x))
    assert got.dtype == torch.float32 and got.shape == (3, 9)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_bf16_default_logits_match():
    hw = 128
    jmodel, params, tmodel = _models(hw, jnp.bfloat16, torch.bfloat16, seed=1)
    x = _obs(hw, seed=1)
    want = np.asarray(jmodel.apply({"params": params}, x))
    with torch.no_grad():
        got = tmodel(torch.as_tensor(x))
    assert got.dtype == torch.float32   # float32 logits from bf16 compute
    assert all(p.dtype == torch.float32 for p in tmodel.parameters())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-2)


def test_same_padding_fallback_on_small_maps():
    """At 32² the third and fourth convs see maps smaller than their
    kernels and fall back to SAME padding, as flax does."""
    jmodel, params, tmodel = _models(32, jnp.float32, torch.float32, seed=2)
    x = _obs(32, seed=2)
    want = np.asarray(jmodel.apply({"params": params}, x))
    with torch.no_grad():
        got = tmodel(torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_state_dict_layout():
    _, params, tmodel = _models(64, jnp.float32, torch.float32)
    sd = convert.policy_state_dict(params)
    assert sd["trunk.convs.0.weight"].shape == (16, 4, 7, 7)      # OIHW
    np.testing.assert_array_equal(
        sd["trunk.convs.0.weight"].numpy(),
        np.transpose(np.asarray(params["ConvTrunk_0"]["Conv_0"]["kernel"]), (3, 2, 0, 1)))
    assert sd["head.layers.0.weight"].shape == (64, 128)          # (out, in)
    n_flax = sum(np.asarray(a).size for a in jax.tree_util.tree_leaves(params))
    assert n_flax == sum(p.numel() for p in tmodel.parameters())
