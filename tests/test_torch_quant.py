"""int8 serving (``serving/quant.py``) of the PyTorch port against the JAX
package's.

The JAX package's shipped int8 program pre-bakes its weight codes eagerly
(``quantize_params``) and computes the activation codes under ``jit``; the
JAX side here does the same. Tolerances: codes, scales and single int8
layers on representable values bit for bit; int8 logits of whole models
within 1e-5 of the logits' largest magnitude (the int32 sums are exact;
CIL's float branch products are not); batch invariance exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from carla_imitation_learning_tpu.models import BranchedCILPolicy as JCIL
from carla_imitation_learning_tpu.models import DualStreamCNN as JDual
from carla_imitation_learning_tpu.models import PolicyCNN as JPolicy
from carla_imitation_learning_tpu.models import ViTPolicy as JViT
from carla_imitation_learning_tpu.serving import quant as jquant
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch.models import (
    BranchedCILPolicy, DualStreamCNN, PolicyCNN, ViTPolicy,
)
from carla_imitation_learning_tpu_torch.serving import (
    export_policy, load_policy, make_quantized_policy, quantize_params, quantized_apply,
)
from carla_imitation_learning_tpu_torch.serving import quant

H = W = 32


def _jax_int8(model, params, *inputs):
    """The JAX package's int8 forward as its artifact runs it: weights baked
    eagerly, the forward under jit."""
    qparams = jquant.quantize_params(params)
    return jax.jit(lambda *a: jquant.quantized_apply(model, qparams, *a))(*inputs)


def _frames(b, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, H, W, 4), dtype=np.uint8)


@pytest.mark.parametrize("shape", [(5, 7), (4, 9, 9, 16)])
def test_activation_codes_and_scales_match_jax(shape):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    x[0] = 0.0                                   # the 1e-8 floor
    x[1].flat[:3] = [0.5, -1.5, 2.5]             # ties round to even
    q_j, s_j = jax.jit(jquant._quant_dynamic)(jnp.asarray(x))
    q_t, s_t = quant._quant_dynamic(torch.as_tensor(x))
    assert q_t.dtype == torch.int8
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


@pytest.mark.parametrize("layout", ["conv", "dense"])
def test_weight_codes_and_scales_match_jax(layout):
    """Per-output-channel codes of a kernel baked as ``quantize_params``
    bakes it (eagerly), in torch's (out, ...) layout."""
    rng = np.random.default_rng(2)
    k = (rng.standard_normal((7, 7, 4, 16) if layout == "conv" else (128, 9)) * 0.1)
    k = k.astype(np.float32)
    k[..., 3] = 0.0                              # a dead output channel
    q_j, s_j = jquant._quant_kernel(jnp.asarray(k))
    perm = (3, 2, 0, 1) if layout == "conv" else (1, 0)
    q_t, s_t = quant._quant_kernel(torch.as_tensor(np.transpose(k, perm).copy()))
    np.testing.assert_array_equal(q_t.numpy(), np.transpose(np.asarray(q_j), perm))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


@pytest.mark.parametrize("layer", ["conv", "dense"])
def test_int8_layer_exact_on_representable_values(layer):
    """One conv or dense whose weights and inputs sit on the int8 grid: the
    port's int8 layer equals the JAX package's bit for bit and the float
    layer within the JAX test's bound."""

    class Tiny(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            if layer == "conv":
                return fnn.Conv(4, (3, 3), padding="VALID")(x)
            return fnn.Dense(3)(x.reshape((x.shape[0], -1)))

    m = Tiny()
    params = m.init(jax.random.PRNGKey(0), jnp.zeros((1, 6, 6, 2)))["params"]
    rng = np.random.default_rng(0)

    def grid(p):
        a = rng.integers(-127, 128, p.shape).astype(np.float32)
        if a.ndim >= 2:   # per-output-channel max 127: scale exactly 1
            a[(0,) * (a.ndim - 1) + (slice(None),)] = 127.0
        return jnp.asarray(a)

    params = jax.tree.map(grid, params)
    xa = rng.integers(0, 128, (2, 6, 6, 2)).astype(np.float32)
    xa[:, 0, 0, 0] = 127.0
    want = np.asarray(_jax_int8(m, params, jnp.asarray(xa)))
    leaf = params["Conv_0" if layer == "conv" else "Dense_0"]
    kernel, bias = np.array(leaf["kernel"]), torch.as_tensor(np.array(leaf["bias"]))
    with torch.no_grad():
        if layer == "conv":
            f = torch.nn.Conv2d(2, 4, 3)
            f.weight.copy_(torch.as_tensor(np.transpose(kernel, (3, 2, 0, 1))))
            f.bias.copy_(bias)
            got = quant.Int8Conv2d(f)(torch.as_tensor(xa).permute(0, 3, 1, 2), 1)
            got = got.permute(0, 2, 3, 1).numpy()
        else:
            f = torch.nn.Linear(72, 3)
            f.weight.copy_(torch.as_tensor(kernel.T))
            f.bias.copy_(bias)
            got = quant.Int8Linear(f)(torch.as_tensor(xa).reshape(2, -1)).numpy()
    np.testing.assert_array_equal(got, want)
    exact = np.asarray(m.apply({"params": params}, jnp.asarray(xa)), np.float64)
    np.testing.assert_allclose(got, exact, rtol=1e-6, atol=1e-2)


def test_int8_matmul_pads_exactly_and_takes_only_int8():
    rng = np.random.default_rng(3)
    for m, k, n in ((1, 1, 1), (3, 196, 16), (17, 160, 9), (40, 128, 64)):
        a = torch.as_tensor(rng.integers(-127, 128, (m, k)), dtype=torch.int8)
        b = torch.as_tensor(rng.integers(-127, 128, (n, k)), dtype=torch.int8)
        got = quant.int8_matmul(a, b)
        assert got.dtype == torch.int32 and got.shape == (m, n)
        torch.testing.assert_close(got, a.int() @ b.int().T, rtol=0, atol=0)
    with pytest.raises(TypeError, match="int8"):
        quant.int8_matmul(a.float(), b)


def _policy(dtype_j, dtype_t, seed=7):
    jm = JPolicy(dtype=dtype_j)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, H, W, 4)))["params"]
    tm = PolicyCNN(dtype=dtype_t)
    tm.load_state_dict(convert.policy_state_dict(params))
    return jm, params, tm.eval()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_policy_logits_match_jax(dtype):
    """``make_quantized_policy`` of both packages on the same uint8 frames;
    in bf16 the input is rounded to bf16 at the trunk's entry, the int8
    layers return float32 in both."""
    jm, params, tm = _policy(getattr(jnp, dtype), getattr(torch, dtype))
    x = _frames(33, seed=1)
    want = np.asarray(jax.jit(jquant.make_quantized_policy(jm, params))(x))
    got = make_quantized_policy(tm)(torch.as_tensor(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_quantized_dual_stream_and_cil_logits_match_jax():
    rng = np.random.default_rng(4)
    obs = _frames(9, seed=2).astype(np.float32) / 255.0
    obs_seg = _frames(9, seed=3).astype(np.float32) / 255.0
    jd = JDual(dtype=jnp.float32)
    pd = jd.init(jax.random.PRNGKey(1), jnp.zeros((1, H, W, 4)), jnp.zeros((1, H, W, 4)))["params"]
    td = DualStreamCNN(dtype=torch.float32)
    td.load_state_dict(convert.dual_stream_state_dict(pd))
    want = np.asarray(_jax_int8(jd, pd, obs, obs_seg))
    got = quantized_apply(td, torch.as_tensor(obs), torch.as_tensor(obs_seg)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())

    jc = JCIL(n_commands=6, dtype=jnp.float32)
    pc = jc.init(jax.random.PRNGKey(2), *jc.example_input(1, H, W))["params"]
    tc = BranchedCILPolicy(n_commands=6, dtype=torch.float32)
    tc.load_state_dict(convert.cil_state_dict(pc))
    speed = rng.uniform(0, 12, 9).astype(np.float32)
    cmd = rng.integers(0, 6, 9).astype(np.int32)
    want = np.asarray(_jax_int8(jc, pc, obs, speed, cmd)[0])
    got = quantized_apply(tc, torch.as_tensor(obs), torch.as_tensor(speed),
                          torch.as_tensor(cmd))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_quantize_params_swaps_every_conv_and_linear_only():
    """The int8 copy of a CIL policy: every conv and linear swapped, the
    branch tensors float parameters as they were, the model untouched."""
    tc = BranchedCILPolicy(n_commands=4, dtype=torch.float32)
    q = quantize_params(tc)
    kinds = [type(m).__name__ for m in q.modules()]
    assert kinds.count("Int8Conv2d") == 4 and kinds.count("Int8Linear") == 3
    assert "Conv2d" not in kinds and "Linear" not in kinds
    assert q.branch_w1.dtype == torch.float32 and torch.equal(q.branch_w1, tc.branch_w1)
    assert isinstance(tc.trunk.convs[0], torch.nn.Conv2d)
    assert q.trunk.convs[0].weight_q.dtype == torch.int8


def test_int8_batch_invariance():
    """Per-sample activation scales: a sample's int8 logits do not depend on
    its batchmates or on zero padding rows."""
    _, _, tm = _policy(jnp.float32, torch.float32)
    f = make_quantized_policy(tm)
    x = torch.as_tensor(_frames(6, seed=5))
    full = f(x)
    assert torch.equal(f(x[2:3]), full[2:3])
    padded = f(torch.cat([x, torch.zeros_like(x)]))
    assert torch.equal(padded[:6], full)


def test_int8_artifact_smaller_and_exact(tmp_path):
    _, _, tm = _policy(jnp.float32, torch.float32)
    f = export_policy(tm, tmp_path / "f", height=H, width=W, device="cpu")
    q = export_policy(tm, tmp_path / "q", height=H, width=W, device="cpu", quantize="int8")
    fb, qb = ((p / "policy.pt2").stat().st_size for p in (f, q))
    assert qb < 0.8 * fb, (qb, fb)
    servable = load_policy(q, "cpu")
    assert servable.meta["quantize"] == "int8"
    x = torch.as_tensor(_frames(5, seed=6))
    assert torch.equal(servable.call(x), make_quantized_policy(tm)(x))


def test_vit_int8_raises_where_jax_multiplies_by_codes():
    """The JAX package's int8 ViT bakes its attention kernels to int8 codes
    but never swaps those layers: its logits equal the ViT run with the raw
    codes as attention weights (the other layers int8). The port raises."""
    jm = JViT(patch=8, dim=32, depth=1, heads=2, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 4)))["params"]
    x = _frames(3, seed=7)
    shipped = np.asarray(jax.jit(jquant.make_quantized_policy(jm, params))(x))
    attn = "MultiHeadDotProductAttention_0"
    codes = jax.tree.map(lambda a: a, params)
    block = dict(codes["TransformerBlock_0"])
    block[attn] = {name: {"kernel": jnp.asarray(jquant._quant_kernel(leaf["kernel"])[0],
                                                 jnp.float32), "bias": leaf["bias"]}
                   for name, leaf in params["TransformerBlock_0"][attn].items()}
    codes = {**codes, "TransformerBlock_0": block}
    as_codes = np.asarray(jax.jit(lambda o: jquant.quantized_apply(jm, codes, o))(
        x.astype(np.float32) * (1.0 / 255.0)))
    np.testing.assert_allclose(shipped, as_codes, rtol=1e-5, atol=1e-5)
    obs = x.astype(np.float32) * (1.0 / 255.0)
    float_logits = np.asarray(jm.apply({"params": params}, obs))
    # int8 with the attention left float, JAX's path for unbaked weights
    sound = np.asarray(jax.jit(lambda o: jquant.quantized_apply(jm, params, o))(obs))
    assert (np.abs(shipped - float_logits).max()
            > 20 * np.abs(sound - float_logits).max())
    with pytest.raises(ValueError, match="ViTPolicy has no int8 path"):
        quantize_params(ViTPolicy(patch=8, dim=32, depth=1, heads=2))
