"""The port's threefry2x32 draws (``sim/prng.py``) vs ``jax.random``, bit
for bit: ``fold_in``, ``split``, ``randint`` and ``uniform`` on 64 raw keys,
with data up to 2³¹ and shapes () and (24,), under JAX's default
``jax_threefry_partitionable=True``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_imitation_learning_tpu_torch.sim import prng

RNG = np.random.default_rng(0)
KEYS = RNG.integers(0, 2 ** 32, (64, 2), dtype=np.uint64).astype(np.uint32)
DATA = np.concatenate([[0, 1, 2 ** 31 - 1, 2 ** 31],
                       RNG.integers(0, 2 ** 31, 60)]).astype(np.uint32)
P_KEYS = torch.as_tensor(KEYS.astype(np.int64))


def _equal(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.dtype == (torch.float32 if want.dtype == np.float32 else torch.int64)
    np.testing.assert_array_equal(got.numpy(), want.astype(got.numpy().dtype))


def test_partitionable_threefry_is_the_default():
    assert jax.config.jax_threefry_partitionable


def test_fold_in_matches():
    want = jax.vmap(jax.random.fold_in)(jnp.asarray(KEYS), jnp.asarray(DATA))
    _equal(prng.fold_in(P_KEYS, torch.as_tensor(DATA.astype(np.int64))), want)
    # a Python int folds into every key alike (the sim's 0x7F2B salt)
    _equal(prng.fold_in(P_KEYS, 0x7F2B),
           jax.vmap(lambda k: jax.random.fold_in(k, 0x7F2B))(jnp.asarray(KEYS)))


@pytest.mark.parametrize("num", [2, 3])
def test_split_matches(num):
    _equal(prng.split(P_KEYS, num),
           jax.vmap(lambda k: jax.random.split(k, num))(jnp.asarray(KEYS)))


@pytest.mark.parametrize("shape", [(), (24,)])
@pytest.mark.parametrize("span", [(0, 4), (0, 7), (3, 2 ** 31 - 5)])
def test_randint_matches(shape, span):
    want = jax.vmap(lambda k: jax.random.randint(k, shape, *span))(jnp.asarray(KEYS))
    _equal(prng.randint(P_KEYS, shape, *span), want)


@pytest.mark.parametrize("shape", [(), (24,)])
def test_uniform_matches(shape):
    want = jax.vmap(lambda k: jax.random.uniform(k, shape))(jnp.asarray(KEYS))
    got = prng.uniform(P_KEYS, shape)
    _equal(got, want)
    assert float(got.min()) >= 0.0 and float(got.max()) < 1.0


def test_chained_draws_match():
    """The draw chain of the turn-fan transfers: fold_in twice, split in 3,
    then a scalar randint, a (24,) randint and a (24,) uniform per key."""
    t = RNG.integers(0, 400, 64).astype(np.int32)

    def j_chain(k, tt):
        key = jax.random.fold_in(jax.random.fold_in(k, 0x7F2B), tt)
        a, b, c = jax.random.split(key, 3)
        return (jax.random.randint(a, (), 0, 4), jax.random.uniform(b, (24,)),
                jax.random.randint(c, (24,), 0, 4))

    want = jax.vmap(j_chain)(jnp.asarray(KEYS), jnp.asarray(t))
    key = prng.fold_in(prng.fold_in(P_KEYS, 0x7F2B), torch.as_tensor(t.astype(np.int64)))
    keys = prng.split(key, 3)
    got = (prng.randint(keys[:, 0], (), 0, 4), prng.uniform(keys[:, 1], (24,)),
           prng.randint(keys[:, 2], (24,), 0, 4))
    for g, w in zip(got, want):
        _equal(g, w)
