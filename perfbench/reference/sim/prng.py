"""Counter-based threefry2x32 draws, bit for bit those of ``jax.random``
under its default ``jax_threefry_partitionable=True``.

The part the sim and the hyperparameter search draw from: ``key(seed)``,
``fold_in``, ``split``, ``randint(key, shape, 0, span)``, ``uniform(key,
shape)`` and ``uniform_range`` on raw keys. A key is an int64
tensor of shape (..., 2) holding two uint32 words; every leading axis is a
batch axis (one key per env), so a fleet draws in one call. torch has no
shifts or multiplies on ``torch.uint32``, so the words live in int64 and
each add is masked back to 32 bits.

Under the partitionable scheme the bits of element ``i`` of a draw of any
shape come from hashing the counter pair (hi, lo) = (i >> 32, i & M) with
the key; ``split`` is the same hash read as keys, and 32-bit bits are the
xor of the hash's two words.
"""

from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & M32


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash of counters (x1, x2) under key (k1, k2): 20
    rounds with a key injection after every 4. All int64 holding uint32;
    the four arguments broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + k1) & M32
    x2 = (x2 + k2) & M32
    for block in range(5):
        for r in _ROTATIONS[block % 2]:
            x1 = (x1 + x2) & M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(block + 1) % 3]) & M32
        x2 = (x2 + ks[(block + 2) % 3] + block + 1) & M32
    return x1, x2


def _counters(shape: tuple, like: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) words of a row-major iota over ``shape``, broadcastable
    after the key's batch axes."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=like.device)
    return (idx >> 32).reshape(shape), (idx & M32).reshape(shape)


def _hash(key: torch.Tensor, shape: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """Both hash words for every element of ``shape``: (*batch, *shape)."""
    hi, lo = _counters(shape, key)
    pad = (None,) * len(shape)
    return threefry2x32(key[(..., 0) + pad], key[(..., 1) + pad], hi, lo)


def key(seed: int, device: str | torch.device = "cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for 0 <= seed < 2⁶⁴: the words (seed >> 32,
    seed & M)."""
    return torch.tensor([(seed >> 32) & M32, seed & M32], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the counter pair (0, data), with
    ``data`` a Python int or an integer tensor of the key's batch shape."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & M32
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([b1, b2], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: (*batch, num, 2) keys."""
    b1, b2 = _hash(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: tuple = ()) -> torch.Tensor:
    """32 random bits per element: (*batch, *shape) int64 in [0, 2³²)."""
    b1, b2 = _hash(key, tuple(shape))
    return b1 ^ b2


def randint(key: torch.Tensor, shape: tuple, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint`` for int32 bounds with ``minval < maxval``:
    two draws of 32 bits from a split key, reduced modulo the span through
    2³² mod span (JAX's method; biased unless the span is a power of 2)."""
    span = maxval - minval
    if span <= 0:
        raise ValueError(f"randint needs minval < maxval, got [{minval}, {maxval})")
    keys = split(key, 2)
    higher = random_bits(keys[..., 0, :], shape)
    lower = random_bits(keys[..., 1, :], shape)
    # uint32 arithmetic: every product and sum wraps at 2³² as in JAX
    multiplier = ((2 ** 16 % span) ** 2 & M32) % span
    offset = ((((higher % span) * multiplier) & M32) + lower % span) & M32
    return minval + offset % span


def uniform(key: torch.Tensor, shape: tuple = ()) -> torch.Tensor:
    """``jax.random.uniform`` in [0, 1) float32: the top 23 bits as the
    mantissa of a float in [1, 2), minus 1."""
    bits = random_bits(key, shape)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp(floats, min=0.0)


def uniform_range(key: torch.Tensor, shape: tuple, minval: float, maxval: float) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=minval, maxval=maxval)`` as
    XLA:CPU compiles it: ``u · (max − min) + min`` in float32 contracted
    into one fused multiply-add (the float32 product is exact in float64, so
    only the sum rounds), then at least ``minval``."""
    lo, hi = torch.tensor(minval, dtype=torch.float32), torch.tensor(maxval, dtype=torch.float32)
    span = (hi - lo).double()
    u = uniform(key, shape).double()
    return torch.maximum((u * span + lo.double()).to(torch.float32), lo.to(key.device))
