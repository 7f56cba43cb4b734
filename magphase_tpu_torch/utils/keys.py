"""Per-utterance noise keys without JAX: the threefry-2x32 keys that
``jax.random.PRNGKey`` and ``jax.random.split`` give, in numpy.

The serving path draws each utterance's noise from a (2,) uint32 key
(vocoder/compressed.py hashes it), and the JAX package derives those keys
as ``jax.random.split(key, n)`` from one root key
(magphase_tpu/parallel/batch.py:245-253).  This module computes the same
bits with uint32 numpy arithmetic, for JAX's default configuration:
64-bit types off, the threefry2x32 implementation, and the partitionable
("fold-like") split, which hashes the counter pair (0, i) with the key for
the i-th child.  So ``split(k, m)[i] == split(k, n)[i]`` for i < min(m, n):
a batch cut into groups draws the same noise per utterance.

``uniform`` draws float32 noise from a key as ``jax.random.uniform`` does
(the variant vocoders' noise and Griffin-Lim's random phase): the random
bits of flat index i hash the counter pair (0, i), so a draw is a prefix
of any longer draw from the same key.  ``uniform_tensor`` computes the
same values with torch on a device (a Griffin-Lim initial phase is
millions of draws).
"""
from __future__ import annotations

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """Threefry-2x32 with 20 rounds of the (2,) uint32 ``key`` over the
    counter words x0, x1 (uint32 arrays of one shape); returns the two
    hashed words."""
    k0, k1 = (np.uint32(k) for k in np.asarray(key, np.uint32))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x0 = np.asarray(x0, np.uint32) + ks[0]
        x1 = np.asarray(x1, np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """The (2,) uint32 key of ``jax.random.PRNGKey(seed)`` with 64-bit
    types off (JAX's default): [0, seed mod 2^32]."""
    return np.asarray([0, int(seed) & 0xFFFFFFFF], np.uint32)


def split(key, n: int) -> np.ndarray:
    """(n, 2) uint32 child keys, bit for bit ``jax.random.split(key, n)``:
    child i is the threefry hash of the counter pair (0, i)."""
    key = np.asarray(key, np.uint32)
    if key.shape != (2,):
        raise ValueError(f"key shape {key.shape}, expected (2,)")
    i = np.arange(n, dtype=np.uint32)
    return np.stack(threefry2x32(key, np.zeros_like(i), i), axis=-1)


def uniform(key, shape, minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """float32 noise of ``shape``, bit for bit ``jax.random.uniform(key,
    shape, float32, minval, maxval)``: the random bits of flat index i are
    the two threefry words of the counter pair (0, i) xored; their top 23
    bits are the mantissa of a float in [1, 2), minus 1, scaled to
    [minval, maxval), then floored at minval.  The numpy reference of
    ``uniform_tensor``."""
    shape = tuple(int(d) for d in np.atleast_1d(shape))
    n = int(np.prod(shape, dtype=np.int64))
    if n >= 1 << 32:
        raise ValueError(f"uniform: {n} draws, more than 2^32")
    key = np.asarray(key, np.uint32)
    if key.shape != (2,):
        raise ValueError(f"key shape {key.shape}, expected (2,)")
    i = np.arange(n, dtype=np.uint32)
    w0, w1 = threefry2x32(key, np.zeros_like(i), i)
    bits = ((w0 ^ w1) >> np.uint32(9)) | np.uint32(0x3F800000)
    f = bits.view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    # f * (hi - lo) + lo rounded once, as the fused multiply-add that XLA
    # forms for it: the float64 product of two float32 values is exact,
    # and so is the sum while lo is within 2^5 of the product's scale
    scale = np.float64(hi - lo)
    out = (f.astype(np.float64) * scale + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, out).reshape(shape)


_M32 = 0xFFFFFFFF


def _threefry_tensor(key, x1: torch.Tensor):
    """threefry2x32 of the counter pairs (0, x1) as int64 tensors holding
    uint32 values (torch has no unsigned 32-bit arithmetic on the CPU):
    the same words as ``threefry2x32``, on x1's device."""
    k0, k1 = (int(k) for k in np.asarray(key, np.uint32))
    ks = (k0, k1, k0 ^ k1 ^ int(_PARITY))
    x0 = torch.full_like(x1, ks[0])
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def uniform_tensor(key, shape, minval: float = 0.0, maxval: float = 1.0, *,
                   device="cpu") -> torch.Tensor:
    """``uniform`` computed on ``device`` as a float32 tensor, bit for bit
    the same values: the threefry words in int64, the scaling in float64
    rounded once."""
    shape = tuple(int(d) for d in np.atleast_1d(shape))
    n = int(np.prod(shape, dtype=np.int64))
    if n >= 1 << 32:
        raise ValueError(f"uniform: {n} draws, more than 2^32")
    w0, w1 = _threefry_tensor(key, torch.arange(n, dtype=torch.int64,
                                                device=device))
    bits = ((w0 ^ w1) >> 9) | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    out = (f.to(torch.float64) * float(hi - lo) + float(lo)).to(torch.float32)
    return torch.clamp(out, min=float(lo)).reshape(shape)
