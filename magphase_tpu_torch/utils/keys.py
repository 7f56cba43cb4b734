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
"""
from __future__ import annotations

import numpy as np

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
