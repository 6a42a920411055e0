"""The JAX package's random initial tube, drawn in numpy.

``pymgrit_tpu.Mgrit(random_init_guess=True)`` draws its level-0 tube as

    key = PRNGKey(rng_seed); key, sub = split(key)
    row r:  random_like(template, split(sub, nt)[r])
            = uniform(split(k_r, n_leaves)[0], template.shape, float64)

with JAX's default generator: threefry2x32, ``jax_threefry_partitionable``
on (a key split and a bit draw hash a 64-bit iota of their shape, split
into its high and low words), and a float64 drawn from 64 random bits (the
top 52 become the mantissa of a number in [1, 2), then 1 is subtracted).
This module repeats that arithmetic on uint32 numpy arrays (the key
splits, and the bit-for-bit reference of the draw) and draws the tube on
its device in torch (int64 tensors holding 32-bit words), so the port's
tube is the JAX package's tube for every seed.  States are single tensors
in the port (one leaf).
"""

from __future__ import annotations

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
_MASK = 0xFFFFFFFF
_CHUNK = 1 << 22           # values drawn at a time on the device


def _rotl(x, d):
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the count pairs (x1, x2) under
    the key (k1, k2); all uint32 arrays that broadcast together."""
    k1, k2, x1, x2 = np.broadcast_arrays(*(np.asarray(a, dtype=np.uint32) for a in (k1, k2, x1, x2)))
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [x1 + ks[0], x2 + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` with 64-bit integers: the seed's high
    and low words."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([s >> 32, s & 0xFFFFFFFF], dtype=np.uint32)


def _iota(n: int):
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def split(keys: np.ndarray, num: int) -> np.ndarray:
    """``jax.random.split`` of (..., 2) keys into (..., num, 2)."""
    hi, lo = _iota(num)
    b1, b2 = threefry2x32(keys[..., 0, None], keys[..., 1, None], hi, lo)
    return np.stack([b1, b2], axis=-1)


def uniform_f64(keys: np.ndarray, shape) -> np.ndarray:
    """``jax.random.uniform(k, shape, float64)`` for every (..., 2) key:
    (..., *shape) values in [0, 1)."""
    n = int(np.prod(shape, dtype=np.int64))
    hi, lo = _iota(n)
    b1, b2 = threefry2x32(keys[..., 0, None], keys[..., 1, None], hi, lo)
    bits = (b1.astype(np.uint64) << np.uint64(32)) | b2.astype(np.uint64)
    one = np.array(1.0, dtype=np.float64).view(np.uint64)
    floats = ((bits >> np.uint64(12)) | one).view(np.float64) - 1.0
    return floats.reshape(keys.shape[:-1] + tuple(shape))


def uniform(key: np.ndarray, shape, dtype) -> np.ndarray:
    """``jax.random.uniform(key, shape, dtype)`` for one (2,) key and a
    float64 or float32 dtype (torch's or numpy's).  float32 takes the xor of
    the two 32-bit words of the hash and keeps its top 23 bits."""
    if dtype in (torch.float64, np.float64):
        return uniform_f64(key, shape)
    if dtype not in (torch.float32, np.float32):
        raise NotImplementedError(f"uniform draws of dtype {dtype} are not ported")
    n = int(np.prod(shape, dtype=np.int64))
    hi, lo = _iota(n)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    one = np.array(1.0, dtype=np.float32).view(np.uint32)
    floats = (((b1 ^ b2) >> np.uint32(9)) | one).view(np.float32) - np.float32(1.0)
    return floats.reshape(tuple(shape))


def random_tube_numpy(seed: int, nt: int, shape) -> np.ndarray:
    """The JAX package's ``random_init_guess`` level-0 tube in numpy:
    (nt, *shape) float64 for a one-leaf state of the given shape."""
    _, sub = split(key(seed), 2)
    rows = split(split(sub, nt), 1)[:, 0]
    return uniform_f64(rows, shape)


def _threefry2x32_torch(k1, k2, x1, x2):
    """threefry2x32 on int64 tensors holding uint32 words (masked after
    every sum and shift)."""
    ks = (k1, k2, k1 ^ k2 ^ int(_PARITY))
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = (((x[1] << r) | (x[1] >> (32 - r))) & _MASK) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x[0], x[1]


def random_tube(seed: int, nt: int, shape, device=None) -> torch.Tensor:
    """The JAX package's ``random_init_guess`` level-0 tube: (nt, *shape)
    float64 on ``device`` for a one-leaf state of the given shape.  The nt
    row keys are split on the host; the bits are drawn on the device, a
    chunk of rows at a time."""
    _, sub = split(key(seed), 2)
    rows = split(split(sub, nt), 1)[:, 0]
    n = int(np.prod(shape, dtype=np.int64))
    keys = torch.as_tensor(rows.astype(np.int64), device=device)
    tube = torch.empty((nt, n), dtype=torch.float64, device=device)
    i = torch.arange(n, dtype=torch.int64, device=device)
    hi, lo = (i >> 32)[None], (i & _MASK)[None]
    chunk = max(1, _CHUNK // max(n, 1))
    for r0 in range(0, nt, chunk):
        k = keys[r0:r0 + chunk]
        b1, b2 = _threefry2x32_torch(k[:, :1], k[:, 1:], hi, lo)
        # the top 52 of the 64 bits b1:b2, as m * 2^-52 = (1 + m 2^-52) - 1
        tube[r0:r0 + chunk] = ((b1 << 20) | (b2 >> 12)).to(torch.float64) * 2.0 ** -52
    return tube.view((nt,) + tuple(shape))


def random_dd_tube(seed: int, nt: int, shape, device=None) -> torch.Tensor:
    """The JAX package's ``random_init_guess`` level-0 tube of a DD state:
    each row's hi drawn as ``jax.random.uniform(k, shape, float32)`` with
    the row key of ``random_tube``, lo = 0; the packed (nt, 2, *shape)
    float32 tube the solver stores (drawn on the host)."""
    _, sub = split(key(seed), 2)
    rows = split(split(sub, nt), 1)[:, 0]
    tube = torch.zeros((nt, 2) + tuple(shape), dtype=torch.float32, device=device)
    for r0 in range(0, nt, _CHUNK_ROWS):
        hi = np.stack([uniform(k, shape, np.float32) for k in rows[r0:r0 + _CHUNK_ROWS]])
        tube[r0:r0 + hi.shape[0], 0] = torch.as_tensor(hi, device=device)
    return tube


_CHUNK_ROWS = 256
