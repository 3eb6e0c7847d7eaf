"""Counter-based random numbers equal to ``jax.random`` bit for bit (the
port's counterpart of what the reference's ``noise`` builtin takes from
``jax.random``: ``PRNGKey``, ``fold_in`` and ``uniform`` with the default
threefry2x32 generator in its partitionable form).

  * ``PRNGKey(seed)`` is the pair ``(0, seed & 0xFFFFFFFF)``.
  * ``fold_in(key, d)`` is ``threefry2x32(key, (0, d & 0xFFFFFFFF))``.
  * The 32 random bits of flat index ``i`` are ``x0 ^ x1`` of
    ``threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))``.
  * A uniform float keeps the top 23 bits as the mantissa of a number in
    [1, 2), minus 1, scaled to [minval, maxval).

PyTorch's uint32 support on CUDA is incomplete, so the uint32 words live
in int64 tensors and every sum is masked back to 32 bits.  The same code
runs on Python ints (the key schedule, on the host) and on tensors (the
counters, on the tensor's device).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
# Threefry-2x32's rotation constants, alternating per block of four rounds,
# and the key schedule's parity constant.
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KS_PARITY = 0x1BD11BDA


def _rotl(v, r: int):
    """32-bit rotate left of a word held in a wider integer."""
    return ((v & ((1 << (32 - r)) - 1)) << r) | (v >> (32 - r))


def threefry2x32(key: tuple[int, int], x0, x1):
    """Threefry-2x32 with 20 rounds (five blocks of four) of the words
    ``(x0, x1)`` (ints or int64 tensors holding uint32 values) under
    ``key``; returns the two output words."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ KS_PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for block in range(5):
        for r in ROTATIONS[block % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & MASK32
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & MASK32
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    return (0, int(seed) & MASK32)


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    return threefry2x32(key, 0, int(data) & MASK32)


def random_bits(key: tuple[int, int], shape: Sequence[int], device: Any = "cuda") -> torch.Tensor:
    """uint32 bits (in int64) of every flat index of ``shape``."""
    n = int(np.prod(shape)) if len(shape) else 1
    i = torch.arange(n, dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(key, i >> 32, i & MASK32)
    return (x0 ^ x1).reshape(tuple(shape))


def uniform(seed: int, shape: Sequence[int], minval: float = 0.0, maxval: float = 1.0,
            fold: Optional[int] = None, device: Any = "cuda") -> torch.Tensor:
    """``jax.random.uniform(PRNGKey(seed), shape, float32, minval, maxval)``
    (with ``fold_in(key, fold)`` first when ``fold`` is given) as an f32
    tensor on ``device``."""
    key = prng_key(seed)
    if fold is not None:
        key = fold_in(key, fold)
    bits = random_bits(key, shape, device)
    one_to_two = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp_min((one_to_two - 1.0) * span + lo, lo)
