"""JAX's default PRNG (threefry2x32, partitionable) as torch ops.

``repro.runtime.serving_jax`` draws its routing probes and revocations from
``jax.random``; every draw there is a pure function of the seed key and a
few integers (the tick, the entry, a sub-key tag). Reproducing the same
bits here lets the port's serving engine match the reference draw for
draw. A key is a pair of 32-bit words ``(k0, k1)``; every word is held in
an ``int64`` tensor masked to 32 bits, so sums never overflow and shifts
are logical. ``seed_key(s)`` is ``jax.random.PRNGKey(s)`` for a seed in
``[0, 2**32)``: ``(0, s)``.

``csrc/serving_fleet.cu`` carries the same function in device code.
"""

from __future__ import annotations

from typing import Tuple

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = Tuple[torch.Tensor, torch.Tensor]


def _u32(x, like=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64)
    device = like.device if like is not None else None
    return torch.as_tensor(x, dtype=torch.int64, device=device)


def threefry2x32(k0, k1, x0, x1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 20-round threefry2x32 block of ``jax.random`` on broadcast
    ``int64`` words in ``[0, 2**32)``; returns the two output words."""
    k0, k1 = _u32(k0), _u32(k1)
    x0, x1 = _u32(x0, k0), _u32(x1, k0)
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = (((x1 << r) | (x1 >> (32 - r))) & MASK) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def seed_key(seed, device=None) -> Key:
    """``jax.random.PRNGKey(seed)`` for seeds in ``[0, 2**32)``: ``(0, seed)``
    (a tensor of seeds gives a batch of keys)."""
    s = torch.as_tensor(seed, dtype=torch.int64, device=device) & MASK
    return torch.zeros_like(s), s


def fold_in(key: Key, data) -> Key:
    """``jax.random.fold_in``: the block of ``key`` at counter ``(0, data)``."""
    k0, k1 = key
    return threefry2x32(k0, k1, 0, _u32(data, k0) & MASK)


def random_bits(key: Key, n: int) -> torch.Tensor:
    """32-bit ``jax.random.bits(key, (n,))`` under partitionable threefry:
    counters ``(0, i)`` for the flat index ``i``, the two output words
    xored. A batched key (shape ``B``) gives ``B + (n,)`` bits."""
    k0, k1 = key
    idx = torch.arange(n, dtype=torch.int64, device=k0.device)
    b0, b1 = threefry2x32(k0.unsqueeze(-1), k1.unsqueeze(-1), 0, idx)
    return b0 ^ b1


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform``'s map of 32 bits to f32 in ``[0, 1)``: the top
    23 bits as the mantissa of a float in ``[1, 2)``, minus one."""
    word = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return word.view(torch.float32) - 1.0


def uniform(key: Key, n: int) -> torch.Tensor:
    """``jax.random.uniform(key, (n,))`` in f32 (minval 0, maxval 1)."""
    return bits_to_uniform(random_bits(key, n))
