"""Threefry-2x32 random draws, bit for bit those of ``jax.random``.

The counterpart of the ``jax.random`` calls in the reference search
(``repro/core/search_jax.py:373-406``), so the port's search explores the
same chains as the reference for the same seed.  It follows
``jax._src.prng`` and ``jax._src.random`` with
``jax_threefry_partitionable=True`` (JAX's default):

* ``key(seed) = (seed >> 32, seed & 0xffffffff)``;
* ``fold_in(k, d) = threefry2x32(k, (0, d))``;
* ``split(k)[i] = threefry2x32(k, (0, i))``;
* random bits: ``(b1, b2) = threefry2x32(k, (0, 0))``, 32-bit draws take
  ``b1 ^ b2`` and 64-bit draws ``b1 << 32 | b2``;
* ``randint`` reduces two draws (from the two halves of ``split``) with
  JAX's ``(hi % span) * (2^(bits/2) % span)^2 % span + lo % span``;
* ``uniform_f32`` puts the top 23 bits of a 32-bit draw under the
  exponent of 1.0 and subtracts 1.

Everything is vectorised over a leading chain axis.  Values are int64
tensors holding unsigned 32-bit words (CUDA has no full uint32 arithmetic
in torch), masked after every add and shift.  A key is a pair ``(k1, k2)``
of such tensors.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Key = tuple[torch.Tensor, torch.Tensor]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(key: Key, x0: torch.Tensor, x1: torch.Tensor) -> Key:
    """The Threefry-2x32 hash of the counter pair ``(x0, x1)`` under
    ``key``: 20 rounds, key injected every 4 (``jax._src.prng``'s
    unrolled lowering)."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    a = (x0 + ks[0]) & M32
    b = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & M32
        b = (b + ks[(i + 2) % 3] + i + 1) & M32
    return a, b


def key(seed: int, n: int = 1, device=None) -> Key:
    """``jax.random.PRNGKey(seed)`` for a non-negative seed, repeated over
    ``n`` chains."""
    if seed < 0:
        raise ValueError(f"seed ({seed}) must be >= 0")
    full = torch.full((n,), 0, dtype=torch.int64, device=device)
    return full + ((seed >> 32) & M32), full + (seed & M32)


def fold_in(k: Key, data) -> Key:
    """``jax.random.fold_in(k, data)``; ``data`` is an int or a tensor of
    non-negative ints broadcast against the key (a tensor on the key's
    device is used as it is, so a device step counter folds in without a
    host copy)."""
    d = torch.as_tensor(data, dtype=torch.int64, device=k[0].device) & M32
    return threefry2x32(k, torch.zeros_like(d), d)


def split(k: Key, num: int = 2) -> list[Key]:
    """``jax.random.split(k, num)`` as a list of ``num`` keys."""
    zero = torch.zeros_like(k[0])
    return [threefry2x32(k, zero, zero + i) for i in range(num)]


def _bits(k: Key) -> Key:
    zero = torch.zeros_like(k[0])
    return threefry2x32(k, zero, zero)


def bits32(k: Key) -> torch.Tensor:
    """``jax.random.bits(k, (), uint32)``."""
    b1, b2 = _bits(k)
    return b1 ^ b2


def randint(k: Key, lo: int, hi, bits: int = 32) -> torch.Tensor:
    """``jax.random.randint(k, (), lo, hi)`` with ``int32`` (``bits=32``,
    JAX's default) or ``int64`` (``bits=64``, the default under x64)
    output; ``hi`` may be a tensor of per-chain bounds.  Returns int64.

    A 64-bit draw ``b1 * 2^32 + b2`` is reduced modulo the span from its
    two 32-bit halves, ``((b1 % span) * (2^32 % span) + b2 % span) %
    span``, so nothing overflows int64 (spans stay below 2^31)."""
    if bits not in (32, 64):
        raise ValueError(f"bits ({bits}) must be 32 or 64")
    kh, kl = split(k)
    # a Python bound is filled on the device (no host copy, so the draw
    # can be captured in a CUDA graph)
    hi_t = (hi.to(torch.int64) if isinstance(hi, torch.Tensor)
            else torch.full((), hi, dtype=torch.int64, device=k[0].device))
    span = torch.where(hi_t <= lo, torch.ones_like(hi_t), hi_t - lo)
    if bits == 32:
        higher, lower = bits32(kh), bits32(kl)
        m = 65536 % span                  # uint32 products wrap, as in JAX
        mult = ((m * m) & M32) % span
        off = ((higher % span) * mult & M32) + lower % span
        off = (off & M32) % span
    else:
        two32 = (1 << 32) % span
        h1, h2 = _bits(kh)
        l1, l2 = _bits(kl)
        higher = ((h1 % span) * two32 + h2 % span) % span
        lower = ((l1 % span) * two32 + l2 % span) % span
        mult = (two32 * two32) % span
        off = (higher * mult + lower) % span
    return lo + off


def uniform_f32(k: Key) -> torch.Tensor:
    """``jax.random.uniform(k, (), float32)`` in [0, 1)."""
    word = (bits32(k) >> 9) | 0x3F800000
    return word.to(torch.int32).view(torch.float32) - 1.0
