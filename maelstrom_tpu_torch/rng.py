"""Threefry-2x32 keys and draws, bit-identical to ``jax.random``.

A trajectory of the simulator is a pure function of (seed, purpose,
tick, instance id) through ``jax.random``; the port reproduces those
bits exactly, so a JAX carry and a port carry can be compared at every
tick. This module mirrors JAX's default threefry implementation with
``jax_threefry_partitionable=True`` (``jax/_src/prng.py``:
``threefry_seed``, ``iota_2x32_shape``, the fold-like split and the
partitionable random bits; ``jax/_src/random.py``: ``uniform``,
``randint``, ``bernoulli``, ``_shuffle`` behind ``permutation``).

Representation: a key is an int64 tensor ``[..., 2]`` holding two
uint32 words; all arithmetic is int64 masked to 32 bits, which is
identical on the CPU and on CUDA (no reliance on ``torch.uint32``
kernels). Every function broadcasts over leading axes, so one call
draws for a whole ``[I, ...]`` batch of keys.

Facts of the partitionable scheme used below:

- ``fold_in(k, d) = threefry(k, (0, d))``;
- ``split(k, n)[i] = threefry(k, (0, i)) = fold_in(k, i)``;
- ``random_bits(k, shape)[j] = x0 ^ x1`` of ``threefry(k, (0, j))``
  with ``j`` the row-major flat index (sizes below 2**32).

So ``split(k, n)`` and ``random_bits(k, (n,))`` come from the same
blocks, and independent draws can share one batched threefry call: each
call is ~170 elementwise ops, which on the card are ~170 launches, so
callers batch keys wherever the JAX code draws from siblings.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from . import xla_math

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

IntLike = Union[int, torch.Tensor]


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: IntLike,
                 x1: IntLike):
    """The Threefry-2x32 block (20 rounds), broadcasting int64 words.

    ``x0`` carries bits above 31 between rounds (its low 32 bits are
    exact: it only ever takes additions, at most 26 of 32-bit values);
    ``x1`` is masked after every update, because the rotation reads its
    high bits. So a round is six elementwise ops instead of seven."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = ks[0] if isinstance(x0, int) and x0 == 0 else ks[0] + x0
    x1 = (ks[1] + x1) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = x0 + x1
            x1 = (((x1 << r) | (x1 >> (32 - r))) ^ x0) & M32
        x0 = x0 + ks[(i + 1) % 3]
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0 & M32, x1


def _as_word(d: IntLike, device) -> IntLike:
    if isinstance(d, torch.Tensor):
        return d.to(device=device, dtype=torch.int64) & M32
    return int(d) & M32


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for an int32 seed: ``[0, seed]``
    (a negative seed's high word shifts out to 0, as in JAX)."""
    if not -(1 << 31) <= int(seed) < (1 << 31):
        raise ValueError(f"seed {seed} does not fit int32")
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data: IntLike) -> torch.Tensor:
    """``jax.random.fold_in`` over a batch: ``key [..., 2]`` and ``data``
    broadcastable to ``key[..., 0]``."""
    o0, o1 = threefry2x32(key[..., 0], key[..., 1], 0,
                          _as_word(data, key.device))
    return torch.stack([o0, o1], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` batched: ``[..., 2] -> [..., num, 2]``."""
    idx = torch.arange(num, dtype=torch.int64, device=key.device)
    return fold_in(key[..., None, :], idx)


def random_bits(key: torch.Tensor, shape: Sequence[int] = ()
                ) -> torch.Tensor:
    """32 random bits per element: ``[..., 2] -> [..., *shape]`` int64."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    lo = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    k0 = key[..., 0].reshape(key.shape[:-1] + (1,) * len(shape))
    k1 = key[..., 1].reshape(key.shape[:-1] + (1,) * len(shape))
    b0, b1 = threefry2x32(k0, k1, 0, lo)
    return b0 ^ b1


def bits_of_split(blocks: torch.Tensor) -> torch.Tensor:
    """``random_bits(k, (n,))`` from ``split(k, n)``'s blocks ``[..., n,
    2]``: the same threefry outputs, xor-folded."""
    return blocks[..., 0] ^ blocks[..., 1]


def unit_float(bits: torch.Tensor) -> torch.Tensor:
    """JAX's mantissa trick: ``bits >> 9 | 0x3F800000`` as a float in
    [1, 2), minus 1."""
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return fbits.view(torch.float32) - 1.0


def uniform(key: torch.Tensor, shape: Sequence[int] = (),
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32. XLA:CPU contracts the
    scale-and-shift ``f * (maxval - minval) + minval`` into one fused
    multiply-add, so the port computes it with a single rounding
    (``xla_math.fma_f32``), then clamps at ``minval`` as JAX does."""
    return uniform_from_bits(random_bits(key, shape), minval, maxval)


def uniform_from_bits(bits: torch.Tensor, minval: float = 0.0,
                      maxval: float = 1.0) -> torch.Tensor:
    """The float32 uniform of :func:`uniform` from its 32 random bits."""
    f = unit_float(bits)
    if minval == 0.0 and maxval == 1.0:
        return f   # f * 1 + 0 is exact either way, and f >= 0
    lo = xla_math.f32(minval)
    span = xla_math.f32(np.float32(maxval) - np.float32(minval))
    return xla_math.fma_f32(f, span, lo).clamp_min(lo)


def randint(key: torch.Tensor, shape: Sequence[int], minval: IntLike,
            maxval: IntLike) -> torch.Tensor:
    """``jax.random.randint`` for int32: two 32-bit draws from the key's
    two split halves (one batched threefry call), combined with JAX's
    multiply-mod reduction. Bounds are ints or int tensors broadcastable
    to the result. Returns int32."""
    bits = random_bits(split(key, 2), shape)          # [..., 2, *shape]
    nd = len(tuple(shape))
    return randint_from_bits(bits.select(-1 - nd, 0),
                             bits.select(-1 - nd, 1), minval, maxval)


def randint_from_bits(hi_bits: torch.Tensor, lo_bits: torch.Tensor,
                      minval: IntLike, maxval: IntLike) -> torch.Tensor:
    """JAX's randint reduction of the draws of ``split(key)[0]`` (high)
    and ``split(key)[1]`` (low)."""
    dev = hi_bits.device
    if isinstance(minval, torch.Tensor) or isinstance(maxval, torch.Tensor):
        lo = torch.as_tensor(minval, device=dev).to(torch.int64)
        hi = torch.as_tensor(maxval, device=dev).to(torch.int64)
        span = (hi - lo) & M32
        span = torch.where(hi <= lo, torch.ones_like(span), span)
    else:   # static bounds: the span and multiplier are Python ints
        lo, hi = int(minval), int(maxval)
        span = ((hi - lo) & M32) if hi > lo else 1
    # JAX squares the multiplier in uint32: past a span of 2**16 the
    # square wraps (for a span of 10**6 it wraps to 0)
    mult = (1 << 16) % span
    mult = ((mult * mult) & M32) % span
    off = ((hi_bits % span) * mult) & M32
    off = (off + (lo_bits % span)) & M32
    off = off % span
    return _wrap_i32(lo + off)


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap."""
    x = x & M32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def bernoulli(key: torch.Tensor, p: float, shape: Sequence[int] = ()
              ) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` (mode 'low'): a float32
    uniform compared against float32 ``p``."""
    return uniform(key, shape) < xla_math.f32(p)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` batched: ``[..., 2] -> [...,
    n]`` int32. JAX's ``_shuffle``: ``ceil(3 ln(max(1, n)) / ln(2^32 -
    1))`` rounds (one for n up to ~1,600, none for n = 1), each
    splitting the key, drawing 32-bit sort keys from the second half
    and reordering by a stable sort on them (``lax.sort_key_val``)."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(M32)))
    x = torch.arange(n, dtype=torch.int32, device=key.device).expand(
        key.shape[:-1] + (n,))
    for _ in range(rounds):
        halves = split(key, 2)
        key = halves[..., 0, :]
        order = torch.argsort(random_bits(halves[..., 1, :], (n,)), dim=-1,
                              stable=True)
        x = x.gather(-1, order)
    return x
