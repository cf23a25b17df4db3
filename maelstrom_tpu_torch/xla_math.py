"""XLA:CPU's float32 arithmetic where the simulator's trajectory depends
on it, rebuilt from elementary float32 ops and bit operations.

Two float hazards sit on the trajectory:

1. XLA:CPU compiles with floating-point contraction allowed, so
   ``f * span + minval`` (``jax.random.uniform``'s scale-and-shift) is
   one fused multiply-add with a single rounding. Separate float32
   multiply and add differ from it on 2,172,786 of the 8,388,608
   reachable values of the exponential latency draw.
2. ``jnp.log`` is XLA's own vectorised polynomial (the Cephes/Eigen
   ``plog`` scheme), and the backend contracts some, not all, of its
   multiply-adds. ``torch.log`` gives other latency ticks on a few
   reachable inputs (``tests/test_torch_xla_math.py`` counts them).

Each torch elementwise op is a kernel of its own, so nothing contracts
across ops here: every FMA below is written out (:func:`fma_f32`) and
every other multiply and add rounds on its own, exactly where XLA's
compiled kernel has them. The same ops give the same bits on the CPU
and on CUDA.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

Scalar = Union[torch.Tensor, float]


def f32(v: float) -> float:
    """``v`` rounded to float32, as a Python float (exact in float64):
    a constant that enters torch ops as a scalar argument, with no
    host-to-device copy."""
    return float(np.float32(v))


def fma_f32(a: torch.Tensor, b: Scalar, c: Scalar) -> torch.Tensor:
    """Correctly rounded float32 ``a * b + c`` (one rounding). ``b`` and
    ``c`` are tensors or float32-exact Python floats (:func:`f32`).

    The float32 product is exact in float64. The float64 sum is made
    exact with a TwoSum error term and rounded to odd (an inexact sum
    with an even last mantissa bit steps one float64 ulp toward the
    exact value), which keeps the final rounding to float32 correct:
    float64 carries more than two bits beyond float32's 24, and no
    float32 rounding midpoint is odd in float64."""
    a64 = a.double()
    b64 = b.double() if isinstance(b, torch.Tensor) else b
    c64 = c.double() if isinstance(c, torch.Tensor) else c
    p = a64 * b64
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf"))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


# Cephes/Eigen log polynomial coefficients, as XLA:CPU emits them
_SQRTHF = f32(0.707106781186547524)
_P = tuple(f32(v) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
    -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
    2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1))
_Q1 = f32(-2.12194440e-4)
_Q2 = f32(0.693359375)
_MIN_NORMAL = f32(1.17549435e-38)


def log(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 ``log``, bit for bit.

    Range reduction: ``x = m * 2**e`` with ``m`` in [0.5, 1); below
    sqrt(1/2) the mantissa is doubled. Then a degree-8 polynomial in
    three interleaved chains, combined with the exponent through the
    split constant ln 2 = Q2 - Q1. The fused steps are the ones XLA's
    compiled kernel fuses; ``q1 * e`` and the two powers round apart."""
    x = x.float()
    # XLA:CPU runs with denormals-are-zero: a subnormal input is 0
    x = torch.where(x.abs() < _MIN_NORMAL, 0.0, x)
    bits = x.clamp_min(_MIN_NORMAL).view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & -2139095041) | 0x3F000000).view(torch.float32)
    small = m < _SQRTHF
    t = (m - 1.0) + torch.where(small, m, 0.0)
    e = e - small.float()

    t2 = t * t
    t3 = t2 * t
    y0 = fma_f32(fma_f32(t, _P[0], _P[1]), t, _P[2])
    y1 = fma_f32(fma_f32(t, _P[3], _P[4]), t, _P[5])
    y2 = fma_f32(fma_f32(t, _P[6], _P[7]), t, _P[8])
    y = fma_f32(y0, t3, y1)
    y = fma_f32(y, t3, y2)
    y = fma_f32(y, t3, e * _Q1)
    r = (t - t2 * 0.5) + y               # 0.5 * t2 is exact
    r = fma_f32(e, _Q2, r)

    r = torch.where(x <= 0, float("nan"), r)
    r = torch.where(x == 0, float("-inf"), r)
    r = torch.where(x == float("inf"), x, r)
    return torch.where(torch.isnan(x), x, r)
