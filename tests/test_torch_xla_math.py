"""XLA:CPU's float32 arithmetic on the trajectory, checked exhaustively.

The exponential latency draw is ``(-mean * log(uniform(k, 1e-6, 1)))``
cast to int32. Its ``u`` takes exactly 2**23 values (one per mantissa
of the random bits), so every reachable input is checked:

- the fused scale-and-shift of ``uniform(minval=1e-6, maxval=1)``;
- ``xla_math.log`` against ``jnp.log`` on every reachable ``u``;
- the latency ticks for means 5 and 10.

Each check is one vectorized pass. A random sweep over all positive
floats checks ``xla_math.log`` off the reachable set too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maelstrom_tpu_torch import rng, xla_math

from torch_tutorial_cases import one_torch_thread  # noqa: F401 (autouse)

LO = np.float32(1e-6)
SPAN = np.float32(1.0) - LO


@pytest.fixture(scope="module")
def mantissa_floats():
    """The 2**23 values of JAX's ``bits >> 9 | 1.0`` minus 1."""
    mant = np.arange(1 << 23, dtype=np.uint32)
    return (mant | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)


@pytest.fixture(scope="module")
def reachable_u(mantissa_floats):
    """Every ``u`` the latency draw can produce, as JAX computes it."""
    f = jax.jit(lambda f: jnp.maximum(LO, f * SPAN + LO))
    return np.array(f(mantissa_floats))


def test_uniform_transform_exhaustive(mantissa_floats, reachable_u):
    got = torch.maximum(torch.tensor(LO), xla_math.fma_f32(
        torch.from_numpy(mantissa_floats), torch.tensor(SPAN),
        torch.tensor(LO))).numpy()
    assert int((got.view(np.int32) != reachable_u.view(np.int32)).sum()) == 0
    # the path itself: uniform_from_bits on bits with every mantissa
    bits = torch.arange(1 << 23, dtype=torch.int64) << 9
    via_rng = rng.uniform_from_bits(bits, 1e-6, 1.0).numpy()
    assert int((via_rng.view(np.int32)
                != reachable_u.view(np.int32)).sum()) == 0


def test_unfused_transform_would_differ(mantissa_floats, reachable_u):
    """Separate float32 multiply and add do NOT reproduce JAX here —
    the reason the port writes the FMA out."""
    f = torch.from_numpy(mantissa_floats)
    unfused = torch.maximum(torch.tensor(LO),
                            f * torch.tensor(SPAN) + torch.tensor(LO))
    assert int((unfused.numpy().view(np.int32)
                != reachable_u.view(np.int32)).sum()) == 2_172_786


def test_torch_log_would_differ(reachable_u):
    """``torch.log`` is not XLA's log: on the reachable ``u`` it gives
    other latency ticks for some mean (2 inputs at mean 50 with torch
    2.13.0+cpu) — the reason for ``xla_math.log``."""
    u = torch.from_numpy(reachable_u)
    counts = {}
    for mean in (5.0, 10.0, 50.0):
        ref = np.asarray(jax.jit(
            lambda u: (-mean * jnp.log(u)).astype(jnp.int32))(reachable_u))
        got = (torch.log(u) * np.float32(-mean)).to(torch.int32).numpy()
        counts[mean] = int((got != ref).sum())
    assert sum(counts.values()) > 0, counts


def test_log_exhaustive_on_reachable_u(reachable_u):
    ref = np.asarray(jax.jit(jnp.log)(reachable_u))
    got = xla_math.log(torch.from_numpy(reachable_u)).numpy()
    assert int((got.view(np.int32) != ref.view(np.int32)).sum()) == 0


@pytest.mark.parametrize("mean", [5.0, 10.0])
def test_exponential_latency_ticks_exhaustive(reachable_u, mean):
    ref = np.asarray(jax.jit(
        lambda u: (-mean * jnp.log(u)).astype(jnp.int32))(reachable_u))
    got = (torch.tensor(-mean, dtype=torch.float32)
           * xla_math.log(torch.from_numpy(reachable_u))).to(torch.int32)
    assert int((got.numpy() != ref).sum()) == 0


def test_log_random_positive_floats():
    """Off the reachable set: random bit patterns over every positive
    float (subnormals included — XLA:CPU treats them as zero)."""
    bits = np.random.default_rng(0).integers(
        1, 0x7F800000, size=1 << 21).astype(np.int32)
    x = bits.view(np.float32)
    ref = np.asarray(jax.jit(jnp.log)(x))
    got = xla_math.log(torch.from_numpy(x)).numpy()
    assert int((got.view(np.int32) != ref.view(np.int32)).sum()) == 0
    special = np.array([0.0, np.inf, 1.0, 2.0, 0.5], dtype=np.float32)
    np.testing.assert_array_equal(
        np.asarray(jax.jit(jnp.log)(special)),
        xla_math.log(torch.from_numpy(special)).numpy())


def test_fma_is_single_rounding():
    """fma_f32 on random float32 triples equals the exact product-sum
    rounded once (the exact value from Python fractions)."""
    from fractions import Fraction
    rs = np.random.default_rng(1)
    a, b, c = (rs.standard_normal(2000).astype(np.float32) for _ in range(3))
    got = xla_math.fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                           torch.from_numpy(c)).numpy()
    for i in range(0, 2000, 7):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) \
            + Fraction(float(c[i]))
        # nearest float32 to the exact value, ties to even
        lo = np.float32(float(exact))
        cands = [lo, np.nextafter(lo, np.float32(np.inf)),
                 np.nextafter(lo, np.float32(-np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(v.view(np.int32)) & 1))
        assert got[i].view(np.int32) == best.view(np.int32), i
