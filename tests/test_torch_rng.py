"""The port's threefry keys and draws against ``jax.random``, bit for bit,
over a sweep of seeds, purposes, ticks and instance ids: ``PRNGKey``,
``fold_in``, ``split`` (3, 4, N), ``randint`` at every bound the lin-kv
path and the fault fuzzer use (degenerate ranges included),
``bernoulli(0.5)``, ``uniform`` on (0, 1) and (1e-6, 1), and
``permutation``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maelstrom_tpu.tpu import runtime as jruntime
from maelstrom_tpu_torch import rng, runtime

SEEDS = [0, 7, 12345, 2**31 - 1, -1]


def _np_key(k):
    return np.asarray(k).astype(np.int64)


def _batch_keys(seed, n=48):
    """JAX keys of a realistic derivation chain: (seed, purpose, tick,
    instance) for a spread of purposes, ticks and ids."""
    master = jax.random.PRNGKey(seed)
    out = []
    for purpose in range(5):
        for t in (0, 1, 399, 4095):
            k = jax.random.fold_in(jax.random.fold_in(master, purpose), t)
            ids = jnp.arange(n // 16, dtype=jnp.int32) * 977
            out.append(jax.vmap(lambda i: jax.random.fold_in(k, i))(ids))
    return jnp.concatenate(out)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in(seed):
    np.testing.assert_array_equal(_np_key(jax.random.PRNGKey(seed)),
                                  rng.prng_key(seed).numpy())
    jk = _batch_keys(seed)
    master = rng.prng_key(seed)
    got = []
    for purpose in range(5):
        for t in (0, 1, 399, 4095):
            k = rng.fold_in(rng.fold_in(master, purpose), t)
            ids = torch.arange(3, dtype=torch.int32) * 977
            got.append(rng.fold_in(k[None], ids))
    np.testing.assert_array_equal(_np_key(jk), torch.cat(got).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_split(seed):
    jk = _batch_keys(seed)
    tk = torch.from_numpy(_np_key(jk))
    for n in (2, 3, 4, 6, 9):
        ref = jax.vmap(lambda k: jax.random.split(k, n))(jk)
        np.testing.assert_array_equal(_np_key(ref), rng.split(tk, n).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_draws(seed):
    jk = _batch_keys(seed)
    tk = torch.from_numpy(_np_key(jk))
    for shape in ((), (6,), (21,), (3, 4)):
        u = jax.vmap(lambda k: jax.random.uniform(k, shape))(jk)
        np.testing.assert_array_equal(
            np.asarray(u).view(np.int32),
            rng.uniform(tk, shape).numpy().view(np.int32))
        u = jax.vmap(lambda k: jax.random.uniform(
            k, shape, minval=1e-6, maxval=1.0))(jk)
        np.testing.assert_array_equal(
            np.asarray(u).view(np.int32),
            rng.uniform(tk, shape, 1e-6, 1.0).numpy().view(np.int32))
        b = jax.vmap(lambda k: jax.random.bernoulli(k, 0.5, shape))(jk)
        np.testing.assert_array_equal(np.asarray(b),
                                      rng.bernoulli(tk, 0.5, shape).numpy())
    # elect_jitter, n_keys/n_vals, n_nodes, plus a non-power-of-two span
    for hi in (60, 8, 3, 5, 1000):
        r = jax.vmap(lambda k: jax.random.randint(k, (), 0, hi,
                                                  dtype=jnp.int32))(jk)
        np.testing.assert_array_equal(np.asarray(r),
                                      rng.randint(tk, (), 0, hi).numpy())
    r = jax.vmap(lambda k: jax.random.randint(k, (4,), 2, 9))(jk)
    np.testing.assert_array_equal(np.asarray(r),
                                  rng.randint(tk, (4,), 2, 9).numpy())


@pytest.mark.parametrize("lo,hi", [(0, 1_000_000), (-5, 6), (0, 6),
                                   (0, 25), (0, 65_537), (-(2**31), 2**31 - 1),
                                   (3, 3 + 2**20)])
def test_randint_wide_spans(lo, hi):
    """Spans past 2**16, where JAX's uint32 square of the multiplier
    wraps (echo's payload draws from [0, 10**6)), and the counters'
    signed deltas, as static bounds and as tensor bounds."""
    jk = _batch_keys(5, 256)
    tk = torch.from_numpy(_np_key(jk))
    ref = np.asarray(jax.vmap(lambda k: jax.random.randint(
        k, (), lo, hi, dtype=jnp.int32))(jk))
    np.testing.assert_array_equal(ref, rng.randint(tk, (), lo, hi).numpy())
    np.testing.assert_array_equal(ref, rng.randint(
        tk, (), torch.tensor(lo), torch.tensor(hi)).numpy())


def test_tick_keys_match_instance_keys():
    """The batched per-tick derivation equals JAX's _instance_keys for
    every purpose (the nemesis purpose without the tick fold)."""
    master = jax.random.PRNGKey(7)
    ids = jnp.arange(37, dtype=jnp.int32)
    for t in (0, 5, 401):
        got = runtime.tick_keys(rng.prng_key(7),
                                torch.arange(37, dtype=torch.int32), t)
        for row, purpose in enumerate(runtime._TICK_PURPOSES):
            tt = None if purpose == runtime._RNG_NEMESIS else t
            ref = jruntime._instance_keys(master, purpose, ids, tt)
            np.testing.assert_array_equal(_np_key(ref), got[row].numpy())


def test_randint_from_bits_matches_split_draws():
    """sample_op's batched draw (one call for the uniform and three
    randints) equals the JAX per-key calls."""
    jk = _batch_keys(3)
    tk = torch.from_numpy(_np_key(jk))
    halves = rng.split(tk, 2)
    bits = rng.random_bits(halves)
    got = rng.randint_from_bits(bits[:, 0], bits[:, 1], 0, 8)
    ref = jax.vmap(lambda k: jax.random.randint(k, (), 0, 8))(jk)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    blocks = rng.split(tk, 6)
    ref = jax.vmap(lambda k: jax.random.uniform(k, (6,)))(jk)
    np.testing.assert_array_equal(
        np.asarray(ref).view(np.int32),
        rng.uniform_from_bits(rng.bits_of_split(blocks)).numpy()
        .view(np.int32))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 8, 17])
def test_permutation(n):
    """``jax.random.permutation(key, n)`` over 256 keys: zero rounds for
    n = 1, one stable sort round on 32-bit keys otherwise."""
    jk = _batch_keys(11, 256)
    ref = jax.vmap(lambda k: jax.random.permutation(k, n))(jk)
    got = rng.permutation(torch.from_numpy(_np_key(jk)), n)
    assert got.dtype == torch.int32 and got.shape == (jk.shape[0], n)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


@pytest.mark.parametrize("shape", [(), (5,), (2, 3)])
@pytest.mark.parametrize("lo,hi", [(0, 1000), (3, 4), (40, 201), (7, 7),
                                   (9, 2), (-5, 6), (64, 129)])
def test_randint_ranges(shape, lo, hi):
    """Scalar and vector randint, degenerate ranges ``[lo, lo]`` (hi =
    lo + 1) and empty ones (hi <= lo returns lo), as the fuzzer draws."""
    jk = _batch_keys(5, 64)
    ref = jax.vmap(lambda k: jax.random.randint(k, shape, lo, hi))(jk)
    got = rng.randint(torch.from_numpy(_np_key(jk)), shape, lo, hi)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


def test_tick_keys_with_restart_keys():
    """The fault lanes' fifth row: ``_RNG_RESTART`` keys at tick t, the
    JAX runtime's crash and park wipe keys; the other rows unchanged."""
    master = jax.random.PRNGKey(9)
    ids = jnp.arange(21, dtype=jnp.int32)
    tids = torch.arange(21, dtype=torch.int32)
    for t in (0, 77):
        got = runtime.tick_keys(rng.prng_key(9), tids, t, restart=True)
        assert got.shape == (5, 21, 2)
        ref = jruntime._instance_keys(master, jruntime._RNG_RESTART, ids, t)
        np.testing.assert_array_equal(_np_key(ref), got[4].numpy())
        np.testing.assert_array_equal(
            runtime.tick_keys(rng.prng_key(9), tids, t).numpy(),
            got[:4].numpy())
    assert (runtime._RNG_RESTART, runtime._RNG_FAULTS) == \
        (jruntime._RNG_RESTART, jruntime._RNG_FAULTS)
