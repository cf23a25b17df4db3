"""The port's simulated network against the JAX package's: delivery
(plain version vs ``vmap(netsim.deliver)`` and the Pallas kernel in
interpret mode) and enqueue (vs ``vmap(netsim.enqueue)``), on seeded
random pools. Tolerance 0: every output is int32 state."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maelstrom_tpu.ops.delivery import deliver_pallas
from maelstrom_tpu.tpu import netsim as jnetsim
from maelstrom_tpu.tpu.netsim import NetConfig as JNetConfig
from maelstrom_tpu_torch import netsim, wire
from maelstrom_tpu_torch.kernels import delivery

# (n_nodes, n_clients, S, K, body_lanes, I): the Pallas test shape, the
# flagship lin-kv shape, and the widest defaults (S=128, K=8)
SHAPES = {
    "pallas-test": (3, 3, 32, 4, 6, 8),
    "flagship": (3, 6, 16, 1, 12, 64),
    "wide": (3, 6, 128, 8, 12, 8),
}


def _cfgs(n, c, S, K, body, lat=5.0, dist=2, p_loss=0.0):
    kw = dict(n_nodes=n, n_clients=c, pool_slots=S, inbox_k=K,
              body_lanes=body, latency_mean=lat, latency_dist=dist,
              p_loss=p_loss)
    return netsim.NetConfig(**kw), JNetConfig(**kw)


def random_pools(rs, I, cfg, fill=0.6, max_dtick=30):
    """Seeded random pools ``[I, S, L]`` and partition planes."""
    S, L, NT = cfg.pool_slots, cfg.lanes, cfg.n_total
    pools = np.zeros((I, S, L), dtype=np.int32)
    occ = rs.random_sample((I, S)) < fill
    pools[..., wire.VALID] = occ
    pools[..., wire.SRC] = rs.randint(0, NT, (I, S)) * occ
    pools[..., wire.DEST] = rs.randint(0, NT, (I, S)) * occ
    pools[..., wire.ORIGIN] = rs.randint(0, NT, (I, S)) * occ
    pools[..., wire.DTICK] = rs.randint(0, max_dtick, (I, S)) * occ
    pools[..., wire.TYPE] = rs.randint(1, 9, (I, S)) * occ
    pools[..., wire.BODY:] = rs.randint(0, 100, (I, S, L - wire.BODY)) \
        * occ[..., None]
    parts = rs.random_sample((I, NT, NT)) < 0.25
    np.einsum("ijj->ij", parts)[:] = False
    return pools, parts


def _port_deliver(pools, parts, t, cfg):
    out = delivery.deliver(torch.from_numpy(pools.copy()),
                           torch.from_numpy(parts.copy()), t, cfg)
    return [o.numpy() for o in out]


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("seed", [0, 1])
def test_deliver_reference_matches_xla(shape, seed):
    n, c, S, K, body, I = SHAPES[shape]
    cfg, jcfg = _cfgs(n, c, S, K, body)
    pools, parts = random_pools(np.random.RandomState(seed), I, cfg)
    for t in (0, 15, 29):
        ref = jax.vmap(lambda p, pa: jnetsim.deliver(p, pa, jnp.int32(t),
                                                     jcfg))(
            jnp.asarray(pools), jnp.asarray(parts))
        got = _port_deliver(pools, parts, t, cfg)
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(np.asarray(r), g)


@pytest.mark.parametrize("shape", ["pallas-test", "flagship"])
def test_deliver_reference_matches_pallas_interpret(shape):
    n, c, S, K, body, I = SHAPES[shape]
    I = min(I, 8)
    cfg, jcfg = _cfgs(n, c, S, K, body)
    pools, parts = random_pools(np.random.RandomState(7), I, cfg)
    ref = deliver_pallas(jnp.asarray(pools), jnp.asarray(parts),
                         jnp.int32(15), jcfg, interpret=True)
    got = _port_deliver(pools, parts, 15, cfg)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r), g)


def test_deliver_wrapper_counts_no_cpu_launch():
    """On a CPU tensor the wrapper runs the plain version: no launch."""
    cfg, _ = _cfgs(*SHAPES["flagship"][:5])
    pools, parts = random_pools(np.random.RandomState(3), 4, cfg)
    before = delivery.deliver.launches
    _port_deliver(pools, parts, 10, cfg)
    assert delivery.deliver.launches == before


@pytest.mark.cuda
def test_deliver_kernel_matches_reference_on_card():
    """The CUDA kernel against its plain version on the card (bit-equal)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the delivery kernel has "
                    "no CPU or interpret mode")
    for shape in sorted(SHAPES):
        n, c, S, K, body, I = SHAPES[shape]
        cfg, _ = _cfgs(n, c, S, K, body)
        pools, parts = random_pools(np.random.RandomState(5), I, cfg)
        p = torch.from_numpy(pools).cuda()
        pa = torch.from_numpy(parts).cuda()
        got = delivery.deliver(p, pa, 15, cfg)
        ref = netsim.deliver_reference(p, pa, 15, cfg)
        torch.cuda.synchronize()
        for r, g in zip(ref, got):
            assert torch.equal(r, g)


def _random_msgs(rs, I, M, cfg):
    L, NT = cfg.lanes, cfg.n_total
    msgs = np.zeros((I, M, L), dtype=np.int32)
    v = rs.random_sample((I, M)) < 0.7
    msgs[..., wire.VALID] = v
    msgs[..., wire.SRC] = rs.randint(0, NT, (I, M))
    msgs[..., wire.DEST] = rs.randint(0, NT, (I, M))
    msgs[..., wire.ORIGIN] = rs.randint(0, NT, (I, M))
    msgs[..., wire.TYPE] = rs.randint(1, 14, (I, M))
    msgs[..., wire.BODY:] = rs.randint(-5, 100, (I, M, L - wire.BODY))
    return msgs


@pytest.mark.parametrize("dist,p_loss", [(2, 0.05), (2, 0.0), (1, 0.2),
                                         (0, 0.0)])
def test_enqueue_matches_xla(dist, p_loss):
    n, c, S, K, body, I = SHAPES["flagship"]
    cfg, jcfg = _cfgs(n, c, S, K, body, dist=dist, p_loss=p_loss)
    rs = np.random.RandomState(11)
    pools, _ = random_pools(rs, I, cfg, fill=0.4)
    M = 21
    msgs = _random_msgs(rs, I, M, cfg)
    jkeys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(3), i))(
        jnp.arange(I))
    for t in (0, 40):
        ref = jax.vmap(lambda p, m, k: jnetsim.enqueue(
            p, m, jnp.int32(t), k, jcfg))(jnp.asarray(pools),
                                          jnp.asarray(msgs), jkeys)
        got = netsim.enqueue(torch.from_numpy(pools.copy()),
                             torch.from_numpy(msgs.copy()), t,
                             torch.from_numpy(np.asarray(jkeys)
                                              .astype(np.int64)), cfg)
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(np.asarray(r), g.numpy())


def test_pool_occupancy_matches_xla():
    cfg, _ = _cfgs(*SHAPES["flagship"][:5])
    pools, _ = random_pools(np.random.RandomState(2), 16, cfg)
    np.testing.assert_array_equal(
        np.asarray(jnetsim.pool_occupancy(jnp.asarray(pools))),
        netsim.pool_occupancy(torch.from_numpy(pools)).numpy())
