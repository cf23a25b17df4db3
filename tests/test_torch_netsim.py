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
from maelstrom_tpu_torch.kernels import delivery, delivery_cases

from torch_tutorial_cases import one_torch_thread  # noqa: F401 (autouse)

# (n_nodes, n_clients, S, K, body_lanes, I): the Pallas test shape, the
# flagship lin-kv shape, the widest defaults (S=128, K=8), the txn
# and kafka fleets' rows (L = 66, 26, and 32 with NT = 7), and the lin-kv
# mutants' bug hunt (S=128, K=8, NT=6)
SHAPES = {
    "pallas-test": (3, 3, 32, 4, 6, 8),
    "flagship": (3, 6, 16, 1, 12, 64),
    "wide": (3, 6, 128, 8, 12, 8),
    "txn-list-append": (3, 6, 16, 1, 58, 8),
    "txn-rw-register": (3, 6, 16, 1, 18, 8),
    "kafka": (1, 6, 16, 1, 24, 8),
    "bug-hunt": (3, 3, 128, 8, 12, 8),
}
# edge-case pools (kernels/delivery_cases.py) at the shapes chip_smoke.py
# puts them through the kernel
EDGE_SHAPES = delivery_cases.EDGE_SHAPES
EDGE_CASES = ("empty", "full", "same-dtick", "out-of-range",
              "all-partitioned", "few-candidates", "priority-wrap")
EDGE_PARAMS = [(shape, case) for shape in sorted(EDGE_SHAPES)
               for case in EDGE_CASES
               + (("priority-tie",) if shape == "odd" else ())]
# The Pallas kernel reads an out-of-range DEST/ORIGIN as "not blocked"
# (its one-hot lookup matches no endpoint) and takes every slot of a
# priority tie at once; vmap(netsim.deliver), the contract, does
# neither, so those two cases are held against it alone.
PALLAS_DIFFERS = ("out-of-range", "priority-tie")


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


@pytest.mark.parametrize("shape", ["pallas-test", "flagship",
                                   "txn-list-append", "txn-rw-register",
                                   "kafka"])
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


def _edge(shape, case, I=None):
    n, c, S, K, body, I0 = EDGE_SHAPES[shape]
    cfg, jcfg = _cfgs(n, c, S, K, body)
    pools, parts, t = delivery_cases.edge_pools(cfg, I or I0, seed=3)[case]
    return cfg, jcfg, pools, parts, t


@pytest.mark.parametrize("shape,case", EDGE_PARAMS)
def test_deliver_edge_cases_match_xla(shape, case):
    cfg, jcfg, pools, parts, t = _edge(shape, case)
    ref = jax.vmap(lambda p, pa: jnetsim.deliver(p, pa, jnp.int32(t),
                                                 jcfg))(
        jnp.asarray(pools), jnp.asarray(parts))
    got = _port_deliver(pools, parts, t, cfg)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r), g)


@pytest.mark.parametrize("shape,case", [
    (shape, case) for shape, case in EDGE_PARAMS
    if case not in PALLAS_DIFFERS])
def test_deliver_edge_cases_match_pallas_interpret(shape, case):
    cfg, jcfg, pools, parts, t = _edge(shape, case, I=4)
    ref = deliver_pallas(jnp.asarray(pools), jnp.asarray(parts),
                         jnp.int32(t), jcfg, interpret=True)
    got = _port_deliver(pools, parts, t, cfg)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r), g)


@pytest.mark.parametrize("case", EDGE_CASES)
def test_deliver_minor_edge_shapes_match_xla(case):
    """The batch-last entry (its plain version here) against
    ``vmap(netsim.deliver)`` at the shapes only it takes: rows too wide
    for the kernel's shared memory (the lead kernel refuses them)."""
    n, c, S, K, body, I = delivery_cases.MINOR_EDGE_SHAPES["unstaged"]
    cfg, jcfg = _cfgs(n, c, S, K, body)
    pools, parts, t = delivery_cases.edge_pools(cfg, I, seed=3)[case]
    with pytest.raises(ValueError):
        delivery.geometry(S, cfg.lanes, cfg.n_total, K, False)
    ref = jax.vmap(lambda p, pa: jnetsim.deliver(p, pa, jnp.int32(t),
                                                 jcfg))(
        jnp.asarray(pools), jnp.asarray(parts))
    got = delivery.deliver_minor(
        torch.from_numpy(pools).movedim(0, -1).contiguous(),
        torch.from_numpy(parts), t, cfg)
    np.testing.assert_array_equal(np.asarray(ref[0]),
                                  got[0].movedim(-1, 0).numpy())
    for r, g in zip(ref[1:], got[1:]):
        np.testing.assert_array_equal(np.asarray(r), g.numpy())


def test_edge_cases_reach_their_rules():
    """Each edge pool exercises what its name says (plain version)."""
    n, c, S, K, body, I = EDGE_SHAPES["odd"]
    cfg, _ = _cfgs(n, c, S, K, body)
    out = {case: _port_deliver(p, pa, t, cfg) for case, (p, pa, t)
           in delivery_cases.edge_pools(cfg, I, seed=3).items()}
    assert out["empty"][2].sum() == 0 and out["empty"][3].sum() == 0
    assert (out["all-partitioned"][2] == 0).all()
    assert (out["all-partitioned"][3] == S).all()
    # full: every slot due, so what stays is candidates beyond K
    assert (out["full"][2] > 0).all()
    assert (out["full"][0][..., wire.VALID] == 1).any()
    assert (out["few-candidates"][2] == cfg.n_total).all()
    # priority-wrap: due slots with priority <= 0 stay in the pool
    assert (out["priority-wrap"][0][..., wire.VALID] == 1).any()
    # priority-tie: slots 0, 8, 16 tie and are taken in slot order
    tie_rows = out["priority-tie"][1][:, 0, :, wire.DTICK]
    tie_dticks = delivery_cases.edge_pools(cfg, I, seed=3)[
        "priority-tie"][0][:, [0, 8, 16], wire.DTICK]
    np.testing.assert_array_equal(tie_rows, tie_dticks[:, :K])


@pytest.mark.parametrize("vec", [True, False])
def test_deliver_geometry(vec):
    """Every S in 1..256, K in 1..8 and L in 9..64 gets a launch with
    blocks, a padded row stride (odd in 16-byte units, or in words on
    the 4-byte path) and shared memory within the card's limit."""
    for S in range(1, delivery.MAX_SLOTS + 1):
        for K in range(1, min(8, S) + 1):
            for L in range(9, 65):
                if vec and L % 4:
                    continue
                geo = delivery.geometry(S, L, 9, K, vec)
                assert 1 <= geo.warps_per_block <= 4    # >= 1 block
                assert geo.row_stride >= L and geo.warp_bytes % 16 == 0
                assert geo.warp_bytes >= S * geo.row_stride * 4 + 8 * S
                assert geo.warp_bytes * geo.warps_per_block \
                    <= delivery.SMEM_OPTIN_BYTES
                unit = 4 if vec else 1
                assert geo.row_stride % unit == 0
                assert (geo.row_stride // unit) % 2 == 1
    for bad in ((0, 20, 9, 1), (257, 20, 9, 1), (8, 20, 9, 9),
                (8, 7, 9, 1)):
        with pytest.raises(ValueError):
            delivery.geometry(*bad, vec=False)


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("NT", [7, 9, 50])
def test_deliver_minor_geometry(NT, vec):
    """Every S in 1..256, K in 1..8 and L in 8..66 (and 120, 228) gets a
    batch-last launch: W in {1, 2, 4, 8}, a block within the card's
    shared memory, a staged slot stride padded to an odd number of
    16-byte units (of words on the 4-byte path), 16-byte units only at W
    >= 4 and staged; where one instance's rows do not fit, the unstaged
    branch, not a refusal. The timed shapes get W = 8; shapes outside the contract
    raise."""
    for S in range(1, delivery.MAX_SLOTS + 1):
        for K in range(1, min(8, S) + 1):
            for L in list(range(8, 67)) + [120, 228]:
                geo = delivery.minor_geometry(S, L, NT, K, vec)
                W = geo.instances
                assert W in (1, 2, 4, 8)
                assert geo.smem_bytes % 16 == 0
                assert geo.smem_bytes <= delivery.SMEM_OPTIN_BYTES
                assert geo.vec == (vec and W % 4 == 0 and geo.staged)
                rows = 4 * S * L     # one instance's rows
                if not geo.staged:
                    assert geo.slot_stride == 0
                    assert rows > delivery.SMEM_OPTIN_BYTES - 16 * 1024
                    continue
                assert geo.smem_bytes >= S * geo.slot_stride * 4
                assert geo.slot_stride >= L * W
                unit = 4 if geo.vec else 1
                assert geo.slot_stride % unit == 0
                assert (geo.slot_stride // unit) % 2 == 1
                if W < 8:    # only where twice W's rows are wide
                    assert 2 * W * rows > 2 * delivery.SMEM_OPTIN_BYTES // 3
    for name in delivery_cases.TIMED:
        n, c, S, K, body, I = delivery_cases.SHAPES[name]
        cfg = delivery_cases.net_config(n, c, S, K, body)
        geo = delivery.minor_geometry(S, cfg.lanes, cfg.n_total, K,
                                      vec and I % 4 == 0)
        assert geo.instances == 8 and geo.staged, name
    n, c, S, K, body, I = delivery_cases.MINOR_EDGE_SHAPES["unstaged"]
    cfg = delivery_cases.net_config(n, c, S, K, body)
    geo = delivery.minor_geometry(S, cfg.lanes, cfg.n_total, K, vec)
    assert not geo.staged and geo.slot_stride == 0
    for bad in ((0, 20, NT, 1), (257, 20, NT, 1), (8, 20, NT, 9),
                (8, 7, NT, 1), (8, 20, 0, 1)):
        with pytest.raises(ValueError):
            delivery.minor_geometry(*bad, vec=vec)


def test_deliver_wrapper_counts_no_cpu_launch():
    """On a CPU tensor the wrapper runs the plain version: no launch."""
    cfg, _ = _cfgs(*SHAPES["flagship"][:5])
    pools, parts = random_pools(np.random.RandomState(3), 4, cfg)
    before = delivery.deliver.launches
    _port_deliver(pools, parts, 10, cfg)
    assert delivery.deliver.launches == before


@pytest.mark.parametrize("sessions,want", [
    ([[2.0] * 200], 2.0),                       # every record kept
    ([[2.0] * 182, [4.0] * 200], (182 * 2.0 + 200 * 4.0) / 382),
    ([[1.0] * 30] * 5, None),                   # too few in 5 sessions
    ([[1.0] * 201], None),                      # more kernels than calls
])
def test_device_ms_repeats_sessions_that_lost_records(monkeypatch,
                                                      sessions, want):
    """device_ms averages over at least ``iters`` recorded launches,
    running further profiling sessions where CUPTI lost records, and
    refuses a name that matches more kernels than calls."""
    from maelstrom_tpu_torch.kernels import devtime
    left = list(sessions)
    monkeypatch.setattr(devtime.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(devtime.torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(devtime, "_session_us",
                        lambda fn, name, iters, flush: left.pop(0))
    call = lambda: None
    if want is None:
        with pytest.raises(RuntimeError, match="device_ms"):
            devtime.device_ms(call, "k", 200, flush_l2=False)
        return
    got = devtime.device_ms(call, "k", 200, flush_l2=False)
    assert got == pytest.approx(want / 1e3, rel=1e-12)
    assert not left


@pytest.mark.cuda
def test_deliver_kernel_matches_reference_on_card():
    """The CUDA kernel against its plain version on the card (bit-equal)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the delivery kernel has "
                    "no CPU or interpret mode")
    inputs = []
    for shape in sorted(SHAPES):
        n, c, S, K, body, I = SHAPES[shape]
        cfg, _ = _cfgs(n, c, S, K, body)
        pools, parts = random_pools(np.random.RandomState(5), I, cfg)
        inputs.append((shape, cfg, pools, parts, 15))
    for shape, case in EDGE_PARAMS:
        cfg, _, pools, parts, t = _edge(shape, case)
        inputs.append((f"{shape}/{case}", cfg, pools, parts, t))
    for name, cfg, pools, parts, t in inputs:
        p = torch.from_numpy(pools).cuda()
        pa = torch.from_numpy(parts).cuda()
        got = delivery.deliver(p, pa, t, cfg)
        ref = netsim.deliver_reference(p, pa, t, cfg)
        torch.cuda.synchronize()
        for r, g in zip(ref, got):
            assert torch.equal(r, g), name


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
