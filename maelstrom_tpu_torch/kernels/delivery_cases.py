"""What the delivery kernel is checked and timed on: its shapes, seeded
random pools, edge-case pools that reach every rule of the delivery
contract (numpy, so the tests can hand the same arrays to the JAX
package), and the least time the card could take for a round.

    SHAPES[name], EDGE_SHAPES[name], MINOR_EDGE_SHAPES[name]
        -> (n_nodes, n_clients, S, K, body_lanes, I)
    random_pools(rs, I, cfg) -> (pools [I, S, L] int32, parts [I, NT, NT])
    edge_pools(cfg, I, seed) -> {name: (pools, parts, t)}
    bound(pool, parts, t, cfg) -> (ms, "bytes" | "operations", bytes, ops)
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .. import wire
from ..netsim import NetConfig, jax_index

INT32_MAX = 2**31 - 1

# the Pallas kernel's test shape (checked only), the flagship lin-kv run
# (the main path), the CLI defaults S=128, K=8, the guide's 25-node
# broadcast fleet (S=256, K=8, NT=50, L=10: the 4-byte path), the
# txn-list-append fleet (L=66: the 4-byte path at an odd row stride) and
# the kafka fleet (NT=7, L=32: the 16-byte path) (timed), and the
# txn-rw-register fleet (L=26, checked only). A journaling run's rows
# carry the trailing NETID lane, one lane past the body (``wire.lanes(
# body, netid=True)``); the kernel knows no lanes but L, so its NETID
# shapes are written with one more body lane: the journaled bug hunt
# (L = 21, the 4-byte path; timed); and the bench's other two configs
# (bench.py's k1-16k: the flagship at 16,384 instances; k3: inbox_k 3,
# 48 slots; timed)
SHAPES = {"pallas-test": (3, 3, 32, 4, 6, 8),
          "flagship": (3, 6, 16, 1, 12, 4096),
          "k1-16k": (3, 6, 16, 1, 12, 16384),
          "k3": (3, 6, 48, 3, 12, 4096),
          "defaults": (3, 6, 128, 8, 12, 4096),
          "broadcast-25": (25, 25, 256, 8, 2, 4096),
          "txn-list-append": (3, 6, 16, 1, 58, 4096),
          "kafka": (1, 6, 16, 1, 24, 4096),
          "txn-rw-register": (3, 6, 16, 1, 18, 4096),
          "bug-hunt": (3, 3, 128, 8, 12, 4096),
          "bug-hunt-netid": (3, 3, 128, 8, 13, 4096)}
TIMED = ("flagship", "k1-16k", "k3", "defaults", "broadcast-25",
         "txn-list-append", "kafka", "bug-hunt", "bug-hunt-netid")
# edge-case pools go through the kernel at small I: the shapes above, an
# S that is no power of two, where wrapped priorities can tie, and the
# tutorial workloads' rows on the 4-byte path (L = 9, 10, 14), and the
# NETID rows of the flagship (L = 21) and of kafka (L = 33: off the
# 16-byte path), and the shape of the forget-snapshot fuzz run that
# chip_smoke.py's phase 10 shrinks (S = 24, K = 2, NT = 7), and 37
# instances, a multiple of neither the batch-last kernel's tile of 8 nor
# 4 (its 4-byte path and a partial last tile)
EDGE_SHAPES = {"pallas-test": (3, 3, 32, 4, 6, 8),
               "flagship": (3, 6, 16, 1, 12, 64),
               "defaults": (3, 6, 128, 8, 12, 64),
               "odd": (3, 3, 24, 3, 6, 8),
               "broadcast-25": (25, 25, 256, 8, 2, 16),
               "unique-ids": (3, 6, 16, 1, 1, 64),
               "g-set": (3, 6, 16, 1, 2, 64),
               "pn-counter": (3, 6, 16, 1, 6, 64),
               "txn-list-append": (3, 6, 16, 1, 58, 64),
               "kafka": (1, 6, 16, 1, 24, 64),
               "txn-rw-register": (3, 6, 16, 1, 18, 64),
               "bug-hunt": (3, 3, 128, 8, 12, 64),
               "flagship-netid": (3, 6, 16, 1, 13, 64),
               "kafka-netid": (1, 6, 16, 1, 25, 64),
               "bug-hunt-netid": (3, 3, 128, 8, 13, 64),
               "fuzz-shrink": (3, 4, 24, 2, 12, 64),
               "ragged": (3, 6, 16, 1, 12, 37)}
# edge shapes of the batch-last entry alone: 256 slots of L = 228 (a
# many-node CRDT fleet's body of 2 * n_nodes lanes), where not even one
# instance's rows fit in shared memory (its unstaged branch); the lead
# kernel's geometry refuses them
MINOR_EDGE_SHAPES = {"unstaged": (3, 6, 256, 1, 220, 9)}

# the card's peak rates (NVIDIA's H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12   # non-tensor-core 32-bit rate (FP32 figure)


def net_config(n: int, c: int, S: int, K: int, body: int) -> NetConfig:
    return NetConfig(n_nodes=n, n_clients=c, pool_slots=S, inbox_k=K,
                     body_lanes=body, latency_mean=5.0, latency_dist=2,
                     p_loss=0.0)


def bound(pool: torch.Tensor, parts: torch.Tensor, t: int, cfg: NetConfig):
    """``(bound_ms, bound_by, bytes, ops)`` of one delivery round on
    these inputs: each input read once (pool, partition plane), each
    output written once (pool', inbox, two counts); about 20 integer
    operations to classify a slot and 6 to compare two eligible slots of
    one instance (the rank selection: ``E**2`` compares for ``E``
    eligible slots, counted from these inputs)."""
    I, S, L = pool.shape
    NT, K = cfg.n_total, cfg.inbox_k
    nbytes = 2 * I * S * L * 4 + I * NT * K * L * 4 + I * NT * NT \
        + 2 * I * 4
    valid = pool[..., wire.VALID] == 1
    dtick = pool[..., wire.DTICK]
    dest = pool[..., wire.DEST]
    blocked = parts.reshape(I, NT * NT).gather(
        1, jax_index(dest, NT) * NT + jax_index(pool[..., wire.ORIGIN], NT))
    slot = torch.arange(S, dtype=torch.int32, device=pool.device)
    prio = ((1 << 20) - dtick) * S + (S - slot)
    elig = (valid & (dtick <= t) & ~blocked & (dest >= 0) & (dest < NT)
            & (prio > 0))
    n_elig = elig.sum(dim=1).double()
    ops = 20 * I * S + 6 * int((n_elig ** 2).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def random_pools(rs: np.random.RandomState, I: int, cfg, fill: float = 0.6,
                 max_dtick: int = 30) -> Tuple[np.ndarray, np.ndarray]:
    """Pools with a share ``fill`` of slots occupied, in-range endpoints,
    DTICK in ``[0, max_dtick)``, and a quarter of the edges cut."""
    S, L, NT = cfg.pool_slots, cfg.lanes, cfg.n_total
    pools = np.zeros((I, S, L), np.int32)
    occ = rs.random_sample((I, S)) < fill
    pools[..., wire.VALID] = occ
    for lane, hi in ((wire.SRC, NT), (wire.DEST, NT), (wire.ORIGIN, NT),
                     (wire.DTICK, max_dtick), (wire.TYPE, 14)):
        pools[..., lane] = rs.randint(0, hi, (I, S)) * occ
    pools[..., wire.BODY:] = rs.randint(0, 100, (I, S, L - wire.BODY)) \
        * occ[..., None]
    parts = rs.random_sample((I, NT, NT)) < 0.25
    return pools, parts


def _wrap_dticks(rs, I, S):
    """DTICKs whose int32 priority ((1 << 20) - DTICK) * S + (S - slot)
    wraps: just past 1 << 20 (priority <= 0), near INT32_MIN (the
    product wraps), far below zero, and plain small ones."""
    choices = np.array([(1 << 20) - 1, 1 << 20, (1 << 20) + 1,
                        (1 << 20) + 7, -(2**31), -(2**31) + 12345,
                        -(2**30), -(2**28), 2**30, INT32_MAX, 3, 0],
                       np.int64)
    return choices[rs.randint(0, len(choices), (I, S))].astype(np.int32)


def _tie_dticks(I, S):
    """For S that is no power of two: slots 0, g, 2g, ... (g the largest
    power of two dividing S) get DTICKs 0, x, 2x, ... with S * x == -g
    (mod 2**32), so each wraps to slot 0's priority (as far as the DTICKs
    stay in int32); every other slot gets DTICK 0 and a lower priority."""
    g = S & -S
    m = 2**32 // g
    x = -pow(S // g, -1, m) % m
    dt = np.zeros((I, S), np.int64)
    for n, s in enumerate(range(0, S, g)):
        if n * x <= INT32_MAX:
            dt[:, s] = n * x
    return dt.astype(np.int32)


def edge_pools(cfg, I: int, seed: int = 0
               ) -> Dict[str, Tuple[np.ndarray, np.ndarray, int]]:
    """Edge-case delivery inputs at shape ``cfg`` with ``I`` instances:

    - ``empty``: no valid slot;
    - ``full``: every slot valid and due, far more candidates than K;
    - ``same-dtick``: one DTICK for every slot (slot order decides);
    - ``out-of-range``: DEST and ORIGIN negative or >= NT, VALID other
      than 0/1 (JAX index reading; a bad DEST is never delivered);
    - ``all-partitioned``: every edge cut, every due slot dropped;
    - ``few-candidates``: at most one valid slot per endpoint, K > 1
      leaves zero rows;
    - ``priority-wrap``: t = INT32_MAX and DTICKs whose priority wraps
      to <= 0 (never taken, never cleared) or around to > 0;
    - ``priority-tie`` (S no power of two only): equal wrapped
      priorities, taken lower slot first.
    """
    S, L, NT = cfg.pool_slots, cfg.lanes, cfg.n_total
    rs = np.random.RandomState(seed)
    cases = {}

    def body(pools, occ):
        pools[..., wire.SRC] = rs.randint(0, NT, (I, S)) * occ
        pools[..., wire.TYPE] = rs.randint(1, 14, (I, S)) * occ
        pools[..., wire.BODY:] = rs.randint(
            -50, 1000, (I, S, L - wire.BODY)) * occ[..., None]

    def full_pool(dtick, dest=None, origin=None, occ=None):
        pools = np.zeros((I, S, L), np.int32)
        occ = np.ones((I, S), bool) if occ is None else occ
        pools[..., wire.VALID] = occ
        pools[..., wire.DEST] = (rs.randint(0, NT, (I, S)) if dest is None
                                 else dest) * occ
        pools[..., wire.ORIGIN] = (rs.randint(0, NT, (I, S))
                                   if origin is None else origin) * occ
        pools[..., wire.DTICK] = dtick * occ
        body(pools, occ)
        return pools

    some_parts = rs.random_sample((I, NT, NT)) < 0.3
    no_parts = np.zeros((I, NT, NT), bool)

    cases["empty"] = (np.zeros((I, S, L), np.int32), some_parts, 15)
    cases["full"] = (full_pool(rs.randint(0, 16, (I, S))), some_parts, 20)
    cases["same-dtick"] = (full_pool(np.full((I, S), 5)), no_parts, 10)

    bad = np.array([-NT - 3, -NT, -1, NT, NT + 5, INT32_MAX, -(2**31)],
                   np.int64)
    mix = lambda: np.where(rs.random_sample((I, S)) < 0.5,
                           bad[rs.randint(0, len(bad), (I, S))],
                           rs.randint(0, NT, (I, S))).astype(np.int32)
    pools = full_pool(rs.randint(0, 16, (I, S)), dest=mix(), origin=mix())
    pools[..., wire.VALID] = rs.choice([0, 1, 1, 1, 2, -1], (I, S))
    cases["out-of-range"] = (pools, some_parts, 12)

    cases["all-partitioned"] = (full_pool(rs.randint(0, 16, (I, S))),
                                np.ones((I, NT, NT), bool), 20)

    occ = np.zeros((I, S), bool)
    dest = np.zeros((I, S), np.int64)
    for i in range(I):
        slots = rs.permutation(S)[:min(S, NT)]
        occ[i, slots] = True
        dest[i, slots] = rs.permutation(NT)[:len(slots)]
    cases["few-candidates"] = (full_pool(rs.randint(0, 8, (I, S)),
                                         dest=dest, occ=occ), no_parts, 10)

    cases["priority-wrap"] = (full_pool(_wrap_dticks(rs, I, S)),
                              some_parts, INT32_MAX)

    if S & (S - 1):
        # every slot to endpoint 0, so the tied slots compete
        cases["priority-tie"] = (
            full_pool(_tie_dticks(I, S), dest=np.zeros((I, S), np.int64)),
            no_parts, INT32_MAX)
    return cases
