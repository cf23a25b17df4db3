"""The simulated network on the device: a fixed pool of ``S`` message
slots per instance, delivered and refilled every tick.

Counterpart of ``maelstrom_tpu/tpu/netsim.py``, written over the whole
``[I, ...]`` instance batch instead of one instance under ``vmap``:

- :func:`deliver_reference` hands every endpoint up to ``K`` due,
  unblocked messages, oldest deadline first, drops due messages whose
  ``(dest, origin)`` edge is partitioned, and clears both from the
  pool. It is the plain version of the CUDA delivery kernel
  (``kernels/delivery.py``), which the tick loop calls.
- :func:`enqueue` places newly sent rows into free slots with a sampled
  latency deadline and probabilistic loss (zero latency on client
  links); pool overflow drops and counts.

Both are bit-identical to ``vmap`` of their JAX counterparts: the
stable empty-slots-first ``argsort``, first-maximum ``argmax``, the
lower-index-first order of ``lax.top_k`` among equal priorities, JAX's
reading of a negative or too large DEST/ORIGIN index, and the zero rows
of non-taken inbox slots are matched exactly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import rng, wire, xla_math

LATENCY_CONSTANT = 0
LATENCY_UNIFORM = 1
LATENCY_EXPONENTIAL = 2

LATENCY_DISTS = {"constant": LATENCY_CONSTANT, "uniform": LATENCY_UNIFORM,
                 "exponential": LATENCY_EXPONENTIAL}


class NetConfig(NamedTuple):
    """Static network parameters."""
    n_nodes: int            # server nodes
    n_clients: int
    pool_slots: int         # S
    inbox_k: int            # max deliveries per endpoint per tick
    body_lanes: int
    latency_mean: float     # mean latency in ticks
    latency_dist: int       # LATENCY_* enum
    p_loss: float
    netid: bool = False     # rows carry the trailing NETID lane (runs
                            # that record per-message journals)

    @property
    def n_total(self) -> int:
        return self.n_nodes + self.n_clients

    @property
    def lanes(self) -> int:
        return wire.lanes(self.body_lanes, self.netid)

    @property
    def netid_lane(self) -> int:
        """Index of the trailing NETID lane (netid formats only)."""
        return wire.netid_lane(self.lanes)

    @property
    def wire_format(self) -> dict:
        return wire.format_desc(self.body_lanes, self.netid)


class NetStats(NamedTuple):
    """Fleet counters: int32 scalars, wrapping like the JAX carry's."""
    sent: torch.Tensor
    delivered: torch.Tensor
    dropped_partition: torch.Tensor
    dropped_loss: torch.Tensor
    dropped_overflow: torch.Tensor

    @staticmethod
    def zeros(device=None) -> "NetStats":
        return NetStats(*(torch.zeros((), dtype=torch.int32, device=device)
                          for _ in range(5)))


def sum_i32(x: torch.Tensor, dim=None) -> torch.Tensor:
    """An int32 sum that wraps on overflow, as ``jnp.sum`` on int32."""
    s = x.sum() if dim is None else x.sum(dim=dim)
    return s.to(torch.int32)


def pool_occupancy(pool: torch.Tensor) -> torch.Tensor:
    """Occupied slot count per instance: ``[..., S, L] -> [...]``."""
    return sum_i32(pool[..., wire.VALID] & 1, dim=-1)


def jax_index(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` as JAX's integer indexing reads it along an axis of size
    ``n``: a negative index counts from the end, then it is clamped."""
    x = x.long()
    return torch.where(x < 0, x + n, x).clamp(0, n - 1)


def deliver_reference(pool: torch.Tensor, partitions: torch.Tensor, t: int,
                      cfg: NetConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """One delivery round for the batch, in plain PyTorch.

    ``pool [I, S, L]`` int32, ``partitions [I, NT, NT]`` bool
    (``partitions[i, dest, src]`` True = dest refuses src). Returns
    ``(pool', inbox [I, NT, K, L], n_delivered [I], n_dropped [I])``."""
    I, S, L = pool.shape
    NT, K = cfg.n_total, cfg.inbox_k
    dev = pool.device
    valid = pool[..., wire.VALID] == 1
    dtick = pool[..., wire.DTICK]
    due = valid & (dtick <= t)
    dest = jax_index(pool[..., wire.DEST], NT)
    origin = jax_index(pool[..., wire.ORIGIN], NT)
    blocked = partitions.reshape(I, NT * NT).gather(1, dest * NT + origin)
    drop_mask = due & blocked

    node_ids = torch.arange(NT, dtype=torch.int32, device=dev)
    cand = ((due & ~blocked)[:, None, :]
            & (pool[..., wire.DEST][:, None, :] == node_ids[None, :, None]))
    slot_order = torch.arange(S, dtype=torch.int32, device=dev)
    age_rank = ((1 << 20) - dtick) * S
    prio = torch.where(cand, (age_rank + (S - slot_order))[:, None, :], 0)
    if K == 1:
        topi = prio.argmax(dim=2, keepdim=True)               # [I, NT, 1]
        topv = prio.gather(2, topi)
    else:
        # lower slot first among equal priorities, as lax.top_k (they
        # tie only where the int32 priority wraps and S is no power of 2)
        topv, topi = prio.sort(dim=2, descending=True, stable=True)
        topv, topi = topv[..., :K], topi[..., :K]             # [I, NT, K]
    take = topv > 0
    rows = pool.gather(1, topi.reshape(I, NT * K, 1).expand(I, NT * K, L))
    inbox = torch.where(take.reshape(I, NT * K, 1), rows, 0
                        ).reshape(I, NT, K, L)

    # slot s is taken iff some (endpoint, k) took it; non-taken picks
    # aim at the spill column S
    taken = (torch.zeros((I, S + 1), dtype=torch.int32, device=dev)
             .scatter_add_(1, torch.where(take, topi,
                                          torch.full_like(topi, S))
                           .reshape(I, NT * K),
                           torch.ones((I, NT * K), dtype=torch.int32,
                                      device=dev)))[:, :S] > 0
    cleared = taken | drop_mask
    pool_out = torch.where(cleared[..., None], 0, pool)
    return (pool_out, inbox, sum_i32(take, dim=(1, 2)),
            sum_i32(drop_mask, dim=1))


def latency_from_bits(bits: torch.Tensor, cfg: NetConfig) -> torch.Tensor:
    """Per-message latency ticks (int32) from the latency key's 32-bit
    draws ``bits [..., n]`` (``random_bits(k_lat, (n,))``)."""
    if cfg.latency_mean <= 0:
        return torch.zeros(bits.shape, dtype=torch.int32, device=bits.device)
    if cfg.latency_dist == LATENCY_CONSTANT:
        return torch.full(bits.shape, round(cfg.latency_mean),
                          dtype=torch.int32, device=bits.device)
    u = rng.uniform_from_bits(bits, minval=1e-6, maxval=1.0)
    if cfg.latency_dist == LATENCY_UNIFORM:
        lat = u * xla_math.f32(2.0 * cfg.latency_mean)
    else:  # exponential
        lat = xla_math.log(u) * xla_math.f32(-cfg.latency_mean)
    return lat.to(torch.int32)


def enqueue(pool: torch.Tensor, msgs: torch.Tensor, t: int,
            key: torch.Tensor, cfg: NetConfig,
            edge_delay: Optional[torch.Tensor] = None,
            edge_loss_pm: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor]:
    """Insert outgoing rows ``msgs [I, M, L]`` (invalid rows ignored)
    into ``pool [I, S, L]`` with keys ``[I, 2]``. Returns
    ``(pool', n_sent [I], n_lost [I], n_overflow [I])``.

    ``edge_delay`` / ``edge_loss_pm`` are the fault engine's link planes
    ``[I, NT, NT]`` per ``(dest, origin)`` edge: extra latency ticks and
    a per-mille loss rolled on its own key ``fold_in(key, 2)``, so the
    base draws stay as they are; zero planes are value-neutral.

    Slot ``j`` of the empty-slots-first order receives the ``j``-th live
    message; each slot gathers the one message aimed at it, as in the
    JAX placement."""
    I, M, L = msgs.shape
    S = cfg.pool_slots
    dev = pool.device
    msg_valid = msgs[..., wire.VALID] == 1

    # k_lat, k_loss = split(key) and the edge-loss key fold_in(key, 2)
    # are split(key, 3)'s blocks: every draw of M values in one call
    n_keys = 2 if edge_loss_pm is None else 3
    bits = rng.random_bits(rng.split(key, n_keys), (M,))     # [I, n, M]
    is_client_edge = ((msgs[..., wire.ORIGIN] >= cfg.n_nodes)
                      | (msgs[..., wire.DEST] >= cfg.n_nodes))
    lat = latency_from_bits(bits[:, 0], cfg)
    lat = torch.where(is_client_edge, torch.zeros_like(lat), lat)
    if edge_delay is not None or edge_loss_pm is not None:
        NT = cfg.n_total
        edge = (jax_index(msgs[..., wire.DEST], NT) * NT
                + jax_index(msgs[..., wire.ORIGIN], NT))       # [I, M]
    if edge_delay is not None:
        lat = lat + edge_delay.reshape(I, -1).gather(1, edge)
    dtick = (t + 1 + lat).to(torch.int32)

    if cfg.p_loss > 0:
        lost = (rng.uniform_from_bits(bits[:, 1])
                < xla_math.f32(cfg.p_loss)) & msg_valid
    else:
        lost = torch.zeros((I, M), dtype=torch.bool, device=dev)
    if edge_loss_pm is not None:
        pm = edge_loss_pm.reshape(I, -1).gather(1, edge)
        lost = lost | ((rng.uniform_from_bits(bits[:, 2])
                        * xla_math.f32(1000.0) < pm.to(torch.float32))
                       & msg_valid)
    live = msg_valid & ~lost

    pool_valid = pool[..., wire.VALID] == 1
    order = torch.argsort(pool_valid.to(torch.int32), dim=1, stable=True)
    free_count = (~pool_valid).sum(dim=1, keepdim=True)
    live_order = torch.argsort((~live).to(torch.int32), dim=1, stable=True)
    live_c = live.gather(1, live_order)
    n_live = live.sum(dim=1)

    j = torch.arange(M, device=dev)
    can_place = live_c & (j[None, :] < free_count)
    target = torch.where(can_place,
                         order.gather(1, j.clamp(max=S - 1)[None, :]
                                      .expand(I, M)), S)
    hit = target[:, None, :] == torch.arange(S, device=dev)[None, :, None]
    has = hit.any(dim=2)                                      # [I, S]
    src = hit.to(torch.int32).argmax(dim=2)                   # [I, S]
    msg_src = live_order.gather(1, src)
    placed = msgs.gather(1, msg_src[..., None].expand(I, S, L)).clone()
    placed[..., wire.DTICK] = dtick.gather(1, msg_src)
    pool = torch.where(has[..., None], placed, pool)
    n_placed = can_place.sum(dim=1)
    return (pool, sum_i32(msg_valid, dim=1), sum_i32(lost, dim=1),
            (n_live - n_placed).to(torch.int32))
