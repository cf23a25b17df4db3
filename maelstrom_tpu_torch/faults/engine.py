"""The device side of the fault-plan engine, over the instance batch.

Counterpart of ``maelstrom_tpu/faults/engine.py``. :class:`FaultConfig`
is the compiled, hashable form of a fault plan (the same tuples as the
JAX package's): a phase timeline (``untils``) plus, per phase, the
crash victims, the degraded directed edges, the per-node clock rates
and the member sets. The phases are baked once into device tables (one
row per phase plus a trailing all-healthy row, :func:`plan_tables`);
the tick's ``t`` is a Python int, so :func:`tick_planes` finds the phase
on the host and hands out views of its rows, broadcast over instances.

Lane semantics (as in the JAX engine):

- ``crash`` — victims are held in reset for the whole phase: every
  crashed tick the node row is rebuilt through ``Model.restart_row``
  from the snapshot slab (its durable storage), delivery TO the victim
  is blocked through the partition plane, and its emitted rows are
  invalidated before enqueue. The slab takes ``Model.snapshot_row`` of
  every node not held, each ``snapshot_every`` ticks.
- ``links`` — per directed ``(dest, origin)`` edge: ``block`` folds into
  the partition plane, ``delay`` adds ticks to the sampled latency,
  ``loss_pm`` is an extra per-mille loss roll. Zero is neutral.
- ``skew`` — per-node clock rate in 64ths: the node phase runs each
  node's timers on ``(t * rate) // 64``; rate 64 is exactly ``t``.
- ``membership`` — a per-phase member set: non-members are parked like
  crash victims and held at ``Model.join_row`` of their slab row; the
  tick a node's membership turns on is a join, and the member bitmask
  (``m_bits``) is the reconfiguration target of the node step.

Every plane here carries a leading instance axis ``[I, ...]`` (a
fleet-shared plan's rows are expanded views), so the runtime has one
path for a plan and for the fuzzer's per-instance schedules.
"""

from __future__ import annotations

import bisect
from functools import lru_cache
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import rng, wire

NEUTRAL_RATE = 64          # skew rates are 64ths; 64 == 1.0x (exact)


class FaultConfig(NamedTuple):
    """Static, hashable fault plan (rides ``SimConfig.faults``); the
    fields and their meaning are the JAX engine's.

    ``untils`` are the strictly increasing phase end ticks; phase ``p``
    covers ``[untils[p-1], untils[p])`` and every tick at/after
    ``untils[-1]`` or ``stop_tick`` is healthy. Per phase: ``crash[p]``
    the crashed node ids, ``links[p]`` tuples ``(dst, src, block,
    delay, loss_pm)``, ``skew[p]`` tuples ``(node, rate64)``;
    ``members`` is ``None`` (lane absent) or one absolute sorted member
    tuple per phase. ``fuzz`` (a :class:`~.fuzz.FuzzConfig`) switches to
    per-instance randomized schedules; the phase tuples stay empty."""
    enabled: bool = False
    stop_tick: int = 1 << 30
    snapshot_every: int = 1
    untils: Tuple[int, ...] = ()
    crash: Tuple[Tuple[int, ...], ...] = ()
    links: Tuple[Tuple[Tuple[int, int, int, int, int], ...], ...] = ()
    skew: Tuple[Tuple[Tuple[int, int], ...], ...] = ()
    members: Optional[Tuple[Tuple[int, ...], ...]] = None
    n_nodes: int = 0
    fuzz: Optional[Any] = None

    # a lane is present when any phase lists entries for it (even
    # value-neutral ones) or, under a fuzz distribution, when the lane
    # is configured at all (even at rate 0); only present lanes add
    # anything to the tick
    @property
    def has_fuzz(self) -> bool:
        return self.fuzz is not None and self.fuzz.enabled

    @property
    def has_crash(self) -> bool:
        if self.has_fuzz:
            return self.fuzz.has_crash
        return self.enabled and any(len(p) for p in self.crash)

    @property
    def has_links(self) -> bool:
        if self.has_fuzz:
            return self.fuzz.has_links
        return self.enabled and any(len(p) for p in self.links)

    @property
    def has_skew(self) -> bool:
        if self.has_fuzz:
            return self.fuzz.has_skew
        return self.enabled and any(len(p) for p in self.skew)

    @property
    def has_members(self) -> bool:
        if self.has_fuzz:
            return self.fuzz.has_membership
        return self.enabled and self.members is not None

    @property
    def active(self) -> bool:
        return (self.has_crash or self.has_links or self.has_skew
                or self.has_members)


class FaultPlanes(NamedTuple):
    """One tick's fault state, every plane ``[I, ...]`` (``None`` = lane
    not present)."""
    crash: Optional[torch.Tensor] = None       # [I, N] bool
    block: Optional[torch.Tensor] = None       # [I, NT, NT] bool
    delay: Optional[torch.Tensor] = None       # [I, NT, NT] int32
    loss_pm: Optional[torch.Tensor] = None     # [I, NT, NT] int32
    t_nodes: Optional[torch.Tensor] = None     # [I, N] int32 local clocks
    member: Optional[torch.Tensor] = None      # [I, N] bool
    member_prev: Optional[torch.Tensor] = None  # [I, N] bool, last tick's


NO_PLANES = FaultPlanes()


@lru_cache(maxsize=64)
def _planes_np(fx: FaultConfig, n_nodes: int, n_clients: int):
    """Bake the phase timeline into dense per-phase numpy planes
    (row ``P`` = the trailing all-healthy phase)."""
    NT = n_nodes + n_clients
    P = len(fx.untils)
    crash = np.zeros((P + 1, n_nodes), dtype=bool)
    block = np.zeros((P + 1, NT, NT), dtype=bool)
    delay = np.zeros((P + 1, NT, NT), dtype=np.int32)
    loss = np.zeros((P + 1, NT, NT), dtype=np.int32)
    skew = np.full((P + 1, n_nodes), NEUTRAL_RATE, dtype=np.int32)
    member = np.ones((P + 1, n_nodes), dtype=bool)  # heal row: all in
    for p in range(P):
        if p < len(fx.crash):
            for v in fx.crash[p]:
                crash[p, v] = True
                # a dead process hears nobody, servers and clients; its
                # own in-flight sends still deliver
                block[p, v, :] = True
        if fx.members is not None and p < len(fx.members):
            member[p, :] = False
            for v in fx.members[p]:
                member[p, v] = True
            for v in range(n_nodes):
                if not member[p, v]:
                    block[p, v, :] = True
        if p < len(fx.links):
            for dst, src, blk, d, pm in fx.links[p]:
                # duplicate entries for one directed edge merge by max
                if blk:
                    block[p, dst, src] = True
                delay[p, dst, src] = max(delay[p, dst, src], d)
                loss[p, dst, src] = max(loss[p, dst, src], pm)
        if p < len(fx.skew):
            for node, rate in fx.skew[p]:
                skew[p, node] = rate
    return crash, block, delay, loss, skew, member


class PlanTables(NamedTuple):
    """A plan's per-phase planes on the device, ``[P + 1, ...]``."""
    crash: torch.Tensor
    block: torch.Tensor
    delay: torch.Tensor
    loss_pm: torch.Tensor
    skew: torch.Tensor
    member: torch.Tensor


def plan_tables(fx: FaultConfig, cfg, device=None) -> PlanTables:
    """Copy the plan's baked planes to ``device`` once per run."""
    return PlanTables(*(torch.from_numpy(a.copy()).to(device)
                        for a in _planes_np(fx, cfg.n_nodes, cfg.n_clients)))


def _phase_of(fx: FaultConfig, tt: int) -> int:
    """The phase row of tick ``tt`` (``len(untils)`` = healthy)."""
    P = len(fx.untils)
    if tt >= fx.stop_tick:
        return P
    return min(bisect.bisect_right(fx.untils, tt), P)


def _any_block(fx: FaultConfig) -> bool:
    """Whether any phase blocks an edge: a blocked link, or a crashed or
    parked receiver."""
    return any(e[2] for p in fx.links for e in p) or fx.has_crash \
        or fx.has_members


def tick_planes(fx: FaultConfig, tables: PlanTables, t: int,
                n_instances: int) -> FaultPlanes:
    """Tick ``t``'s planes of a fleet-shared plan, expanded to ``[I,
    ...]`` (views of the phase's rows). Ticks at/after ``stop_tick``
    read the all-healthy row."""
    if fx.has_fuzz:
        raise ValueError("tick_planes on a fuzz config: per-instance "
                         "planes come from fuzz.schedule_planes")
    if not fx.active:
        return NO_PLANES
    phase = _phase_of(fx, t)
    rows = lambda a, p=phase: a[p].expand((n_instances,) + a.shape[1:])
    out = {}
    if fx.has_crash:
        out["crash"] = rows(tables.crash)
    if _any_block(fx):
        out["block"] = rows(tables.block)
    if fx.has_links:
        out["delay"] = rows(tables.delay)
        out["loss_pm"] = rows(tables.loss_pm)
    if fx.has_skew:
        out["t_nodes"] = torch.div(
            t * tables.skew[phase], NEUTRAL_RATE,
            rounding_mode="floor").expand(n_instances, -1)
    if fx.has_members:
        out["member"] = rows(tables.member)
        # tick 0 reads its own phase: phase 0's members are the initial
        # cluster, provisioned at init, not a join
        out["member_prev"] = rows(tables.member, _phase_of(fx, t - 1))
    return FaultPlanes(**out)


def member_bits(member: torch.Tensor) -> torch.Tensor:
    """The ``[I, N]`` member plane as int32 bitmasks ``[I]`` (bit ``i`` =
    node ``i`` is a member: the node step's reconfiguration target)."""
    n = member.shape[-1]
    bits = torch.ones(n, dtype=torch.int32, device=member.device) << \
        torch.arange(n, dtype=torch.int32, device=member.device)
    return torch.where(member, bits, 0).sum(dim=-1).to(torch.int32)


def restart_rows(model, snapshots, t_nodes, wipe_keys: torch.Tensor,
                 n_nodes: int):
    """Every node's restart row ``[I, N, ...]``: ``Model.restart_row``
    with node ``i``'s key ``fold_in(wipe_key, i)``, its slab row and its
    local clock (``t_nodes [I, N]`` or the global tick as an int). The
    crash and park wipes both select from these rows: in the JAX engine
    they draw from the same keys, slab and clocks."""
    return model.restart_row(rng.split(wipe_keys, n_nodes), snapshots,
                             t_nodes)


def _pick(mask: torch.Tensor, new, old):
    """Row-tuple select: ``new`` where ``mask [I, N]``, else ``old``."""
    return type(old)(*(torch.where(mask.reshape(mask.shape + (1,) * (
        a.dim() - 2)), b, a) for a, b in zip(old, new)))


def wipe_crashed(node_state, fresh, crash_mask: torch.Tensor):
    """Hold crashed nodes in reset: their rows become the restart rows."""
    return _pick(crash_mask, fresh, node_state)


def wipe_parked(model, node_state, fresh, park_mask: torch.Tensor,
                m_bits: torch.Tensor):
    """Hold non-(stable-)members parked at ``Model.join_row`` of their
    restart rows, provisioned with the current target bitmask. The mask
    is ``~(member & member_prev)``: every non-member tick and the join
    tick itself, so a joining node's last rebuild sees a bitmask that
    includes it."""
    return _pick(park_mask, model.join_row(fresh, m_bits), node_state)


def retarget_clients(reqs: torch.Tensor, member: torch.Tensor
                     ) -> torch.Tensor:
    """Remap client request destinations ``reqs [I, C, L]`` onto the
    current member list: ``members_sorted[dest % n_members]``, the
    identity when everyone is a member (stable argsort)."""
    order = torch.argsort((~member).to(torch.int32), dim=1, stable=True)
    n_m = member.sum(dim=1, keepdim=True).clamp(min=1)
    reqs = reqs.clone()
    reqs[..., wire.DEST] = order.gather(
        1, torch.remainder(reqs[..., wire.DEST], n_m)).to(torch.int32)
    return reqs


def update_snapshots(model, node_state, snapshots: Dict[str, torch.Tensor],
                     hold: torch.Tensor, t: int, every: int):
    """Fold the tick's end state into the snapshot slab: nodes not held
    (crashed or parked) write ``Model.snapshot_row``; with ``every > 1``
    only on ticks with ``(t + 1) % every == 0``."""
    if (t + 1) % every != 0:
        return snapshots
    fresh = model.snapshot_row(node_state)
    return {k: torch.where(hold.reshape(hold.shape + (1,) * (s.dim() - 2)),
                           s, fresh[k]) for k, s in snapshots.items()}


# --- host-side reporting ---------------------------------------------------


def phase_at(fx: FaultConfig, tick: int) -> int:
    """Host-side phase index at ``tick`` (``len(untils)`` = healthy)."""
    if not fx.active or tick >= fx.stop_tick:
        return len(fx.untils)
    return int(np.searchsorted(np.asarray(fx.untils, dtype=np.int64),
                               tick, side="right"))


def _members_at(fx: FaultConfig, p: int) -> Optional[set]:
    """Phase ``p``'s absolute member set (the trailing heal row, and any
    phase past the lane's tuples, is everyone), or ``None`` when the
    lane is absent."""
    if fx.members is None:
        return None
    if 0 <= p < len(fx.members):
        return set(fx.members[p])
    return set(range(fx.n_nodes))


def _membership_epoch(fx: FaultConfig, p: int) -> Optional[Dict[str, Any]]:
    """The phase's membership record: the member set, who is out of the
    full cluster, and who joined at the phase start."""
    cur = _members_at(fx, p)
    if cur is None:
        return None
    prev = _members_at(fx, p - 1) if p > 0 else cur
    out: Dict[str, Any] = {"members": sorted(cur)}
    joined = sorted(cur - prev)
    removed = sorted(set(range(fx.n_nodes)) - cur)
    if joined:
        out["joined"] = joined
    if removed:
        out["removed"] = removed
    return out


def phase_summary(fx: FaultConfig, tick: int) -> Dict[str, Any]:
    """Which phase ``tick`` is in and which lanes it has active."""
    p = phase_at(fx, tick)
    out: Dict[str, Any] = {"phase": p, "phases": len(fx.untils)}
    if p >= len(fx.untils):
        out["healthy"] = True
        return out
    if p < len(fx.crash) and fx.crash[p]:
        out["crashed"] = sorted(fx.crash[p])
    if p < len(fx.links) and fx.links[p]:
        out["degraded-edges"] = len(fx.links[p])
    if p < len(fx.skew) and fx.skew[p]:
        out["skewed-nodes"] = len(fx.skew[p])
    mem = _membership_epoch(fx, p)
    if mem is not None:
        out["membership"] = mem
    return out


def span_summary(fx: FaultConfig, t0: int, ticks: int) -> Dict[str, Any]:
    """The union of lanes active anywhere in ``[t0, t0 + ticks)``, plus
    the phase the span ended in."""
    end = t0 + max(1, int(ticks)) - 1
    out: Dict[str, Any] = {"phase": phase_at(fx, end),
                           "phases": len(fx.untils)}
    crashed: set = set()
    edges = 0
    skewed = 0
    joined: set = set()
    removed: set = set()
    members_end: Optional[set] = None
    healthy = True
    for p in range(len(fx.untils)):
        lo = fx.untils[p - 1] if p else 0
        hi = min(fx.untils[p], fx.stop_tick)
        if lo >= t0 + ticks or hi <= t0:
            continue
        if p < len(fx.crash) and fx.crash[p]:
            crashed.update(fx.crash[p])
            healthy = False
        if p < len(fx.links) and fx.links[p]:
            edges = max(edges, len(fx.links[p]))
            healthy = False
        if p < len(fx.skew) and fx.skew[p]:
            skewed = max(skewed, len(fx.skew[p]))
            healthy = False
        mem = _membership_epoch(fx, p)
        if mem is not None:
            joined.update(mem.get("joined", ()))
            removed.update(mem.get("removed", ()))
            members_end = set(mem["members"])
    if members_end is not None and (joined or removed
                                    or len(members_end) < fx.n_nodes):
        healthy = False
    if healthy:
        out["healthy"] = True
        return out
    if crashed:
        out["crashed"] = sorted(crashed)
    if edges:
        out["degraded-edges"] = edges
    if skewed:
        out["skewed-nodes"] = skewed
    if members_end is not None:
        out["membership"] = {"members": sorted(members_end),
                             **({"joined": sorted(joined)}
                                if joined else {}),
                             **({"removed": sorted(removed)}
                                if removed else {})}
    return out


def plan_summary(fx: FaultConfig) -> Dict[str, Any]:
    """The run's fault block: lanes, phase count, slab stride, final
    heal tick, and the distribution under a fuzz config."""
    lanes = [name for name, on in (("crash-restart", fx.has_crash),
                                   ("link-degradation", fx.has_links),
                                   ("clock-skew", fx.has_skew),
                                   ("membership", fx.has_members)) if on]
    out: Dict[str, Any] = {"phases": len(fx.untils), "lanes": lanes,
                           "snapshot-every": fx.snapshot_every,
                           "stop-tick": int(fx.stop_tick)}
    if fx.has_fuzz:
        from .fuzz import fuzz_summary
        out["fuzz"] = fuzz_summary(fx)
    return out
