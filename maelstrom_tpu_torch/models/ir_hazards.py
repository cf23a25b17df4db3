"""Deliberately hazardous models: the IR and lane lint fixtures.

Counterpart of ``maelstrom_tpu/models/ir_hazards.py``'s IR and lane
fixtures. ``models/raft_buggy.py`` holds the protocol bugs the checkers
must catch and the Python-surface hazards the trace lint (TRC1xx) must
catch. The models here have clean Python — they run, they hold the
contract audit's shape contracts, the trace lint has nothing to say —
but the aten graph of their tick carries exactly the hazard the IR pass
(``analysis/ir_lint.py``, JXP4xx) or the lane pass
(``analysis/lane_liveness.py``, LNE6xx) exists to flag:

- :class:`IrFloatLeak` — a float32 leaf in the carry (JXP401);
- :class:`IrHostCallback` — a Python table indexed by a device value:
  the index is read on the host every tick, which the trace lint's
  TRC104 does not see (JXP402);
- :class:`IrFusionBreaker` — a broadcast materialised at many times the
  carry (JXP404; the JAX fixture's while loop has no eager
  counterpart: a Python loop unrolls);
- :class:`IrBakedConst` — a large module-level tensor read by the tick
  (JXP405);
- :class:`IrDeadLane` — declared body lanes no path reads, and carry
  leaves that feed nothing (LNE601, LNE602);
- :class:`IrDeadStore` — a body lane written and never read (LNE603);
- :class:`IrLaneOverread` — a read one lane past the row's end
  (LNE604);
- :class:`IrCounterOverflow` — a counter that provably crosses int32
  max just past the production horizon (ABS701);
- :class:`IrScatterRace` — an overwrite scatter whose constant index
  rows alias (ABS702);
- :class:`IrOobGather` — a clamped index whose range before the clamp
  lies past the table (ABS703);
- :class:`IrShardCrossTalk` — a tick that gathers and all-reduces over
  the instance axis through functional collectives (SHD803, SHD801);
- :class:`IrShardReplicatedLeaf` — a per-instance table in the params
  every shard holds whole (SHD802).

Like ``RaftTracedHazards``, none is in any workload registry and none
may be: ``tests/test_torch_ir.py``, ``tests/test_torch_lanes.py`` and
``tests/test_torch_ranges.py`` and ``tests/test_torch_shard.py`` assert
that each trips its rule, and ``analysis/baseline.json`` carries the
findings as ``expected``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import wire
from .echo import EchoModel

_I32 = torch.int32


class _FloatRow(NamedTuple):
    seen: torch.Tensor    # int32: the honest part of the row
    drift: torch.Tensor   # float32: the planted carry leak


class IrFloatLeak(EchoModel):
    """IR FIXTURE (do not register): a float32 leaf in the carry.

    The carry is still a shape and dtype fixed point (float32 in,
    float32 out), so the contract audit passes; only the IR pass sees
    that the carry left the integer envelope."""
    name = "echo-ir-float-leak"

    def init_state(self, n_nodes, keys):
        shape = keys.shape[:-1]
        return _FloatRow(seen=torch.zeros(shape, dtype=_I32,
                                          device=keys.device),
                         drift=torch.zeros(shape, dtype=torch.float32,
                                           device=keys.device))

    def handle(self, row, node_idx, msg, t, keys, cfg, params):
        _, out = super().handle(row.seen, node_idx, msg, t, keys, cfg,
                                params)
        # a float accumulator riding the carry: the silent widening the
        # rule exists for
        drift = row.drift * 0.999 + 1.0
        return _FloatRow(seen=row.seen + 1, drift=drift), out


# a host-side table the tick indexes with a device value
_JITTER = (0, 0, 0, 0)


class IrHostCallback(EchoModel):
    """IR FIXTURE (do not register): a host read in the tick — a Python
    table indexed by a device value makes the issuing thread wait for
    the card on every tick, and no call the trace lint knows (``int()``,
    ``.item()``, ...) appears in the source."""
    name = "echo-ir-host-callback"

    def tick(self, row, node_idx, t, keys, cfg, params):
        jitter = _JITTER[row.sum() % len(_JITTER)]
        return row + jitter * 0, torch.zeros(
            (node_idx.shape[0], self.tick_out, cfg.lanes), dtype=_I32,
            device=node_idx.device)


class IrFusionBreaker(EchoModel):
    """IR FIXTURE (do not register): a broadcast materialised at 2 MiB,
    many times the carry — written to device memory and read back
    whole by its consumer every tick."""
    name = "echo-ir-fusion-breaker"

    def tick(self, row, node_idx, t, keys, cfg, params):
        big = torch.broadcast_to(row[:1] + t, (512, 1024)).contiguous()
        row = row + big.sum(dtype=_I32) * 0
        return row, torch.zeros(
            (node_idx.shape[0], self.tick_out, cfg.lanes), dtype=_I32,
            device=node_idx.device)


# 128 KiB of int32 the tick reads as a constant, not from the carry
_BAKED_TABLE = torch.arange(32768, dtype=_I32)


class IrBakedConst(EchoModel):
    """IR FIXTURE (do not register): a large module-level tensor read by
    the tick — copied to the device on every run, invisible to the
    carry and its checkpoints."""
    name = "echo-ir-baked-const"

    def tick(self, row, node_idx, t, keys, cfg, params):
        bias = _BAKED_TABLE.to(row.device).sum(dtype=_I32) * 0
        return row + bias, torch.zeros(
            (node_idx.shape[0], self.tick_out, cfg.lanes), dtype=_I32,
            device=node_idx.device)


# audited by analysis/ir_lint.py alongside the registered models;
# intentionally NOT reachable from models.get_model
IR_FIXTURE_MODELS = {
    "float-leak": IrFloatLeak,
    "host-callback": IrHostCallback,
    "fusion-breaker": IrFusionBreaker,
    "baked-const": IrBakedConst,
}


# --- lane-liveness fixtures (analysis/lane_liveness.py, LNE6xx) ------------


class _DeadRow(NamedTuple):
    seen: torch.Tensor     # int32: written every tick, observed never
    ballast: torch.Tensor  # int32[4]: carried verbatim, read nowhere


class IrDeadLane(EchoModel):
    """LANE FIXTURE (do not register): declares ``body_lanes = 4`` but
    the protocol only ever touches body lane 0 — lanes 1-3 are pure
    device-memory headroom (LNE601), and the carry gains two leaves
    that feed no observable output, not even through the carry fixed
    point (LNE602). Narrowing ``body_lanes`` to the live set must leave
    the trajectory bit-identical."""
    name = "echo-ir-dead-lane"
    body_lanes = 4

    def init_state(self, n_nodes, keys):
        shape = keys.shape[:-1]
        return _DeadRow(seen=torch.zeros(shape, dtype=_I32,
                                         device=keys.device),
                        ballast=torch.zeros(shape + (4,), dtype=_I32,
                                            device=keys.device))

    def handle(self, row, node_idx, msg, t, keys, cfg, params):
        _, out = super().handle(row.seen, node_idx, msg, t, keys, cfg,
                                params)
        return _DeadRow(seen=row.seen + 1, ballast=row.ballast), out


class IrDeadStore(EchoModel):
    """LANE FIXTURE (do not register): the echo reply also stamps the
    request's msg_id into body lane 1 — but no reader (server or client
    decode) ever looks at that lane, so every write is a dead store
    (LNE603) and the lane itself is dead (LNE601)."""
    name = "echo-ir-dead-store"

    def handle(self, row, node_idx, msg, t, keys, cfg, params):
        row, out = super().handle(row, node_idx, msg, t, keys, cfg,
                                  params)
        out[:, 0, wire.BODY + 1] = msg[:, wire.MSGID]
        return row, out


class IrLaneOverread(EchoModel):
    """LANE FIXTURE (do not register): reads one lane past the end of
    the message row through an index tensor — no bounds check runs when
    the index is built, and on the card the gather reads out of bounds
    (LNE604, error severity). The static slice folds the index constant
    and flags the access."""
    name = "echo-ir-lane-overread"

    def handle(self, row, node_idx, msg, t, keys, cfg, params):
        row, out = super().handle(row, node_idx, msg, t, keys, cfg,
                                  params)
        past = torch.full((msg.shape[0], 1), cfg.lanes, dtype=torch.long,
                          device=msg.device)
        ghost = msg.gather(1, past)[:, 0]
        out[:, 0, wire.BODY] += ghost * 0
        return row, out


# audited by analysis/lane_liveness.py alongside the registered models;
# intentionally NOT reachable from models.get_model
LANE_FIXTURE_MODELS = {
    "dead-lane": IrDeadLane,
    "dead-store": IrDeadStore,
    "lane-overread": IrLaneOverread,
}


# --- value-range fixtures (analysis/absint.py, ABS7xx) ---------------------
#
# Clean by every TRC/CON/JXP/COST/LNE measure, hazardous in their VALUE
# RANGES: exactly what the interval abstract interpreter proves.


class IrCounterOverflow(EchoModel):
    """RANGE FIXTURE (do not register): an unclamped per-tick counter
    increment of 2048 — the leaf provably crosses int32 max at T = 2^31 /
    2^11 = 2^20 ticks, just past the production horizon's last tick
    (ABS701 names the leaf and the minimal overflowing T)."""
    name = "echo-ir-counter-overflow"

    def tick(self, row, node_idx, t, keys, cfg, params):
        # 2^11 per tick: reaches 2^31 on tick 2^20 exactly
        return row + 2048, torch.zeros(
            (node_idx.shape[0], self.tick_out, cfg.lanes), dtype=_I32,
            device=node_idx.device)


class IrScatterRace(EchoModel):
    """RANGE FIXTURE (do not register): two of the three overwrite
    scatter updates target the SAME slot — a write-write race within one
    tick. On the card duplicate ``scatter`` writes land in an
    unspecified order, so which payload wins depends on the schedule
    (ABS702). The constant index rows make the aliasing provable."""
    name = "echo-ir-scatter-race"

    def init_state(self, n_nodes, keys):
        return torch.zeros(keys.shape[:-1] + (4,), dtype=_I32,
                           device=keys.device)

    def handle(self, row, node_idx, msg, t, keys, cfg, params):
        seen, out = super().handle(row[:, 0], node_idx, msg, t, keys, cfg,
                                   params)
        # rows 0 and 1 both write slot 1 with different payloads
        vals = torch.stack([msg[:, wire.MSGID], msg[:, wire.MSGID] + 1,
                            seen], dim=1)
        slots = torch.tensor([1, 1, 2]).to(row.device)
        row = row.scatter(1, slots.expand(row.shape[0], 3), vals)
        row[:, 0] = seen
        return row, out


class IrOobGather(EchoModel):
    """RANGE FIXTURE (do not register): a table read at ``8 + (t % 4)``
    over an 8-entry table, through the ``.clamp`` the port uses where
    XLA clamps a traced index — so nothing raises, and every tick reads
    the last entry instead (ABS703: the index before the clamp is
    ``[8, 11]``, never inside ``[0, 7]``)."""
    name = "echo-ir-oob-gather"

    def tick(self, row, node_idx, t, keys, cfg, params):
        table = torch.arange(8, dtype=_I32, device=row.device)
        idx = torch.full((1,), 8 + t % 4, dtype=torch.long,
                         device=row.device).clamp(0, 7)
        ghost = table.gather(0, idx)
        return row + ghost * 0, torch.zeros(
            (node_idx.shape[0], self.tick_out, cfg.lanes), dtype=_I32,
            device=node_idx.device)


# audited by analysis/absint.py alongside the registered models;
# intentionally NOT reachable from models.get_model
RANGE_FIXTURE_MODELS = {
    "counter-overflow": IrCounterOverflow,
    "scatter-race": IrScatterRace,
    "oob-gather": IrOobGather,
}


# --- shard fixtures (analysis/shard_audit.py, SHD8xx) -----------------------
#
# Models clean by every one-device measure whose SHARDED run is
# hazardous: what the shard pass exists to catch before a run over
# several cards does. Never registered; findings carried as
# status="expected" in analysis/baseline.json.

# the process group a shard's collectives would name: the mesh's axis
# (parallel/mesh.py AXIS)
_GROUP = "instances"


class IrShardCrossTalk(EchoModel):
    """SHARD FIXTURE (do not register): the tick gathers every shard's
    rows across the instance axis and folds an all-reduce of them back
    into the row — a cross-shard data dependence (SHD803: instances are
    pure functions of (seed, global id), so results now change with the
    mesh size) and an unbudgeted reduction in the tick (SHD801). The
    functional collectives name the mesh's process group; outside a
    group of that name they raise, so only the shard pass, which records
    them on ``meta`` tensors, ever sees them."""
    name = "echo-ir-shard-cross-talk"

    def tick(self, row, node_idx, t, keys, cfg, params):
        c10d = torch.ops._c10d_functional
        peers = c10d.wait_tensor(c10d.all_gather_into_tensor(
            row, 2, _GROUP))
        spill = c10d.wait_tensor(c10d.all_reduce(
            peers.sum(dtype=_I32).reshape(1), "sum", _GROUP))
        return row + spill * 0, torch.zeros(
            (node_idx.shape[0], self.tick_out, cfg.lanes), dtype=_I32,
            device=node_idx.device)


class IrShardReplicatedLeaf(EchoModel):
    """SHARD FIXTURE (do not register): a params table with one row per
    instance. Every shard builds the params whole, so every device holds
    ALL instances' rows — per-instance state smuggled into the params is
    O(shards) memory and stops scaling with the fleet (SHD802). The leaf
    clears the audit's 16 KiB floor (4 x 4096 int32 = 64 KiB)."""
    name = "echo-ir-shard-replicated-leaf"

    def make_params(self, n_nodes, device=None):
        # leading dim == the audit sim's per-shard instance count: the
        # shape SHD802 keys on
        return {"per_instance_cache": torch.zeros((4, 4096), dtype=_I32,
                                                  device=device)}


# audited by analysis/shard_audit.py alongside the registered models;
# intentionally NOT reachable from models.get_model
SHARD_FIXTURE_MODELS = {
    "shard-cross-talk": IrShardCrossTalk,
    "shard-replicated-leaf": IrShardReplicatedLeaf,
}
