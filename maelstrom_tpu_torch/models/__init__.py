"""Vectorized protocol models of the port and their registry.

Counterpart of ``maelstrom_tpu/models/__init__.py`` for the workloads
ported so far: lin-kv Raft (the fused node protocol) and the tutorial
workloads on the legacy handle/tick protocol.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

WORKLOADS = ("echo", "unique-ids", "broadcast", "g-set", "g-counter",
             "pn-counter", "lin-kv")


def get_model(workload: str, node_count: int, topology: str = "grid",
              raft_kw: Optional[Dict[str, Any]] = None):
    """The model of a workload name, as the JAX registry builds it:
    broadcast and g-set gossip over ``topology``, the counters over the
    total topology, Raft sized to ``node_count`` (``raft_kw`` adds its
    log capacity and heartbeat). Any other name raises."""
    from .crdt import (BroadcastModel, GCounterModel, GossipSetModel,
                       PNCounterModel)
    from .echo import EchoModel
    from .raft import RaftModel
    from .unique_ids import UniqueIdsModel

    if workload == "echo":
        return EchoModel()
    if workload == "unique-ids":
        return UniqueIdsModel()
    if workload == "broadcast":
        return BroadcastModel(topology)
    if workload == "g-set":
        return GossipSetModel(topology)
    if workload == "pn-counter":
        return PNCounterModel(n_nodes_hint=node_count, topology="total")
    if workload == "g-counter":
        return GCounterModel(n_nodes_hint=node_count, topology="total")
    if workload == "lin-kv":
        return RaftModel(n_nodes_hint=node_count, **(raft_kw or {}))
    raise ValueError(f"workload {workload!r} is not ported to "
                     f"maelstrom_tpu_torch (ported: {', '.join(WORKLOADS)})")
