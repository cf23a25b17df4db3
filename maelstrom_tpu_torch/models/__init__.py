"""Vectorized protocol models of the port and their registry.

Counterpart of ``maelstrom_tpu/models/__init__.py`` for the workloads
ported so far: lin-kv Raft and the transactional workloads over it
(the fused node protocol), and the tutorial workloads and kafka on the
legacy handle/tick protocol.

``opts`` carries the model-selection flags of the JAX registry:

- ``crash_clients`` — kafka: clients randomly crash and resume from the
  committed offsets;
- ``txn_dirty_apply`` — txn workloads: the dirty-apply mutant by flag
  instead of by mutant name (the model carries the mutant's name).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

WORKLOADS = ("echo", "unique-ids", "broadcast", "g-set", "g-counter",
             "pn-counter", "lin-kv", "kafka", "txn-list-append",
             "txn-rw-register")
MUTANTS = ("kafka-bug-offset-reuse", "kafka-bug-commit-regression",
           "txn-list-append-bug-dirty-apply",
           "txn-rw-register-bug-dirty-apply")


def get_model(workload: str, node_count: int, topology: str = "grid",
              raft_kw: Optional[Dict[str, Any]] = None,
              opts: Optional[Dict[str, Any]] = None):
    """The model of a workload name, as the JAX registry builds it:
    broadcast and g-set gossip over ``topology``, the counters over the
    total topology, Raft and the txn workloads sized to ``node_count``
    (``raft_kw`` adds lin-kv's log capacity and heartbeat). Any other
    name raises."""
    from .crdt import (BroadcastModel, GCounterModel, GossipSetModel,
                       PNCounterModel)
    from .echo import EchoModel
    from .kafka import KAFKA_BUGGY_MODELS, KafkaModel
    from .raft import RaftModel
    from .txn_raft import (TXN_BUGGY_MODELS, TxnListAppendModel,
                           TxnRwRegisterModel)
    from .unique_ids import UniqueIdsModel

    opts = opts or {}
    if opts.get("txn_dirty_apply") and workload in ("txn-list-append",
                                                    "txn-rw-register"):
        workload = f"{workload}-bug-dirty-apply"

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
    if workload == "txn-list-append":
        return TxnListAppendModel(n_nodes_hint=node_count)
    if workload == "txn-rw-register":
        return TxnRwRegisterModel(n_nodes_hint=node_count)
    for prefix in ("txn-list-append-bug-", "txn-rw-register-bug-"):
        if workload.startswith(prefix):
            kind = workload[len(prefix):]
            if prefix.startswith("txn-rw-register"):
                kind = "rw-" + kind
            if kind in TXN_BUGGY_MODELS:
                return TXN_BUGGY_MODELS[kind](n_nodes_hint=node_count)
    crash = bool(opts.get("crash_clients"))
    if workload == "kafka":
        return KafkaModel(crash_clients=crash)
    if workload.startswith("kafka-bug-"):
        kind = workload[len("kafka-bug-"):]
        if kind in KAFKA_BUGGY_MODELS:
            return KAFKA_BUGGY_MODELS[kind](crash_clients=crash)
    raise ValueError(f"workload {workload!r} is not ported to "
                     f"maelstrom_tpu_torch (ported: {', '.join(WORKLOADS)}; "
                     f"mutants: {', '.join(MUTANTS)})")
