"""The fleet configurations that ``chip_smoke.py`` drives and
``profile_tick.py`` profiles: ``run_torch_test`` options with their
sources, at full width.

- ``FLAGSHIP``: the lin-kv Raft run ``bench.py:190-258`` measures.
- ``BROADCAST_25``: the guide's broadcast (``doc/guide/03-broadcast.md``
  :56-58, with its partitions, :61-76): 25 nodes in a tree4, 25 clients
  (``--concurrency 1n``), 100 ops/s. Cut to 2 simulated seconds (the
  guide runs 20) with the bench's 0.4 s nemesis interval (the guide's
  3 s would never cut the network in 2 s), and 256 pool slots instead
  of the CLI's 128, at which the JAX reference drops sends for overflow
  and loses elements.
- ``FAMILIES``: the other tutorial workloads at the bench's family
  settings (``bench.py:895-918``: 3 nodes, 6 clients, ``inbox_k`` 1, 16
  slots, 200 ops/s, 5% loss, partitions every 0.4 s); g-set and the
  counters with the bench's 0.25 s RPC timeout, 1 simulated second.
- ``TXN``: txn-list-append and txn-rw-register at the same family
  settings (``bench.py:906``), their models at the defaults of
  ``maelstrom_tpu/models/txn_raft.py`` (8 keys, 3 micro-ops, 16 list
  slots, a 96-entry log).
- ``KAFKA``: kafka at the family settings with the bench's own
  overrides (``bench.py:914-915``): 1 node, no nemesis, 0.25 s RPC
  timeout.
- ``BUG_HUNT``: the lin-kv mutants' bug hunt, ``BUG_OPTS`` of the JAX
  package's Raft tests (``tests/test_tpu_raft.py:38-42``: 3 nodes, 3
  clients, 40 ops/s, latency 10, 5% loss, RPC timeout 0.8 s,
  random-halves partitions every 0.25 s, 0.3 s recovery, seed 2, 2.5
  simulated seconds) at the CLI's pool and inbox defaults (128 slots,
  ``inbox_k`` 8), 4096 instances, 4 recorded, stopping a chunk after
  the first invariant trip and replaying up to 32 trippers.
"""

from __future__ import annotations

from typing import Any, Dict

FLAGSHIP = dict(node_count=3, concurrency=6, n_instances=4096,
                record_instances=1, time_limit=4.0, rate=200.0,
                latency=5.0, rpc_timeout=1.0, nemesis=["partition"],
                nemesis_interval=0.4, p_loss=0.05, recovery_time=0.3,
                seed=7, telemetry=True, inbox_k=1, pool_slots=16,
                layout="lead")
FLAGSHIP_MODEL_KW = dict(log_cap=64, heartbeat=8)

BROADCAST_25 = dict(node_count=25, concurrency=25, n_instances=4096,
                    record_instances=4, time_limit=2.0, rate=100.0,
                    latency=10.0, latency_dist="exponential", p_loss=0.0,
                    rpc_timeout=1.0, nemesis=["partition"],
                    nemesis_interval=0.4, recovery_time=0.3, seed=7,
                    telemetry=True, inbox_k=8, pool_slots=256,
                    layout="lead")
BROADCAST_25_TOPOLOGY = "tree4"

_FAMILY = dict(FLAGSHIP, record_instances=4, time_limit=1.0)
FAMILIES: Dict[str, Dict[str, Any]] = {
    "echo": _FAMILY,
    "unique-ids": _FAMILY,
    "g-set": dict(_FAMILY, rpc_timeout=0.25),
    "g-counter": dict(_FAMILY, rpc_timeout=0.25),
    "pn-counter": dict(_FAMILY, rpc_timeout=0.25),
}
TXN = dict(_FAMILY)
KAFKA = dict(_FAMILY, node_count=1, nemesis=[], rpc_timeout=0.25)
BUG_HUNT = dict(node_count=3, concurrency=3, n_instances=4096,
                record_instances=4, time_limit=2.5, rate=40.0,
                latency=10.0, rpc_timeout=0.8, nemesis=["partition"],
                nemesis_interval=0.25, p_loss=0.05, recovery_time=0.3,
                seed=2, telemetry=True, inbox_k=8, pool_slots=128,
                layout="lead", fail_fast=True, funnel_max=32)


def rotating_majorities(n: int = 5, phase_len: int = 100,
                        until: int = 500) -> tuple:
    """A scripted schedule of rotating 3-node majorities over a 5-node
    cluster, ``phase_len`` ticks each until ``until`` (the JAX Raft
    tests' Figure-8 schedule, ``tests/test_tpu_raft.py:55-67``, with
    their 200-tick phases): in each phase only one majority can talk and
    the pivot node rotates — the partial replication and leader changes
    of the Raft §5.4.2 Figure-8 scenario."""
    from .runtime import scripted_isolate_groups
    cycle = [({0, 1, 2},), ({2, 3, 4},), ({4, 0, 1},), ({1, 2, 3},),
             ({3, 4, 0},)]
    sched, t, i = [], 0, 0
    while t < until:
        t += phase_len
        sched.append(scripted_isolate_groups(t, cycle[i % 5], n))
        i += 1
    return tuple(sched)


def fleet(workload: str, model_opts=None):
    """``(model, opts)`` of a workload's fleet: the flagship for lin-kv,
    ``BUG_HUNT`` for the lin-kv mutants, ``BROADCAST_25`` for broadcast,
    ``TXN`` for the txn workloads and their mutants, ``KAFKA`` for kafka
    and its mutants, its family run otherwise. ``model_opts`` are ``get_model``'s model-selection flags
    (kafka's ``crash_clients``), which the run's options repeat."""
    from .models import get_model
    model_opts = dict(model_opts or {})
    if workload.startswith(("txn-", "kafka")):
        opts = dict(TXN if workload.startswith("txn-") else KAFKA,
                    **model_opts)
        return (get_model(workload, opts["node_count"], opts=model_opts),
                opts)
    if workload == "lin-kv":
        return (get_model("lin-kv", 3, raft_kw=FLAGSHIP_MODEL_KW),
                dict(FLAGSHIP))
    if workload.startswith("lin-kv-bug-"):
        return get_model(workload, 3), dict(BUG_HUNT)
    if workload == "broadcast":
        return (get_model("broadcast", 25, BROADCAST_25_TOPOLOGY),
                dict(BROADCAST_25))
    opts = dict(FAMILIES[workload])
    return get_model(workload, opts["node_count"]), opts
