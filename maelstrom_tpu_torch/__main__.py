"""Command line of the port: ``python -m maelstrom_tpu_torch test -w lin-kv``.

Runs a ported workload's fleet (``models.WORKLOADS``: lin-kv Raft, the
tutorial workloads echo, unique-ids, broadcast, g-set, g-counter and
pn-counter, kafka, and txn-list-append and txn-rw-register over Raft;
``models.MUTANTS``: the kafka and txn mutants) through
:func:`harness.run_torch_test` and prints a JSON summary (verdict,
network counters, throughput, device, and the fault block under a fault
plan or distribution). Unset flags take the harness defaults
(``harness.TORCH_DEFAULTS``). Exit code 0 when the run is valid, 1 when
it is not.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from .faults.spec import FAULT_KINDS
from .runtime import NEMESIS_KINDS
from .topology import TOPOLOGIES


def _positive_int(v: str) -> int:
    n = int(v)
    if n < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {n}")
    return n


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m maelstrom_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("test", help="run a workload on the device fleet")
    p.add_argument("-w", "--workload", required=True,
                   help="a ported workload; any other name raises")
    p.add_argument("--node-count", type=int, default=3)
    p.add_argument("--topology", default="grid", choices=sorted(TOPOLOGIES),
                   help="gossip topology of broadcast and g-set")
    p.add_argument("--concurrency", default=None,
                   help="clients per instance: N, or Kn for K per node")
    p.add_argument("--rate", type=float, help="ops/sec per instance")
    p.add_argument("--time-limit", type=float, help="simulated seconds")
    p.add_argument("--latency", type=float, help="mean latency, ms")
    p.add_argument("--latency-dist",
                   choices=("constant", "uniform", "exponential"))
    p.add_argument("--nemesis", action="append", default=[],
                   choices=("partition",) + FAULT_KINDS,
                   help="fault kinds, composable (repeat the flag): the "
                        "partition nemesis, and the fault-plan lanes "
                        "generated on the nemesis interval grid")
    p.add_argument("--nemesis-interval", type=float)
    p.add_argument("--nemesis-kind",
                   choices=[k for k in NEMESIS_KINDS if k != "scripted"],
                   help="partition grudge shape (default random-halves)")
    p.add_argument("--fault-plan", metavar="FILE",
                   help="JSON fault-plan file (phases of crash-restart, "
                        "link-degradation, clock-skew and membership "
                        "lanes); exclusive with the generated fault "
                        "--nemesis kinds")
    p.add_argument("--fault-fuzz", metavar="FILE",
                   help="JSON fault distribution file: a randomized "
                        "schedule per instance, drawn on the device; "
                        "exclusive with --fault-plan and the fault "
                        "--nemesis kinds")
    p.add_argument("--fault-snapshot-every", type=_positive_int,
                   help="ticks between snapshot-slab captures (default: "
                        "the plan's own snapshot_every, else 1)")
    p.add_argument("--recovery-time", type=float)
    p.add_argument("--rpc-timeout", type=float)
    p.add_argument("--p-loss", type=float)
    p.add_argument("--n-instances", type=int)
    p.add_argument("--record-instances", type=int)
    p.add_argument("--inbox-k", type=int)
    p.add_argument("--pool-slots", type=int)
    p.add_argument("--ms-per-tick", type=int)
    p.add_argument("--log-cap", type=int,
                   help="Raft log capacity per node (lin-kv; default 96)")
    p.add_argument("--heartbeat-ticks", type=int,
                   help="Raft leader heartbeat cadence in ticks (lin-kv; "
                        "default 15)")
    p.add_argument("--key-count", type=int,
                   help="keys of the kv, txn and kafka models")
    p.add_argument("--crash-clients", action="store_true",
                   help="kafka: clients randomly crash and resume from "
                        "the committed offsets")
    p.add_argument("--txn-dirty-apply", action="store_true",
                   help="txn workloads: run the dirty-apply mutant")
    p.add_argument("--consistency-models", metavar="MODEL",
                   help="the model Elle checks the txn workloads against "
                        "(default strict-serializable)")
    p.add_argument("--txn", action="store_true",
                   help="kafka transactions: not ported (refused)")
    p.add_argument("--no-telemetry", action="store_true")
    p.add_argument("--pipeline", choices=("auto", "on", "off"))
    p.add_argument("--chunk-ticks", type=int)
    p.add_argument("--seed", type=int)
    p.add_argument("--store", default="store")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)
    from .harness import run_torch_test
    from .models import get_model

    opts = {"node_count": args.node_count, "store_root": args.store}
    if args.concurrency is not None:
        c = args.concurrency
        opts["concurrency"] = (int(c[:-1]) * args.node_count
                               if c.endswith("n") else int(c))
    for flag in ("rate", "time_limit", "latency", "latency_dist",
                 "nemesis_interval", "nemesis_kind", "recovery_time",
                 "rpc_timeout", "p_loss", "n_instances", "record_instances",
                 "inbox_k", "pool_slots", "ms_per_tick", "pipeline",
                 "chunk_ticks", "fault_snapshot_every", "seed"):
        v = getattr(args, flag)
        if v is not None:
            opts[flag] = v
    for flag in ("fault_plan", "fault_fuzz"):
        path = getattr(args, flag)
        if path is not None:
            with open(path) as f:
                opts[flag] = json.load(f)
    if args.nemesis:
        opts["nemesis"] = args.nemesis
    if args.no_telemetry:
        opts["telemetry"] = False
    raft_kw = {k: v for k, v in (("log_cap", args.log_cap),
                                 ("heartbeat", args.heartbeat_ticks))
               if v is not None}
    if raft_kw and args.workload != "lin-kv":
        raise ValueError("--log-cap and --heartbeat-ticks are options of "
                         "lin-kv only")
    if args.txn:
        raise ValueError("--txn (kafka transactions) is a process and "
                         "native-runtime feature of the JAX package; "
                         "maelstrom_tpu_torch does not port it")
    model_opts = {k: True for k in ("crash_clients", "txn_dirty_apply")
                  if getattr(args, k)}
    opts.update(model_opts)
    if args.consistency_models:
        opts["consistency_models"] = args.consistency_models
    model = get_model(args.workload, args.node_count, args.topology,
                      raft_kw, opts=model_opts)
    if args.key_count and hasattr(model, "n_keys"):
        model.n_keys = args.key_count
    res = run_torch_test(model, opts, device=args.device)
    summary = {k: res[k] for k in ("valid?", "instance-count",
                                   "checked-instances", "valid-instances",
                                   "invariants", "net", "device")}
    perf = res["perf"]
    summary["perf"] = {k: perf[k] for k in ("wall-s", "ticks",
                                            "ticks-per-sec",
                                            "msgs-per-sec")}
    for k in ("faults", "fault-fuzz"):
        if k in res:
            summary[k] = res[k]
    summary["store-dir"] = res.get("store-dir")
    print(json.dumps(summary))
    return 0 if res["valid?"] is True else 1


if __name__ == "__main__":
    sys.exit(main())
