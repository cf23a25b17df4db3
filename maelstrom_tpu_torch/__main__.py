"""Command line of the port: ``python -m maelstrom_tpu_torch test -w lin-kv``.

``test`` runs a ported workload's fleet (``models.WORKLOADS``: lin-kv Raft, the
tutorial workloads echo, unique-ids, broadcast, g-set, g-counter and
pn-counter, kafka, and txn-list-append and txn-rw-register over Raft;
``models.MUTANTS``: the nine lin-kv Raft mutants and the kafka and txn
mutants) through :func:`harness.run_torch_test` and prints a JSON
summary (verdict, invariants, network counters, throughput, the verdict
stage's record, device, and the check, fail-fast, availability, funnel
and fault blocks where the run has them). Unset flags take the harness defaults
(``harness.TORCH_DEFAULTS``). Exit code 0 when the run is valid, 1 when
it is not, 2 for a bad or missing schedule file.

The forensics commands work on a stored run's directory, with the JAX
CLI's flags, messages and exit codes:

- ``watch RUN_DIR`` renders its ``heartbeat.jsonl`` (``-f`` follows it
  until the run-end record): 0 for a finished run, 3 for one with no
  run-end record, 2 when there is no heartbeat;
- ``triage RUN_DIR`` replays the flagged instances with journals and
  writes their bundles under ``RUN_DIR/triage/`` (2 when the run dir
  cannot be triaged);
- ``shrink RUN_DIR`` delta-debugs each flagged instance's fault
  schedule to a minimal plan that still trips (1 when an instance could
  not be shrunk, 2 when the run is no fault run).

``triage`` and ``shrink`` replay on ``--device`` (``cuda`` by default),
with the run's own options from its heartbeat (``check_mode`` and
``check_workers`` included).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

from .faults.spec import FAULT_KINDS
from .runtime import NEMESIS_KINDS, scripted_isolate_groups
from .topology import TOPOLOGIES


def _positive_int(v: str) -> int:
    n = int(v)
    if n < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {n}")
    return n


def _nonnegative_int(v: str) -> int:
    n = int(v)
    if n < 0:
        raise argparse.ArgumentTypeError(f"must be >= 0, got {n}")
    return n


def _availability(v):
    if v is None or v == "total":
        return v
    return float(v)


def _parse_schedule_file(path: str, node_count: int):
    """Load a scripted-nemesis JSON file (``[[until_tick, [groups...]],
    ...]``) into ``NemesisConfig.schedule`` phases. Returns
    ``(error_message, schedule)`` — exactly one is truthy."""
    with open(path) as f:
        phases = json.load(f)
    for until, groups in phases:
        for g in groups:
            for m in g:
                if not isinstance(m, int) or not 0 <= m < node_count:
                    return (f"error: schedule group member {m!r} is "
                            f"not a node index in [0, {node_count})",
                            ())
    return None, tuple(
        scripted_isolate_groups(until, [set(g) for g in groups],
                                node_count)
        for until, groups in phases)


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
    p.add_argument("--nemesis-kind", choices=NEMESIS_KINDS,
                   help="partition grudge shape (default random-halves; "
                        "scripted needs --nemesis-schedule-file)")
    p.add_argument("--nemesis-schedule-file", metavar="FILE",
                   help="JSON file of phases [[until_tick, [[node...], "
                        "...]], ...]: traffic allowed only within each "
                        "listed group until the phase's tick (0-based "
                        "node ids; implies --nemesis partition "
                        "--nemesis-kind scripted); healed from "
                        "time_limit - recovery_time on")
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
    p.add_argument("--journal-instances", type=int, default=0,
                   help="per-message journals for the first N instances "
                        "(messages.svg and results.net.journal; adds the "
                        "NETID lane to every row)")
    p.add_argument("--inbox-k", type=int)
    p.add_argument("--pool-slots", type=int)
    p.add_argument("--ms-per-tick", type=int)
    p.add_argument("--log-cap", type=int,
                   help="Raft log capacity per node (lin-kv and its "
                        "mutants; default 96)")
    p.add_argument("--heartbeat-ticks", type=int,
                   help="Raft leader heartbeat cadence in ticks (lin-kv "
                        "and its mutants; default 15)")
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
    p.add_argument("--availability",
                   help="'total' or a fraction like 0.9 of client ops "
                        "that must complete ok")
    p.add_argument("--fail-fast", action="store_true",
                   help="stop issuing chunks once the device's violation "
                        "scan trips (at most one chunk in flight runs "
                        "past it); needs a multi-chunk horizon or "
                        "--pipeline on")
    p.add_argument("--scan-top-k", type=_positive_int,
                   help="violation-scan rows per chunk: the fail-fast "
                        "block names the K earliest tripping instances "
                        "(default 8)")
    p.add_argument("--check-workers", type=_nonnegative_int,
                   default=None,
                   help="checker-farm worker processes for the host "
                        "verdict stage (checkers/pool.py): per-instance "
                        "histories decode and check in parallel, "
                        "streaming per chunk. 0 forces the serial path; "
                        "default auto uses a pool only for >= 16 "
                        "recorded instances on a multi-core host. "
                        "Verdicts are identical at every setting")
    p.add_argument("--check-mode", choices=["farm", "device", "both"],
                   default="farm",
                   help="host verdict routing. `farm` checks every "
                        "recorded instance; `device` keeps per-instance "
                        "summary lanes in the tick (checkers/"
                        "device_summary.py) and routes ONLY flagged "
                        "instances to the farm; `both` runs the farm on "
                        "everything AND audits that every farm-invalid "
                        "instance was device-flagged. Flagged verdicts "
                        "are byte-identical across modes")
    p.add_argument("--no-telemetry", action="store_true")
    p.add_argument("--no-heartbeat", action="store_true",
                   help="do not stream heartbeat.jsonl into the run dir")
    p.add_argument("--pipeline", choices=("auto", "on", "off"))
    p.add_argument("--chunk-ticks", type=int)
    p.add_argument("--seed", type=int)
    p.add_argument("--store", default="store")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions")

    p_watch = sub.add_parser(
        "watch", help="render a run's streaming heartbeat.jsonl")
    p_watch.add_argument("path", help="a store run dir (e.g. store/"
                                      "lin-kv-torch/latest) or a "
                                      "heartbeat.jsonl file")
    p_watch.add_argument("-f", "--follow", action="store_true",
                         help="keep tailing until the run-end record "
                              "(or Ctrl-C); default is one shot")
    p_watch.add_argument("--interval", type=float, default=1.0,
                         help="--follow poll interval in seconds")
    p_watch.add_argument("--campaign", action="store_true",
                         help="campaign dirs: not ported (refused)")

    p_triage = sub.add_parser(
        "triage", help="replay a run's flagged instances and write "
                       "per-instance forensics bundles (spacetime SVG "
                       "+ EDN journal + repro.json)")
    p_triage.add_argument("path", help="a store run dir (complete, fail-"
                                       "fast-stopped, or killed mid-run)")
    p_triage.add_argument("--instance", type=int, action="append",
                          default=[],
                          help="triage this instance id (repeatable; "
                               "default: the run's flagged instances)")
    p_triage.add_argument("--max-instances", type=_positive_int,
                          default=8,
                          help="cap on instances to replay (default 8)")
    p_triage.add_argument("-o", "--out", default=None,
                          help="output directory (default: "
                               "<run-dir>/triage)")
    p_triage.add_argument("--max-svg-events", type=_positive_int,
                          default=1500,
                          help="Lamport SVG event cap; beyond it the "
                               "diagram is annotated '+N elided'")
    p_triage.add_argument("--device", default="cuda",
                          help="torch device of the replay")

    p_shrink = sub.add_parser(
        "shrink", help="minimize a fault run's failing scenario to a "
                       "still-failing plan (triage/instance-<id>/"
                       "shrunk-plan.json)")
    p_shrink.add_argument("path", help="a store run dir of a --fault-"
                                       "fuzz or --fault-plan run with "
                                       "flagged instances")
    p_shrink.add_argument("--instance", type=int, action="append",
                          default=[],
                          help="shrink this instance id (repeatable; "
                               "default: the run's flagged instances)")
    p_shrink.add_argument("--max-instances", type=_positive_int,
                          default=4,
                          help="cap on instances to shrink (default 4)")
    p_shrink.add_argument("--max-attempts", type=_positive_int,
                          default=24,
                          help="replay budget per instance (default 24)")
    p_shrink.add_argument("--device", default="cuda",
                          help="torch device of the replays")
    return ap


def cmd_watch(args) -> int:
    """Render a run's heartbeat: one shot, or ``--follow`` until the
    run-end record arrives or Ctrl-C."""
    from .telemetry.stream import (heartbeat_path, read_heartbeat,
                                   render_chunk_line, render_watch_report)

    if args.campaign:
        print("error: watch --campaign tails a campaign dir; campaigns "
              "are not ported to maelstrom_tpu_torch", file=sys.stderr)
        return 2
    path = heartbeat_path(os.path.realpath(args.path))
    if not os.path.exists(path):
        print(f"error: no heartbeat at {args.path} (heartbeat.jsonl is "
              f"streamed by runs with a --store dir unless "
              f"--no-heartbeat was passed)", file=sys.stderr)
        return 2
    hb = read_heartbeat(path)

    def age():
        try:
            return time.time() - os.path.getmtime(path)
        except OSError:
            return None

    if not args.follow:
        print(render_watch_report(hb, path=args.path, mtime_age_s=age()))
        return 0 if hb["end"] is not None else 3

    h = hb.get("header") or {}
    print(f"run: {h.get('workload', '?')} — {h.get('instances', '?')} "
          f"instances x {h.get('ticks', '?')} ticks, chunk "
          f"{h.get('chunk-ticks', '?')}  [{args.path}]")
    printed = 0
    try:
        while True:
            hb = read_heartbeat(path)
            for rec in hb["chunks"][printed:]:
                print(render_chunk_line(rec), flush=True)
            printed = len(hb["chunks"])
            if hb["end"] is not None:
                end = hb["end"]
                print(f"status: {end.get('status', 'complete')} — "
                      f"{end.get('ticks', '?')} ticks in "
                      f"{end.get('wall-s', '?')}s"
                      + (f", valid? {end['valid?']}"
                         if "valid?" in end else ""))
                v = end.get("first-violation")
                if v:
                    print(f"first violation: instance "
                          f"{v.get('instance')} at tick "
                          f"{v.get('tick')}")
                return 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        print()
        return 130


def cmd_triage(args) -> int:
    """Replay a stored run's flagged instances and write their
    bundles (``checkers/triage.py``)."""
    from .checkers.triage import (TriageError, render_triage_report,
                                  triage_run)

    try:
        summary = triage_run(
            os.path.realpath(args.path), ids=args.instance or None,
            max_instances=args.max_instances, out_root=args.out,
            max_svg_events=args.max_svg_events, device=args.device)
    except TriageError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(render_triage_report(summary))
    return 0


def cmd_shrink(args) -> int:
    """Shrink a fault run's flagged instances' schedules
    (``faults/shrink.py``)."""
    from .faults.shrink import (ShrinkError, render_shrink_report,
                                shrink_run)

    try:
        summary = shrink_run(
            os.path.realpath(args.path), ids=args.instance or None,
            max_instances=args.max_instances,
            max_attempts=args.max_attempts, device=args.device)
    except ShrinkError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(render_shrink_report(summary))
    if summary.get("errors"):
        return 1
    if not summary.get("shrunk") and not summary.get("note"):
        return 1
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)
    if args.cmd != "test":
        return {"watch": cmd_watch, "triage": cmd_triage,
                "shrink": cmd_shrink}[args.cmd](args)
    from .harness import run_torch_test
    from .models import get_model

    opts = {"node_count": args.node_count, "store_root": args.store,
            "check_workers": args.check_workers,
            "check_mode": args.check_mode}
    if args.concurrency is not None:
        c = args.concurrency
        opts["concurrency"] = (int(c[:-1]) * args.node_count
                               if c.endswith("n") else int(c))
    for flag in ("rate", "time_limit", "latency", "latency_dist",
                 "nemesis_interval", "nemesis_kind", "recovery_time",
                 "rpc_timeout", "p_loss", "n_instances", "record_instances",
                 "inbox_k", "pool_slots", "ms_per_tick", "pipeline",
                 "chunk_ticks", "fault_snapshot_every", "scan_top_k",
                 "journal_instances", "seed"):
        v = getattr(args, flag)
        if v is not None:
            opts[flag] = v
    for flag in ("fault_plan", "fault_fuzz"):
        path = getattr(args, flag)
        if path is not None:
            with open(path) as f:
                opts[flag] = json.load(f)
    if args.nemesis_schedule_file:
        err, schedule = _parse_schedule_file(args.nemesis_schedule_file,
                                             args.node_count)
        if err:
            print(err, file=sys.stderr)
            return 2
        # a schedule file implies the scripted partition nemesis
        if "partition" not in args.nemesis:
            args.nemesis = list(args.nemesis) + ["partition"]
        opts["nemesis_kind"] = "scripted"
        opts["nemesis_schedule"] = schedule
    elif args.nemesis_kind == "scripted":
        print("error: --nemesis-kind scripted needs "
              "--nemesis-schedule-file", file=sys.stderr)
        return 2
    if args.nemesis:
        opts["nemesis"] = args.nemesis
    if args.availability is not None:
        opts["availability"] = _availability(args.availability)
    if args.fail_fast:
        opts["fail_fast"] = True
    if args.no_telemetry:
        opts["telemetry"] = False
    if args.no_heartbeat:
        opts["heartbeat"] = False
    raft_kw = {k: v for k, v in (("log_cap", args.log_cap),
                                 ("heartbeat", args.heartbeat_ticks))
               if v is not None}
    if raft_kw and not args.workload.startswith("lin-kv"):
        raise ValueError("--log-cap and --heartbeat-ticks are options of "
                         "lin-kv only (and its mutants)")
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
    summary["perf"]["check"] = perf["phases"]["check"]
    for k in ("checker-errors", "check", "fail-fast", "availability",
              "funnel", "faults", "fault-fuzz"):
        if k in res:
            summary[k] = res[k]
    summary["store-dir"] = res.get("store-dir")
    print(json.dumps(summary))
    return 0 if res["valid?"] is True else 1


if __name__ == "__main__":
    sys.exit(main())
