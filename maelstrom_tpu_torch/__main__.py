"""Command line of the port: ``python -m maelstrom_tpu_torch test -w echo
--bin examples/python/echo.py``.

``test`` runs one workload test on one of three runtimes, as the JAX
CLI's ``test`` (``maelstrom_tpu/cli.py``) does:

- ``--runtime process`` (the default, as in the JAX CLI) spawns
  ``--bin`` as node processes on the host network through
  :func:`runner.run_test` (a ``.py`` node runs under this Python;
  without ``--bin`` it exits 2), with the JAX CLI's options, results
  print and exit codes. It speaks ``--nemesis partition`` only: the
  fault-plan kinds, ``--fault-plan`` and ``--fault-fuzz`` exit 2 with
  the JAX CLI's error. ``--device`` means nothing to it: given, it
  prints a ``note:`` line and the run goes on.
- ``--runtime tpu`` runs a ported workload's fleet
  (``models.WORKLOADS``: lin-kv Raft, the tutorial workloads echo,
  unique-ids, broadcast, g-set, g-counter and pn-counter, kafka, and
  txn-list-append and txn-rw-register over Raft; ``models.MUTANTS``:
  the nine lin-kv Raft mutants and the kafka and txn mutants) through
  :func:`harness.run_torch_test` on ``--device`` (default ``cuda``) and
  prints a JSON summary (verdict, invariants, network counters,
  throughput, the verdict stage's record, device, and the check,
  fail-fast, availability, funnel and fault blocks where the run has
  them). Unset flags take the JAX CLI's defaults
  (``maelstrom_tpu/cli.py:76-272``: 1 node, one client per node, 10
  ops/s, 20 simulated seconds, no latency, a 10 s nemesis interval, 64
  instances, 8 recorded) and ``--recovery-time``, ``--rpc-timeout``,
  ``--inbox-k`` and ``--pool-slots`` the harness's
  (``harness.TORCH_DEFAULTS``), so a JAX command line hands the harness
  the options it hands ``run_tpu_test``. ``--device-profile`` and
  ``--profile-dir`` are the device profiler's (``telemetry/profiler.py``)
  and a ``torch.profiler`` trace's. The flags the JAX CLI's device
  runtime notes and ignores (``--txn``, ``--crash-clients`` off kafka,
  ``--log-stderr``, ``--log-net-send``, ``--log-net-recv``) print its
  note and the run goes on without them; ``--max-txn-length``,
  ``--max-writes-per-key`` and ``--compile-cache`` are taken and not
  used, as there; ``--aot-store DIR|auto|off`` picks the certified store
  of the kernel libraries (``aot_store.py``: a warm store loads them
  without ``nvcc``; ``MAELSTROM_AOT=0`` turns it off).
- ``--runtime native`` runs the workload's fleet on the native C++
  engine (``cpp/engine/sim.cpp``, built with ``g++`` into
  ``build/engine/`` at first use) through
  :func:`native.harness.run_native_test`, with the JAX CLI's refusals
  (a workload outside ``NATIVE_WORKLOADS``, a bad schedule file), its
  ``note:`` lines, options, results print and exit codes, and the store
  under ``<workload>-native``. ``--device`` means nothing to it: given,
  it prints a ``note:`` line and the run goes on.

Exit code 0 when the run is valid, 1 when it is not, 2 when its verdict
is ``"unknown"`` (as the JAX CLI's) and for a bad or missing schedule
file.

``demo`` runs the JAX CLI's self-test matrix (``DEMOS``, its 30 entries
in order): 24 over the bundled nodes under ``examples/python/`` on the
process runtime and six on the native engine, with its verdict lines,
failure list and exit code (1 when an entry is not valid or a mutant is
not caught). ``serve`` browses the store over HTTP (:mod:`serve`),
``doc`` writes ``workloads.md`` and ``protocol.md`` from the RPC schema
registry (:mod:`doc`), with the JAX CLI's flags.

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
  not be shrunk, 2 when the run is no fault run);
- ``watch --campaign CAMPAIGN_DIR`` renders every item's live row (0
  once every item is done or failed, 3 before).

``triage`` and ``shrink`` replay on ``--device`` (``cuda`` by default),
with the run's own options from its heartbeat (``check_mode`` and
``check_workers`` included).

The store commands read a stored run's directory and touch no device,
with the JAX CLI's flags, output and exit codes:

- ``profile RUN_DIR`` renders the per-phase device time of a profiled
  run and names the hot scope (2 when the run has none);
- ``check RUN_DIR`` re-runs the checkers of the workload (the model
  registry's, a mutant's base workload's) on each recorded history (0
  valid, 1 invalid, 2 unknown or unusable);
- ``export RUN_DIR`` writes the histories as Jepsen EDN, one vector per
  file (``--maps``: line-delimited op maps; ``-o`` a file, a directory
  or ``-`` for standard output);
- ``fleet-stats RUN_DIR`` renders ``fleet-metrics.json`` as text and
  re-renders its SVG dashboards (``--no-svg``: text only).

``campaign submit|run|status|resume|report`` is the durable campaign
control plane (``campaign/``), with the JAX CLI's arguments and exit
codes: ``submit SPEC`` expands a sweep into a queued campaign dir;
``run DIR`` drains it on ``--device``, each item checkpointing its
carry (1 if an item failed or was invalid); ``resume DIR`` requeues a
dead worker's items and drains them, each resumed from its checkpoint,
or finishes one killed run dir in place; ``status`` and ``report``
render the live table and the trend summary. A spec, queue or
checkpoint that cannot be used exits 2.

``lint`` runs the static passes (``analysis/``) with the JAX CLI's
flags: the trace-hygiene, contract and wire-schema passes by default,
``--pass`` to pick, file ``paths`` for the trace pass alone, the port's
``analysis/baseline.json`` unless ``--baseline``/``--no-baseline``;
``--strict`` exits 1 on an unsuppressed error finding, else 0. The
opt-in passes over the aten graph of the tick run when named: ``--ir``
(JXP4xx), ``--cost`` with ``--update-baseline`` / ``--cost-baseline``
(COST5xx), ``--lanes`` with ``--update-manifest`` /
``--lane-manifest`` (LNE6xx) and ``--ranges`` with ``--update-ranges``
/ ``--range-manifest`` / ``--ranges-horizon-log2`` (ABS7xx), the shard
pass over the mesh executor ``--shard`` with
``--update-shard-manifest`` / ``--shard-manifest`` (SHD8xx) and the
audit of the kernel-library store ``--aot`` with ``--update-aot`` /
``--aot-manifest`` / ``--aot-store`` (EXE9xx), or ``--pass
ir|cost|lanes|ranges|shard|aot``. It touches no device: it loads no
kernel library and creates no CUDA context.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

from .analysis.runner import ALL_PASSES, EXTRA_PASSES
from .faults.spec import FAULT_KINDS
from .runtime import NEMESIS_KINDS, scripted_isolate_groups
from .topology import TOPOLOGIES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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


def _bin_cmd(bin_path: str, args: List[str]):
    """Resolve --bin into (bin, argv): .py files run under this python."""
    if bin_path.endswith(".py"):
        return sys.executable, [bin_path] + args
    return bin_path, args


def parse_concurrency(value: str, node_count: int) -> int:
    """'10' -> 10, '4n' -> 4 * node_count."""
    if value.endswith("n"):
        return int(value[:-1]) * node_count
    return int(value)


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
    p = sub.add_parser("test", help="run one workload test")
    p.add_argument("-w", "--workload", required=True,
                   help="workload name (echo, broadcast, g-set, "
                        "g-counter, pn-counter, lin-kv, unique-ids, ...; "
                        "the device runtime also takes the mutants); any "
                        "other name raises")
    p.add_argument("--bin", help="node binary (process runtime)")
    p.add_argument("--runtime", choices=("process", "tpu", "native"),
                   default="process",
                   help="process (default) spawns --bin as node "
                        "processes on a host network; tpu runs the "
                        "device runtime; native runs the C++ engine "
                        "(cpp/engine) on the host")
    p.add_argument("--node-count", type=int, default=1)
    p.add_argument("--topology", default="grid", choices=sorted(TOPOLOGIES),
                   help="gossip topology of broadcast and g-set")
    p.add_argument("--concurrency", default="1n",
                   help="clients per instance: N, or Kn for K per node")
    p.add_argument("--rate", type=float, default=10.0,
                   help="ops/sec per instance")
    p.add_argument("--time-limit", type=float, default=20.0,
                   help="simulated seconds")
    p.add_argument("--latency", type=float, default=0.0,
                   help="mean latency, ms")
    p.add_argument("--latency-dist", default="exponential",
                   choices=("constant", "uniform", "exponential"))
    p.add_argument("--nemesis", action="append", default=[],
                   choices=("partition",) + FAULT_KINDS,
                   help="fault kinds, composable (repeat the flag): the "
                        "partition nemesis, and the fault-plan lanes "
                        "generated on the nemesis interval grid")
    p.add_argument("--nemesis-interval", type=float, default=10.0)
    p.add_argument("--nemesis-kind", choices=NEMESIS_KINDS,
                   default="random-halves",
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
    p.add_argument("--p-loss", type=float, default=0.0)
    p.add_argument("--n-instances", type=int, default=64)
    p.add_argument("--record-instances", type=int, default=8)
    p.add_argument("--journal-instances", type=int, default=0,
                   help="per-message journals for the first N instances "
                        "(messages.svg and results.net.journal; adds the "
                        "NETID lane to every row)")
    p.add_argument("--inbox-k", type=int)
    p.add_argument("--pool-slots", type=int)
    p.add_argument("--ms-per-tick", type=_positive_int, default=1)
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
                   help="kafka: issue multi-mop send/poll transactions "
                        "(process runtime; the device runtime notes and "
                        "ignores it)")
    p.add_argument("--max-txn-length", type=int,
                   help="process-runtime generator knob (the device "
                        "runtime takes it and does not use it)")
    p.add_argument("--max-writes-per-key", type=int,
                   help="process-runtime generator knob (the device "
                        "runtime takes it and does not use it)")
    for flag in ("--log-stderr", "--log-net-send", "--log-net-recv"):
        p.add_argument(flag, action="store_true",
                       help="process runtime: copy node stderr / network "
                            "sends / receives to the console (the device "
                            "runtime notes and ignores it)")
    p.add_argument("--availability",
                   help="'total' or a fraction like 0.9 of client ops "
                        "that must complete ok")
    p.add_argument("--fail-fast", action="store_true",
                   help="stop issuing chunks once the device's violation "
                        "scan trips (at most one chunk in flight runs "
                        "past it); needs a multi-chunk horizon or "
                        "--pipeline on")
    p.add_argument("--scan-top-k", type=_positive_int, default=8,
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
    p.add_argument("--telemetry-stride", type=int, default=0,
                   help="ticks per fleet-series window (0 = auto, <= 256 "
                        "windows)")
    p.add_argument("--event-capacity", type=_nonnegative_int, default=0,
                   help="compacted event rows per chunk (0 = auto from "
                        "the client rate; overflow is flagged in "
                        "results.perf.phases.pipeline)")
    p.add_argument("--device-profile", choices=("auto", "on", "off"),
                   default="auto",
                   help="per-chunk device time by phase (telemetry/"
                        "profiler.py): auto (default) captures the first "
                        "chunks then every 8th, on every chunk, off none. "
                        "Captured chunks gain the heartbeat's device-ms "
                        "lane and feed results.perf.phases.device and "
                        "`profile`; trajectories are the same either way")
    p.add_argument("--profile-dir",
                   help="a torch.profiler session over the run, its "
                        "Chrome trace written into this directory")
    p.add_argument("--compile-cache", default=".jax_cache",
                   help="the JAX CLI's compile cache: accepted and not "
                        "used (the port compiles nothing per run)")
    p.add_argument("--aot-store", default="auto",
                   help="the certified store of the kernel libraries "
                        "(aot_store.py): a directory, auto (default: "
                        "build/aot) or off; a warm store loads them "
                        "without nvcc (MAELSTROM_AOT=0 disables)")
    p.add_argument("--no-heartbeat", action="store_true",
                   help="do not stream heartbeat.jsonl into the run dir")
    p.add_argument("--pipeline", choices=("auto", "on", "off"),
                   default="auto")
    p.add_argument("--chunk-ticks", type=_positive_int, default=100)
    p.add_argument("--checkpoint-every", type=_nonnegative_int,
                   default=0,
                   help="durable carry checkpoint every K chunks (0 = "
                        "off). A checkpointed run killed at any point "
                        "resumes in place with `campaign resume "
                        "<run-dir>`; needs --store and the chunked "
                        "executor")
    p.add_argument("--seed", type=int)
    p.add_argument("--store", default="store")
    p.add_argument("--device", default=None,
                   help="device runtime: torch device (default cuda); "
                        "'cpu' runs the plain versions. The process "
                        "and native runtimes note and ignore it")

    p_demo = sub.add_parser("demo", help="run the self-test demo matrix")
    p_demo.add_argument("--time-limit", type=float, default=5.0)
    p_demo.add_argument("--store", default="store")

    p_serve = sub.add_parser("serve", help="browse the store over HTTP")
    p_serve.add_argument("--port", type=int, default=8080)
    p_serve.add_argument("--store", default="store")

    p_doc = sub.add_parser("doc", help="regenerate schema-driven docs")
    p_doc.add_argument("--out", default="doc")

    p_check = sub.add_parser(
        "check", help="re-run checkers offline on a stored history")
    p_check.add_argument("path", help="a store run dir (e.g. store/"
                                      "lin-kv-torch/latest) or a "
                                      "history.jsonl file")
    p_check.add_argument("-w", "--workload", default=None,
                         help="workload name (inferred from a store dir"
                              " path)")
    p_check.add_argument("--availability", default=None)
    p_check.add_argument("--consistency-models", default=None,
                         choices=["read-uncommitted", "read-committed",
                                  "read-atomic", "snapshot-isolation",
                                  "serializable", "strict-serializable"])

    p_export = sub.add_parser(
        "export", help="export a stored history as Jepsen-compatible "
                       "EDN for stock Elle/Knossos")
    p_export.add_argument("path", help="a store run dir or a "
                                       "history.jsonl file")
    p_export.add_argument("-w", "--workload", default=None,
                          help="workload name (inferred from a store "
                               "dir path)")
    p_export.add_argument("-o", "--out", default=None,
                          help="output .edn file, directory, or '-' "
                               "for stdout (default: next to the input)")
    p_export.add_argument("--maps", action="store_true",
                          help="emit line-delimited op maps instead of "
                               "one EDN vector (history.edn shape)")

    p_fleet = sub.add_parser(
        "fleet-stats", help="render a stored run's fleet telemetry "
                            "report and its SVG dashboards")
    p_fleet.add_argument("path", help="a store run dir or a "
                                      "fleet-metrics.json file")
    p_fleet.add_argument("-o", "--out", default=None,
                         help="directory for the SVG dashboards "
                              "(default: the run dir)")
    p_fleet.add_argument("--no-svg", action="store_true",
                         help="text report only")

    p_profile = sub.add_parser(
        "profile", help="render a stored run's per-phase device-time "
                        "table and name the hot scope")
    p_profile.add_argument("path", help="a store run dir with heartbeat "
                                        "device-ms lanes and/or a "
                                        "results.json perf.phases.device "
                                        "roll-up")

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
                         help="PATH is a campaign dir: render every "
                              "item's live row (merged heartbeats); "
                              "-f re-renders until every item is done "
                              "or failed")

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

    p_camp = sub.add_parser(
        "campaign", help="durable sweep campaigns: submit a work-queue "
                         "matrix, drain and resume it across process "
                         "deaths, aggregate trend reports")
    camp_sub = p_camp.add_subparsers(dest="action", required=True)
    c_submit = camp_sub.add_parser(
        "submit", help="expand a campaign spec (JSON; TOML on Python "
                       "3.11+) into a queued campaign dir")
    c_submit.add_argument("path", help="campaign spec file")
    c_submit.add_argument("--store", default="store")
    c_run = camp_sub.add_parser(
        "run", help="drain the queue: claim items and run them through "
                    "the chunked executor with periodic carry "
                    "checkpoints; exit 1 if any item failed or was "
                    "invalid")
    c_run.add_argument("path", help="campaign dir (from submit)")
    c_run.add_argument("--max-items", type=_positive_int, default=None)
    c_run.add_argument("--checkpoint-every", type=_nonnegative_int,
                       default=None,
                       help="chunks between carry checkpoints "
                            "(default 4; 0 disables)")
    c_run.add_argument("--compile-cache", default=None,
                       help="the JAX CLI's compile cache: accepted and "
                            "not used (the port compiles nothing per "
                            "run)")
    c_run.add_argument("--aot-store", default=None,
                       help="the items' store of the kernel libraries "
                            "(a directory, auto or off; default: the "
                            "items' own option, auto)")
    c_run.add_argument("--triage", action="store_true",
                       help="run `triage` on each invalid item's run dir")
    c_run.add_argument("--device", default="cuda",
                       help="torch device of the runs")
    c_status = camp_sub.add_parser(
        "status", help="merge every item's heartbeat into one live "
                       "table")
    c_status.add_argument("path", help="campaign dir")
    c_resume = camp_sub.add_parser(
        "resume", help="campaign dir: requeue dead workers' items and "
                       "drain (each resumes from its checkpoint); run "
                       "dir: finish that one run in place, equal to an "
                       "uninterrupted run")
    c_resume.add_argument("path", help="campaign dir or run dir")
    c_resume.add_argument("--max-items", type=_positive_int,
                          default=None)
    c_resume.add_argument("--force", action="store_true",
                          help="also requeue running items with no or "
                               "foreign locks (lost remote worker)")
    c_resume.add_argument("--triage", action="store_true",
                          help="triage invalid items")
    c_resume.add_argument("--device", default="cuda",
                          help="torch device of the runs")
    c_report = camp_sub.add_parser(
        "report", help="aggregate completed items into "
                       "<campaign>/summary.json trend rows")
    c_report.add_argument("path", help="campaign dir")
    c_report.add_argument("--no-static-cost", action="store_true",
                          help="leave out the ir-bytes-est column "
                               "(the static cost of each item's config, "
                               "analysis/cost_model.py)")

    p_lint = sub.add_parser(
        "lint", help="static analysis: the trace-hygiene, contract and "
                     "wire-schema passes, and the opt-in passes over the "
                     "aten graph of the tick (ir, cost, lanes, ranges)")
    p_lint.add_argument("paths", nargs="*",
                        help="restrict the trace-hygiene pass to these "
                             "files (other passes then run only when "
                             "named with --pass)")
    p_lint.add_argument("--strict", action="store_true",
                        help="exit 1 on any unsuppressed error-severity "
                             "finding")
    p_lint.add_argument("--json", action="store_true",
                        help="machine-readable findings on stdout")
    p_lint.add_argument("--pass", dest="passes", action="append",
                        choices=list(ALL_PASSES) + list(EXTRA_PASSES),
                        help="run only the named pass(es); default "
                             "trace+contract+schema (ir/cost/lanes/ranges/"
                             "shard/aot are opt-in: they record every "
                             "registered model or the dispatch)")
    p_lint.add_argument("--ir", action="store_true",
                        help="run the IR hazard pass (JXP4xx) over the "
                             "aten graph of the tick of every registered "
                             "model x both carry layouts")
    p_lint.add_argument("--cost", action="store_true",
                        help="run the cost-budget gate (COST5xx): the "
                             "static tick cost of every registered model "
                             "x both carry layouts vs "
                             "analysis/cost_baseline.json; >10%% "
                             "regression is an error")
    p_lint.add_argument("--update-baseline", action="store_true",
                        help="re-record analysis/cost_baseline.json from "
                             "the current tree (implies --cost)")
    p_lint.add_argument("--cost-baseline", default=None,
                        help="cost-baseline file (default "
                             "maelstrom_tpu_torch/analysis/"
                             "cost_baseline.json)")
    p_lint.add_argument("--lanes", action="store_true",
                        help="run the lane-liveness pass (LNE6xx): the "
                             "backward slice of the tick of every "
                             "registered model x both carry layouts, "
                             "gated against "
                             "analysis/lane_manifest.json")
    p_lint.add_argument("--update-manifest", action="store_true",
                        help="re-record analysis/lane_manifest.json from "
                             "the current tree (implies --lanes)")
    p_lint.add_argument("--lane-manifest", default=None,
                        help="lane-manifest file (default "
                             "maelstrom_tpu_torch/analysis/"
                             "lane_manifest.json)")
    p_lint.add_argument("--ranges", action="store_true",
                        help="run the value-range pass (ABS7xx): the "
                             "interval abstract interpretation of the tick "
                             "of every registered model x both carry "
                             "layouts, gated against "
                             "analysis/range_manifest.json")
    p_lint.add_argument("--update-ranges", action="store_true",
                        help="re-record analysis/range_manifest.json from "
                             "the current tree (implies --ranges)")
    p_lint.add_argument("--range-manifest", default=None,
                        help="range-manifest file (default "
                             "maelstrom_tpu_torch/analysis/"
                             "range_manifest.json)")
    p_lint.add_argument("--ranges-horizon-log2", type=int, default=None,
                        help="probe this horizon (log2 ticks) instead of "
                             "the default 2^24, and gate ABS701 on it")
    p_lint.add_argument("--shard", action="store_true",
                        help="run the shard pass (SHD8xx): the collective "
                             "census of the sharded chunk of every "
                             "registered model x both carry layouts vs "
                             "analysis/shard_manifest.json, the "
                             "replicated-params and reshard checks")
    p_lint.add_argument("--update-shard-manifest", action="store_true",
                        help="re-record analysis/shard_manifest.json from "
                             "the current tree (implies --shard)")
    p_lint.add_argument("--shard-manifest", default=None,
                        help="shard-manifest file (default "
                             "maelstrom_tpu_torch/analysis/"
                             "shard_manifest.json)")
    p_lint.add_argument("--aot", action="store_true",
                        help="run the aot pass (EXE9xx): the "
                             "certificates of the chunk dispatch in both "
                             "carry layouts and of the sharded one vs "
                             "analysis/"
                             "aot_manifest.json, and every entry of the "
                             "kernel-library store")
    p_lint.add_argument("--update-aot", action="store_true",
                        help="re-record analysis/aot_manifest.json "
                             "(implies --aot); with an explicit "
                             "--aot-store DIR also populate that store")
    p_lint.add_argument("--aot-manifest", default=None,
                        help="aot-manifest file (default "
                             "maelstrom_tpu_torch/analysis/"
                             "aot_manifest.json)")
    p_lint.add_argument("--aot-store", default=None,
                        help="the store the aot pass audits: a directory, "
                             "auto (default: build/aot) or off")
    p_lint.add_argument("--baseline", default=None,
                        help="baseline file (default "
                             "maelstrom_tpu_torch/analysis/baseline.json)")
    p_lint.add_argument("--no-baseline", action="store_true",
                        help="ignore the baseline: report and gate on "
                             "every finding, including expected fixtures")
    p_lint.add_argument("--root", default=REPO,
                        help="repo root to lint (default: this checkout)")
    return ap


def cmd_lint(args) -> int:
    """Run the analysis passes; --strict turns error findings into a
    nonzero exit."""
    from .analysis import render_text, run_lint
    from .analysis.findings import DEFAULT_BASELINE

    # None = runner default (the default passes; trace-only when paths
    # restrict). --ir / --cost / --lanes / --ranges / --shard / --aot
    # name the opt-in passes (--update-baseline implies --cost,
    # --update-manifest --lanes, --update-ranges --ranges,
    # --update-shard-manifest --shard, --update-aot --aot)
    passes = list(args.passes) if args.passes else []
    if args.ir:
        passes.append("ir")
    if args.cost or args.update_baseline:
        passes.append("cost")
    if args.lanes or args.update_manifest:
        passes.append("lanes")
    if args.ranges or args.update_ranges:
        passes.append("ranges")
    if args.shard or args.update_shard_manifest:
        passes.append("shard")
    if args.aot or args.update_aot:
        passes.append("aot")
    baseline = None if args.no_baseline else (args.baseline
                                              or DEFAULT_BASELINE)
    report = run_lint(repo_root=args.root,
                      passes=tuple(dict.fromkeys(passes)) or None,
                      paths=args.paths or None, baseline_path=baseline,
                      cost_baseline_path=args.cost_baseline,
                      update_cost_baseline=args.update_baseline,
                      lane_manifest_path=args.lane_manifest,
                      update_lane_manifest=args.update_manifest,
                      range_manifest_path=args.range_manifest,
                      update_range_manifest=args.update_ranges,
                      ranges_horizon_log2=args.ranges_horizon_log2,
                      shard_manifest_path=args.shard_manifest,
                      update_shard_manifest=args.update_shard_manifest,
                      aot_manifest_path=args.aot_manifest,
                      update_aot_manifest=args.update_aot,
                      aot_store_path=args.aot_store)
    if args.json:
        print(json.dumps(report.to_json(), indent=2))
    else:
        print(render_text(report))
    if args.strict and report.errors():
        return 1
    return 0


# --- the store commands (no device) -----------------------------------------


def _resolve_history_paths(path: str, workload_arg, verb: str):
    """A store run dir (or a bare history file) as ``(paths,
    workload_name, device_store)``; raises ValueError with the message
    for the user. A run dir's parent names the workload: the port's
    ``<workload>-torch``, the JAX package's ``<workload>-tpu`` and
    ``<workload>-native`` (the mutant suffix is kept; callers strip it
    where they need the base workload)."""
    import glob

    path = os.path.realpath(path)
    device_store = False
    if os.path.isdir(path):
        paths = sorted(glob.glob(os.path.join(path, "history*.jsonl")))
        if not paths:
            raise ValueError(f"no history*.jsonl under {path}")
        inferred = os.path.basename(os.path.dirname(path))
        for suffix in ("-torch", "-tpu", "-native"):
            if inferred.endswith(suffix):
                # one history per recorded instance, no node logs
                inferred, device_store = inferred[:-len(suffix)], True
                break
    else:
        paths, inferred = [path], None
    workload_name = workload_arg or inferred
    if not workload_name:
        raise ValueError(f"pass -w/--workload when {verb} a bare "
                         f"history file")
    return paths, workload_name, device_store


def _load_history_records(p: str):
    """One history.jsonl, its torn tail (a run killed mid-write)
    skipped with a warning."""
    records, bad = [], 0
    with open(p) as f:
        for line in f:
            if not line.strip():
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                bad += 1
    if bad:
        print(f"warning: {p}: skipped {bad} unparseable line(s)",
              file=sys.stderr)
    return records


def cmd_check(args) -> int:
    """Re-run the checkers on a stored run's histories: per recorded
    history the workload's checker (the model registry's), over their
    union the fleet stats and availability, as the live harness
    composes them."""
    from .checkers import check_history, checker_failure, compose_valid
    from .checkers.availability import availability_checker
    from .checkers.perf import stats_checker
    from .models import get_model

    try:
        paths, workload_name, device_store = _resolve_history_paths(
            args.path, args.workload, "checking")
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    # a mutant checks with its base workload's checker
    workload_name = workload_name.split("-bug-")[0]
    try:
        checker = get_model(workload_name, 3).checker()
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    opts = {"availability": _availability(args.availability)}
    if args.consistency_models:
        opts["consistency_models"] = args.consistency_models

    histories = [_load_history_records(p) for p in paths]

    if len(histories) == 1 and not device_store:
        results = check_history(histories[0], opts, checker,
                                name=f"{workload_name}-checker")
    else:
        # one verdict per recorded instance; stats and availability over
        # the union (informational stats: a recorded instance with no
        # ok op under a hostile schedule is not a safety failure)
        per_history = []
        for h in histories:
            try:
                per_history.append(checker(h, opts))
            except Exception as e:
                per_history.append(checker_failure(
                    e, checker=f"{workload_name}-checker",
                    instance=len(per_history)))
        union = [r for h in histories for r in h]
        stats = stats_checker(union)
        stats.pop("valid?", None)
        results = {
            "instances": {os.path.basename(p): r
                          for p, r in zip(paths, per_history)},
            "stats": stats,
            "availability": availability_checker(
                union, opts["availability"]),
        }
        results["valid?"] = compose_valid(
            [r.get("valid?", True) for r in per_history]
            + [results["availability"].get("valid?", True)])
    results["workload-name"] = workload_name
    print(json.dumps(results, indent=2, default=repr))
    verdict = results["valid?"]
    if verdict is True:
        return 0
    return 2 if verdict == "unknown" else 1


def cmd_export(args) -> int:
    """A stored run's histories as Jepsen EDN op maps, for stock Elle or
    Knossos: by default one EDN vector per history (Jepsen's
    ``history.edn``), with ``--maps`` line-delimited maps."""
    from .utils.edn import (history_to_edn_lines,
                            history_to_edn_vector_lines)

    to_lines = (history_to_edn_lines if args.maps
                else history_to_edn_vector_lines)
    try:
        paths, workload, _ = _resolve_history_paths(
            args.path, args.workload, "exporting")
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.out and args.out.endswith(".edn") and len(paths) > 1:
        print(f"error: -o {args.out} names one file but the run has "
              f"{len(paths)} history shards; pass a directory",
              file=sys.stderr)
        return 2
    if args.out == "-" and len(paths) > 1 and not args.maps:
        # concatenated vectors are not one readable EDN form
        print(f"error: the run has {len(paths)} history shards, which "
              f"cannot share stdout as EDN vectors; pass a directory "
              f"(one vector per file) or --maps", file=sys.stderr)
        return 2

    for p in paths:
        records = _load_history_records(p)
        if args.out == "-":
            for line in to_lines(records, workload):
                print(line)
        else:
            base = os.path.basename(p).replace(".jsonl", ".edn")
            dest = (args.out if args.out and args.out.endswith(".edn")
                    else os.path.join(args.out or os.path.dirname(p),
                                      base))
            os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
            with open(dest, "w") as f:
                for line in to_lines(records, workload):
                    f.write(line + "\n")
            print(f"wrote {dest} ({len(records)} ops)", file=sys.stderr)
    return 0


def cmd_fleet_stats(args) -> int:
    """A stored run's fleet telemetry: the text report on standard
    output and the rate, drop and latency SVG dashboards re-rendered
    from ``fleet-metrics.json``."""
    from .telemetry.fleet import (FLEET_METRICS_FILE, load_fleet_metrics,
                                  render_report, write_fleet_svgs)

    path = os.path.realpath(args.path)
    try:
        metrics = load_fleet_metrics(path)
    except OSError as e:
        print(f"error: no {FLEET_METRICS_FILE} at {args.path} ({e}); "
              f"fleet metrics are written by TPU-runtime runs unless "
              f"--no-telemetry was passed", file=sys.stderr)
        return 2
    except json.JSONDecodeError as e:
        print(f"error: unparseable fleet metrics at {args.path}: {e}",
              file=sys.stderr)
        return 2
    run_dir = path if os.path.isdir(path) else os.path.dirname(path)
    phases = None
    try:
        with open(os.path.join(run_dir, "results.json")) as f:
            phases = json.load(f).get("perf", {}).get("phases")
    except (OSError, json.JSONDecodeError):
        pass
    print(render_report(metrics, phases=phases))
    if not args.no_svg:
        out_dir = args.out or run_dir
        os.makedirs(out_dir, exist_ok=True)
        for p in write_fleet_svgs(metrics, out_dir):
            print(f"wrote {p}", file=sys.stderr)
    return 0


def cmd_profile(args) -> int:
    """A stored run's per-phase device-time table and its hot scope
    (``telemetry/profiler.py``); 2 when the run has no device time."""
    from .telemetry.profiler import render_profile_report

    path = os.path.realpath(args.path)
    report = render_profile_report(path)
    if report is None:
        print(f"error: no device-time records at {args.path} — "
              f"device time is captured by chunked TPU-runtime runs "
              f"unless --device-profile off was passed (old run dirs "
              f"predate the lane)", file=sys.stderr)
        return 2
    print(report)
    return 0


def _watch_campaign(args) -> int:
    """``watch --campaign``: every item of a campaign dir in one table,
    re-rendered each poll with ``--follow`` until every item is done or
    failed."""
    from .campaign.queue import DONE, FAILED, QueueError
    from .campaign.report import campaign_status, render_status

    try:
        status = campaign_status(args.path)
    except QueueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if not args.follow:
        print(render_status(status))
        settled = all(r["status"] in (DONE, FAILED)
                      for r in status["items"])
        return 0 if settled else 3
    try:
        while True:
            status = campaign_status(args.path)
            print(render_status(status), flush=True)
            if all(r["status"] in (DONE, FAILED)
                   for r in status["items"]):
                return 0
            time.sleep(args.interval)
            print()
    except KeyboardInterrupt:
        print()
        return 130


def cmd_watch(args) -> int:
    """Render a run's heartbeat: one shot, or ``--follow`` until the
    run-end record arrives or Ctrl-C."""
    from .telemetry.stream import (heartbeat_path, read_heartbeat,
                                   render_chunk_line, render_watch_report)

    if args.campaign:
        return _watch_campaign(args)
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


def _drained(summary) -> int:
    print(f"\nran {summary['ran']} item(s): {summary['done']} done "
          f"({summary['invalid']} invalid), {summary['failed']} failed")
    return 1 if (summary["failed"] or summary["invalid"]) else 0


def cmd_campaign(args) -> int:
    """The durable campaign control plane (``campaign/``)."""
    from .campaign.checkpoint import CheckpointError
    from .campaign.queue import (QueueError, load_campaign,
                                 requeue_stale, submit_campaign)
    from .campaign.report import (campaign_report, campaign_status,
                                  render_report, render_status)
    from .campaign.runner import resume_run, run_campaign
    from .campaign.spec import SpecError, load_spec

    try:
        if args.action == "submit":
            cdir = submit_campaign(load_spec(args.path), args.store)
            meta = load_campaign(cdir)
            print(f"submitted campaign {meta['name']!r}: "
                  f"{meta['n-items']} item(s)")
            print(cdir)
            return 0
        if args.action == "run":
            requeued = requeue_stale(args.path)
            if requeued:
                print(f"requeued {len(requeued)} preempted item(s): "
                      f"{requeued}")
            # only explicit flags override the items' spec options
            overrides = {k: getattr(args, k) for k in (
                "checkpoint_every", "compile_cache", "aot_store")
                if getattr(args, k) is not None}
            return _drained(run_campaign(
                args.path, max_items=args.max_items, overrides=overrides,
                triage_invalid=args.triage, device=args.device))
        if args.action == "status":
            print(render_status(campaign_status(args.path)))
            return 0
        if args.action == "resume":
            if os.path.exists(os.path.join(args.path, "campaign.json")):
                # a campaign dir: requeue dead work, then drain it
                requeued = requeue_stale(args.path, force=args.force)
                print(f"requeued {len(requeued)} preempted item(s)"
                      + (f": {requeued}" if requeued else ""))
                return _drained(run_campaign(
                    args.path, max_items=args.max_items,
                    triage_invalid=args.triage, device=args.device))
            # a run dir: finish it in place
            results = resume_run(os.path.realpath(args.path),
                                 device=args.device)
            print(json.dumps(results, indent=2, default=repr))
            verdict = results.get("valid?")
            return 0 if verdict is True else (
                2 if verdict == "unknown" else 1)
        if args.action == "report":
            summary = campaign_report(
                args.path, static_cost=not args.no_static_cost)
            print(render_report(summary))
            print(f"\nwrote {os.path.join(args.path, 'summary.json')}")
            return 0
    except (SpecError, QueueError, CheckpointError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    raise AssertionError(f"unhandled campaign action {args.action!r}")


DEMOS = [
    # (workload, node [+ args], extra opts[, expect_valid]) —
    # core.clj:104-126's matrix, over the bundled python nodes.
    # expect_valid=False entries are the bug-injection corpus run
    # end-to-end: the demo FAILS if the checker does NOT catch them
    ("echo", "echo.py", {}),
    ("echo", "echo.py", {"node_count": 2}),
    ("broadcast", "broadcast.py", {"node_count": 5, "topology": "grid"}),
    ("broadcast", "broadcast.py",
     {"node_count": 5, "topology": "tree4", "nemesis": ["partition"],
      "nemesis_interval": 2.0, "recovery_time": 2.0}),
    ("g-set", "g_set.py",
     {"node_count": 3, "nemesis": ["partition"], "nemesis_interval": 2.0,
      "recovery_time": 2.0}),
    ("pn-counter", "pn_counter.py", {"node_count": 3,
                                     "recovery_time": 1.0}),
    ("g-counter", "pn_counter.py", {"node_count": 3,
                                    "recovery_time": 1.0}),
    ("g-counter", "counter_seq_kv.py", {"node_count": 3,
                                        "recovery_time": 1.0}),
    ("unique-ids", "unique_ids.py",
     {"node_count": 3, "availability": "total"}),
    ("lin-kv", "lin_kv_proxy.py", {"node_count": 2}),
    ("lin-kv", "raft.py",
     {"node_count": 3, "rate": 20.0, "nemesis": ["partition"],
      "nemesis_interval": 3.0, "recovery_time": 2.0}),
    ("lin-kv", "paxos.py",
     {"node_count": 5, "rate": 10.0, "nemesis": ["partition"],
      "nemesis_interval": 3.0, "recovery_time": 2.0}),
    ("txn-list-append", "txn_single.py", {"node_count": 1, "rate": 20.0}),
    ("txn-list-append", "datomic_txn.py", {"node_count": 3,
                                           "rate": 15.0}),
    ("txn-list-append", "datomic_list_append.py",
     {"node_count": 3, "rate": 15.0}),
    ("txn-rw-register", "txn_single.py", {"node_count": 1,
                                          "rate": 20.0}),
    # HAT (Bailis et al.): totally available under partitions, weak
    # isolation — passes read-uncommitted; serializable rightly fails it
    # (tests/test_e2e_process.py::test_hat_isolation_tradeoff)
    ("txn-rw-register", "txn_rw_hat.py",
     {"node_count": 3, "rate": 15.0, "nemesis": ["partition"],
      "nemesis_interval": 2.0, "recovery_time": 2.0,
      "availability": "total",
      "consistency_models": "read-uncommitted"}),
    ("txn-list-append", "txn_thunks.py", {"node_count": 3,
                                          "rate": 15.0}),
    ("lin-kv", "raft.py",
     {"node_count": 5, "rate": 15.0, "nemesis": ["partition"],
      "nemesis_interval": 3.0, "recovery_time": 2.0}),
    ("kafka", "kafka_single.py", {"node_count": 1, "rate": 20.0}),
    ("kafka", "kafka_single.py",
     {"node_count": 1, "rate": 20.0, "crash_clients": True}),
    ("kafka", "kafka_lin_kv.py", {"node_count": 3, "rate": 15.0}),
    # atomic transactions end-to-end: the single-root transactor passes
    # under multi-mop --txn load; its --no-atomic mutant (durable sends
    # from aborted txns) must be CAUGHT via the aborted-read anomaly
    ("kafka", "kafka_txn.py",
     {"node_count": 3, "rate": 15.0, "txn": True}),
    ("kafka", "kafka_txn.py --no-atomic",
     {"node_count": 3, "rate": 25.0, "txn": True}, False),
    # the native C++ engine's slice of the matrix (runtime "native":
    # no node binary — the engine IS the cluster), including its own
    # must-be-caught mutants
    ("lin-kv", "(native engine)",
     {"runtime": "native", "n_instances": 64, "record_instances": 4,
      "nemesis": ["partition"], "nemesis_interval": 0.4,
      "p_loss": 0.05, "recovery_time": 0.3, "rate": 200.0,
      "time_limit": 2.0, "threads": 1}),
    ("txn-list-append", "(native engine, dirty-apply mutant)",
     {"runtime": "native", "n_instances": 64, "record_instances": 8,
      "nemesis": ["partition"], "nemesis_interval": 0.3,
      "p_loss": 0.05, "recovery_time": 0.3, "rate": 200.0,
      "time_limit": 3.0, "threads": 1, "txn_dirty_apply": True},
     False),
    ("broadcast", "(native engine, tree2 topology)",
     {"runtime": "native", "n_instances": 48, "record_instances": 4,
      "node_count": 5, "topology": "tree2", "nemesis": ["partition"],
      "nemesis_interval": 0.3, "p_loss": 0.05, "recovery_time": 0.4,
      "rate": 200.0, "time_limit": 2.0, "read_prob": 0.1,
      "threads": 1}),
    ("unique-ids", "(native engine, collision mutant)",
     {"runtime": "native", "n_instances": 48, "record_instances": 4,
      "nemesis": ["partition"], "nemesis_interval": 0.3,
      "p_loss": 0.05, "recovery_time": 0.4, "rate": 200.0,
      "time_limit": 2.0, "threads": 1, "gset_no_gossip": True},
     False),
    ("txn-rw-register", "(native engine)",
     {"runtime": "native", "n_instances": 48, "record_instances": 4,
      "nemesis": ["partition"], "nemesis_interval": 0.3,
      "p_loss": 0.05, "recovery_time": 0.3, "rate": 200.0,
      "time_limit": 2.5, "threads": 1}),
    ("kafka", "(native engine, poll-skip mutant)",
     {"runtime": "native", "n_instances": 48, "record_instances": 4,
      "node_count": 1, "nemesis": [], "p_loss": 0.05,
      "recovery_time": 0.3, "rate": 200.0, "time_limit": 2.0,
      "threads": 1, "gset_no_gossip": True}, False),
]


def cmd_demo(args) -> int:
    """Self-test: the matrix against the bundled example nodes, and the
    native engine's entries on the engine (built at the first one)."""
    from .runner import run_test
    failures = []
    for entry in DEMOS:
        workload, node, extra = entry[0], entry[1], entry[2]
        expect_valid = entry[3] if len(entry) > 3 else True
        if extra.get("runtime") == "native":
            # the engine is the cluster: no node binary to spawn
            label = f"{workload} / {node}"
            print(f"== {label}")
            from .native.harness import run_native_test
            opts = {k: v for k, v in extra.items() if k != "runtime"}
            opts.update(workload=workload, seed=1, store_root=args.store)
            runner = lambda: run_native_test(opts)
        else:
            node_file, *node_args = node.split()
            bin_, bin_args = _bin_cmd(
                os.path.join(REPO, "examples", "python", node_file),
                node_args)
            opts = dict(bin=bin_, bin_args=bin_args, node_count=1,
                        concurrency=4, rate=10.0,
                        time_limit=args.time_limit, recovery_time=1.0,
                        store_root=args.store, seed=1)
            opts.update(extra)
            if "availability" in opts:
                opts["availability"] = _availability(opts["availability"])
            label = f"{workload} / {node} {extra or ''}"
            print(f"== {label}")
            runner = lambda: run_test(workload, opts)
        try:
            verdict = runner().get("valid?")
        except Exception as e:
            print(f"   crashed: {e!r}")
            verdict = None
        if expect_valid:
            ok = verdict is True
            print("   valid!" if ok else
                  ("   UNKNOWN (indeterminate analysis)"
                   if verdict == "unknown" else "   INVALID"))
        else:
            ok = verdict is False
            print("   caught (mutant flagged invalid)" if ok else
                  "   NOT CAUGHT — mutant passed the checker")
        if not ok:
            failures.append(label)
    print()
    if failures:
        print(f"{len(failures)} demo(s) failed:")
        for f in failures:
            print(f"  - {f}")
        return 1
    print(f"All {len(DEMOS)} demos passed. ヽ(‘ー`)ノ")
    return 0


def cmd_serve(args) -> int:
    """The store over HTTP (``maelstrom_tpu/cli.py:726-737``): the
    results browser of :mod:`serve` on ``--port``."""
    import functools
    import http.server
    from .serve import ResultsHandler
    os.makedirs(args.store, exist_ok=True)
    handler = functools.partial(ResultsHandler, directory=args.store)
    with http.server.ThreadingHTTPServer(("", args.port), handler) as srv:
        print(f"Serving {args.store}/ on http://localhost:{args.port}")
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
    return 0


def cmd_doc(args) -> int:
    """``doc/workloads.md`` and ``doc/protocol.md`` (under ``--out``)
    from the RPC schema registry (``maelstrom_tpu/cli.py:739-743``)."""
    from .doc import write_docs
    for path in write_docs(args.out):
        print(f"wrote {path}")
    return 0


def cmd_test_process(args) -> int:
    """``test --runtime process``: the workload against ``--bin``'s node
    processes through :func:`runner.run_test`, with the JAX CLI's
    options, results print and exit codes."""
    if not args.bin:
        print("error: --bin is required for the process runtime",
              file=sys.stderr)
        return 2
    if args.device is not None:
        print("note: --device has no effect on the process runtime "
              "(no device state)", file=sys.stderr)
    from .runner import run_test
    node_count = args.node_count
    bin_, bin_args = _bin_cmd(args.bin, [])
    proc_extra = ({} if args.recovery_time is None
                  else {"recovery_time": args.recovery_time})
    results = run_test(args.workload, dict(
        **proc_extra,
        bin=bin_, bin_args=bin_args, node_count=node_count,
        concurrency=parse_concurrency(args.concurrency, node_count),
        rate=args.rate, time_limit=args.time_limit, latency=args.latency,
        latency_dist=args.latency_dist, p_loss=args.p_loss,
        nemesis=args.nemesis, nemesis_interval=args.nemesis_interval,
        topology=args.topology,
        availability=_availability(args.availability),
        key_count=args.key_count,
        max_txn_length=args.max_txn_length,
        max_writes_per_key=args.max_writes_per_key,
        consistency_models=args.consistency_models,
        crash_clients=args.crash_clients,
        txn=args.txn,
        log_stderr=args.log_stderr,
        log_net_send=args.log_net_send,
        log_net_recv=args.log_net_recv, seed=args.seed,
        store_root=args.store))
    return _print_results(results)


def cmd_test_native(args) -> int:
    """``test --runtime native``: the workload's fleet on the native C++
    engine through :func:`native.harness.run_native_test`, with the JAX
    CLI's refusals, notes, options, results print and exit codes
    (``maelstrom_tpu/cli.py:396-456``). It touches no device."""
    from .native.engine import NATIVE_WORKLOADS
    if args.workload not in NATIVE_WORKLOADS:
        print("error: --runtime native implements "
              f"{', '.join(sorted(NATIVE_WORKLOADS))} only; use "
              "--runtime tpu for the full model set", file=sys.stderr)
        return 2
    if args.nemesis_kind == "scripted" and not args.nemesis_schedule_file:
        print("error: --nemesis-kind scripted needs "
              "--nemesis-schedule-file", file=sys.stderr)
        return 2
    node_count = args.node_count
    schedule = ()
    if args.nemesis_schedule_file:
        err, schedule = _parse_schedule_file(args.nemesis_schedule_file,
                                             node_count)
        if err:
            print(err, file=sys.stderr)
            return 2
        if "partition" not in args.nemesis:
            args.nemesis = list(args.nemesis) + ["partition"]
    if args.device is not None:
        print("note: --device has no effect on the native runtime (a C++ "
              "engine on the host)", file=sys.stderr)
    notes = [(args.availability, "--availability", None),
             (args.latency_dist, "--latency-dist", "exponential")]
    if args.workload != "kafka":
        notes.append((args.crash_clients or None, "--crash-clients", None))
    if args.workload not in ("txn-list-append", "txn-rw-register"):
        notes.append((args.consistency_models, "--consistency-models",
                      None))
    for val, name, default in notes:
        if val != default:
            print(f"note: {name} has no effect on the native "
                  f"{args.workload} runtime (exponential latency; "
                  f"lin-kv is WGL-checked)", file=sys.stderr)
    from .native.harness import run_native_test
    results = run_native_test(dict(
        workload=args.workload,
        consistency_models=args.consistency_models,
        topology=args.topology,
        crash_clients=args.crash_clients,
        txn=args.txn,
        node_count=node_count,
        concurrency=parse_concurrency(args.concurrency, node_count),
        rate=args.rate, time_limit=args.time_limit,
        latency=args.latency, p_loss=args.p_loss,
        nemesis=args.nemesis,
        nemesis_interval=args.nemesis_interval,
        nemesis_schedule=schedule,
        n_instances=args.n_instances,
        record_instances=args.record_instances,
        check_workers=args.check_workers,
        seed=args.seed if args.seed is not None else 0,
        store_root=args.store,
        **({} if args.recovery_time is None
           else {"recovery_time": args.recovery_time})))
    return _print_results(results)


def _print_results(results) -> int:
    """The JAX CLI's results print and exit code of a host runtime: 0
    valid, 2 ``"unknown"``, 1 invalid."""
    print(json.dumps(results, indent=2, default=repr))
    print()
    verdict = results.get("valid?")
    if verdict is True:
        print("Everything looks good! ヽ(‘ー`)ノ")
        return 0
    if verdict == "unknown":
        print("Errors occurred during analysis, but no anomalies found. ಠ~ಠ")
        return 2
    print("Analysis invalid! (ノಥ益ಥ）ノ ┻━┻")
    return 1


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)
    if args.cmd != "test":
        return {"watch": cmd_watch, "triage": cmd_triage,
                "shrink": cmd_shrink, "campaign": cmd_campaign,
                "check": cmd_check, "export": cmd_export,
                "fleet-stats": cmd_fleet_stats,
                "profile": cmd_profile, "lint": cmd_lint,
                "demo": cmd_demo, "serve": cmd_serve,
                "doc": cmd_doc}[args.cmd](args)
    fault_kinds = [k for k in args.nemesis if k in FAULT_KINDS]
    if args.runtime != "tpu" and (fault_kinds or args.fault_plan
                                  or args.fault_fuzz):
        print("error: the fault-plan engine (--fault-plan, "
              "--fault-fuzz and the "
              f"{'/'.join(FAULT_KINDS)} nemesis kinds) is "
              "device-resident — --runtime tpu only; the host runtimes "
              "speak --nemesis partition (doc/guide/10-faults.md)",
              file=sys.stderr)
        return 2
    if args.runtime == "native":
        return cmd_test_native(args)
    if args.runtime == "process":
        return cmd_test_process(args)
    from .harness import run_torch_test
    from .models import get_model

    # the options the JAX CLI hands run_tpu_test, at its defaults
    opts = {"node_count": args.node_count, "store_root": args.store,
            "concurrency": parse_concurrency(args.concurrency,
                                             args.node_count),
            "seed": args.seed or 0, "heartbeat": not args.no_heartbeat,
            "fail_fast": args.fail_fast,
            "telemetry": not args.no_telemetry,
            "availability": _availability(args.availability)}
    for flag in ("rate", "time_limit", "latency", "latency_dist", "p_loss",
                 "nemesis_interval", "nemesis_kind", "ms_per_tick",
                 "n_instances", "record_instances", "journal_instances",
                 "telemetry_stride", "pipeline", "chunk_ticks",
                 "event_capacity", "scan_top_k", "checkpoint_every",
                 "check_workers", "check_mode", "device_profile",
                 "profile_dir", "compile_cache", "aot_store",
                 "fault_snapshot_every"):
        opts[flag] = getattr(args, flag)
    # unset, these take the harness's defaults, as in the JAX CLI
    for flag in ("recovery_time", "rpc_timeout", "inbox_k", "pool_slots"):
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
    opts["nemesis"] = args.nemesis
    raft_kw = {k: v for k, v in (("log_cap", args.log_cap),
                                 ("heartbeat", args.heartbeat_ticks))
               if v is not None}
    if raft_kw and not args.workload.startswith("lin-kv"):
        raise ValueError("--log-cap and --heartbeat-ticks are options of "
                         "lin-kv only (and its mutants)")
    # the JAX device runtime's notes, word for word: the run goes on
    # without the flag
    for flag, name in ((args.log_stderr, "--log-stderr"),
                       (args.log_net_send, "--log-net-send"),
                       (args.log_net_recv, "--log-net-recv")):
        if flag:
            print(f"note: {name} has no effect on the TPU runtime "
                  f"(no node processes / host wire log)",
                  file=sys.stderr)
    if args.crash_clients and not args.workload.startswith("kafka"):
        print("note: --crash-clients has no effect on the TPU "
              f"{args.workload} runtime (kafka-only)", file=sys.stderr)
        args.crash_clients = False
    if args.txn:
        print("note: --txn has no effect on the TPU runtime yet "
              "(kafka transactions are process/native-runtime "
              "features; use --runtime native)", file=sys.stderr)
    model_opts = {k: True for k in ("crash_clients", "txn_dirty_apply")
                  if getattr(args, k)}
    opts["crash_clients"] = args.crash_clients
    opts.update(model_opts)
    if args.consistency_models:
        opts["consistency_models"] = args.consistency_models
    model = get_model(args.workload, args.node_count, args.topology,
                      raft_kw, opts=model_opts)
    if args.key_count and hasattr(model, "n_keys"):
        model.n_keys = args.key_count
    res = run_torch_test(model, opts, device=args.device or "cuda")
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
    if res["valid?"] is True:
        return 0
    # an indeterminate analysis exits 2, as the JAX CLI's test does
    return 2 if res["valid?"] == "unknown" else 1


if __name__ == "__main__":
    sys.exit(main())
