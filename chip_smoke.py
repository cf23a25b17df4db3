#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # needs a CUDA card and nvcc

Phases (any failure exits non-zero and prints no result line):

1. build every CUDA source of the port (one ``nvcc`` per source, all
   started together) and print nvcc's ``-Xptxas -v`` report;
2. hold each kernel against its plain PyTorch version on the card
   (tolerance: exact — all outputs are int32) at the Pallas test shape,
   the flagship shape (S=16, K=1), the CLI-default shape (S=128, K=8),
   the 25-node broadcast shape (S=256, K=8, NT=50, L=10), the txn and
   kafka shapes (below), the bug-hunt shape (S=128, K=8, NT=6, L=20) and
   the journaled bug hunt's (the same with the NETID lane, L=21), 4096
   instances each, and on edge-case pools at small I
   (``kernels/delivery_cases.py``, rows of L = 9, 10, 14, 20, 21, 26,
   32, 33 and 66, and the shape phase 10 shrinks at: S=24, K=2, NT=7);
   at ``delivery_cases.TIMED``'s seven shapes time the
   kernel's device time per launch (CUPTI
   durations under ``torch.profiler``, L2 flushed before each launch,
   and warm), the wrapper's time per call (host issue included) and the
   plain version, beside the kernel's bound;
3. check on a small input (24 instances) that the card's run equals
   the CPU run of the plain versions at every 25th tick, all carry
   leaves exact (the CPU path is the one held to the JAX reference by
   the tests): lin-kv for 250 ticks under an active four-lane fault
   distribution, then under an active fleet-shared fault plan with
   crash, links, skew and membership; then each tutorial workload for
   150 ticks (echo, unique-ids, broadcast at 25 nodes in a tree4,
   g-set, g-counter, pn-counter; g-set and pn-counter under a crash and
   links plan; echo, unique-ids, broadcast and g-counter 100 ticks); then
   lin-kv-bug-no-term-guard at 5 nodes for 200 ticks under the scripted
   rotating-majorities schedule (50-tick phases); it logs each run's
   card and CPU time. The card runs go to a side card worker process
   and the CPU runs to two reference worker processes (spawned after
   phase 2, one thread each; the reference workers see no card), which
   compute them while this process drives phases 4-9 (the card idles
   most of each tick: this process's kernel issue bounds it); they are
   compared after phase 9;
4. drive the main path — ``run_torch_test`` on lin-kv Raft exactly as
   ``bench.py`` runs its flagship: 3 nodes, 6 clients, 4096 instances,
   under the all-healthy fault distribution
   ``BENCH_FUZZ_DIST``, for 1 simulated second (``FLAGSHIP_TIME_LIMIT``;
   the bench runs 4) — with every launch counter set to 0 just before
   and read just after; every kernel of the path must have launched,
   the delivery kernel once per tick, the verdict must be valid, and
   the network counters must equal the bare run's (the distribution
   is value-neutral);
5. drive the same fleet for 250 ticks bare and then under an active
   four-lane fault distribution (counters reset before and read after
   each): both valid, the delivery kernel once per tick, and the
   fuzzed fleet's drawn windows fired in every lane;
6. drive the guide's broadcast fleet (``fleets.BROADCAST_25``: 25 nodes
   in a tree4, 25 clients, 4096 instances, 1,000 ticks, S=256, K=8)
   the same way: valid, the delivery kernel once per tick, no overflow;
7. drive the other tutorial workloads at their family settings
   (``fleets.FAMILIES``, 4096 instances, 400 ticks each) the same
   way: each valid, the delivery kernel once per tick;
8. drive the txn-list-append fleet (``fleets.TXN``: 3 nodes, 6
   clients, 4096 instances, 500 ticks, four recorded instances
   checked by Elle), then txn-rw-register at the same settings, then
   kafka at the bench's settings (``fleets.KAFKA``: 1 node,
   no nemesis), each for 500 ticks, the same way: each valid, the delivery
   kernel once per tick; it logs the recorded instances' txn counts and
   any Elle anomaly types;
9. drive the bug hunt (``fleets.BUG_HUNT``: ``RaftDoubleVote``, 3
   nodes, 3 clients, 4096 instances, 4 recorded, instance 0 journaled
   (so every row carries the NETID lane: L=21), fail-fast, a funnel of
   up to 32 instances, the store and its heartbeat in a temporary
   directory) for a planned 600 ticks: the verdict must be invalid, the
   run must stop early, the funnel's replay on the card must trip every
   replayed instance again, every funnel verdict must be there, the
   delivery kernel must launch once per tick run plus once per replayed
   tick, every file of the store layout must exist (``messages.svg`` and
   ``heartbeat.jsonl`` included), ``fleet-metrics.json`` must parse, and
   ``results.net.journal`` must count instance 0's messages. It prints
   the stopped run's ticks/s and each chunk's issue time, the funnel's
   wall time and the store's write time;
10. take the bug hunt's store apart with the CLI's forensics commands
    (``python -m maelstrom_tpu_torch watch|triage|shrink``, called in
    this process): ``watch`` renders its heartbeat (exit 0, status
    stopped); ``triage`` replays its first 8 flagged instances on the
    card with journals (each must trip again, each bundle must hold
    ``messages.svg``, ``journal.edn``, ``history.jsonl`` and
    ``repro.json``, the delivery kernel once per replayed tick), and
    again on the CPU (a reference worker, alongside), and every bundle
    file must be equal; then a small
    fuzz run of lin-kv-bug-forget-snapshot (``FUZZ_SHRINK``: one
    instance, 300 ticks, which trips) is stored from the card (in the
    side card worker, during phases 4-9, as is the card's shrink) and
    ``shrink`` (``SHRINK_ATTEMPTS`` candidate replays besides the
    verifying one, of which one must be kept, and the confirming replay
    of the shrunk plan) shrinks it on the card and, on a copy, on the
    CPU (a reference worker): the card's ``shrunk-plan.json``
    must be verified and equal to
    the CPU's, and so must every field of its record.

11. the verdict stage on the card: (a) the device verdict lanes on the
    double-vote mutant in ``both`` mode (``LANES_MUTANT``, the JAX
    routing test's options: 32 instances, all recorded, 300 ticks),
    card against CPU — every carry leaf, ``check_summary`` included, at
    every 25th tick, then ``run_torch_test`` on each (the card's with
    the checker farm at ``check_workers`` auto, the CPU's with the
    serial farm, which gives the same verdicts): the ``check`` block, invariants,
    network counters and every verdict equal, the flagged set not empty,
    the ``both`` audit complete, the farm pooled, the delivery kernel
    once per tick; (b) the correct lin-kv at the bug hunt's settings
    (``fleets.BUG_HUNT`` without fail-fast), 4096 instances, 1,024
    recorded, 200 ticks, once in ``both`` and once in ``device`` mode:
    each valid with the farm pooled and the kernel once per tick, the
    audit complete, and device mode's per-instance ``valid?`` equal to
    both mode's; it prints each mode's ticks/s, ``check-s``,
    ``decode-s``, the pool, the flagged and farm instances and the farm's
    load fraction, and, if the lanes flagged any instance of the correct
    model, which flag bits.

12. the campaign on the card, in the side card worker (after its phase
    3 and phase 10 work): a one-item campaign spec of the bare flagship
    (``fleets.FLAGSHIP``, 4096 instances, 1,000 ticks in 100-tick
    chunks, a carry checkpoint every 2 chunks; a spec cannot carry the
    flagship model's ``log_cap`` and ``heartbeat``, so the item runs
    ``get_model("lin-kv", 3)``) is submitted with ``campaign submit``,
    drained by ``python -m maelstrom_tpu_torch campaign run`` in a
    child process, which is SIGKILLed once ``checkpoint/state.npz``
    reaches tick 400, and finished by ``campaign resume`` (in the side
    worker): the item must be done and resumed, its heartbeat must hold
    one resume seam and end at 1,000 ticks, and its results (less
    ``perf``) and recorded history must equal an uninterrupted,
    checkpointed card run of the same options (run in the side worker
    while the child runs); the resumed suffix must launch the delivery
    kernel once per tick (the killed child's launches die with it and
    are not counted). Then a 24-instance, 150-tick checkpointed flagship
    on the card and on the CPU (a reference worker) must leave
    ``state.npz`` files equal array by array. It prints the
    ``state.npz`` size, each save's ``checkpoint-s``, the restore time,
    and the checkpointed runs' ticks/s beside phase 4's.

13. instance sharding (``maelstrom_tpu_torch/parallel/mesh.py``), in a
    card worker of its own from phase 2 on: the flagship
    (``fleets.FLAGSHIP`` with its model, 4 recorded instances in all) at
    8,192 global instances for 300 ticks in 100-tick chunks, once at one
    shard (the reference; its recorded instances checked valid), once
    at two shards (on the first two cards, or both on ``cuda:0``) with a
    checkpoint at tick 200, and that checkpoint resumed at four shards
    through ``reshard_carry``: both held equal to the reference (stats,
    violations, events, every merged telemetry leaf), the delivery
    kernel once per tick on every shard, counted by device. Then a
    2 x 24-instance sharded checkpointed flagship on the card and on
    the CPU (a reference worker) must leave ``state.npz`` files equal
    array by array. It prints the shards' devices and the visible card
    count, each run's ticks/s and simulated msgs/s with its per-shard
    issue and merge seconds, ``checkpoint-s``, ``restore-s`` and the
    ``state.npz`` size, beside the card's name and power limit.

14. the device profiler (``telemetry/profiler.py``), behind phase 13 in
    its card worker: the flagship (``fleets.FLAGSHIP`` with its model,
    4,096 instances) under ``BENCH_FUZZ_DIST``, as phase 4 runs it, for
    300 ticks in 100-tick chunks with ``device_profile`` off, auto and
    on in turns, each a stored ``run_torch_test``: every carry leaf, the
    counters and the verdict of auto and on equal the off run's, the
    delivery kernel once per tick in each; the profiled runs' heartbeat
    chunk records carry ``device-ms`` (phases of ``PHASE_LABELS``) from
    the event-trace source, and ``perf.phases.device`` counts 3
    captured chunks; ``python -m maelstrom_tpu_torch profile`` on the
    "on" run (a child process) exits 0 and names the hot scope; a
    50-tick run with ``profile_dir`` writes one Chrome trace; ``python
    -m maelstrom_tpu_torch.bench`` (a child process) at 0.3 simulated
    seconds prints the metric line with ``value`` > 0. It prints the
    ticks/s of off, auto and on, the per-phase ms/tick, each captured
    chunk's phase sum against its device wall and issue time, the
    ``profile`` table, the bench line and the launches.

Phase 2's txn and kafka shapes: txn-list-append (L=66, timed),
txn-rw-register (L=26) and kafka (NT=7, L=32, timed); phase 3 also checks
txn-list-append (bare, and under a crash and links plan, whose slab
carries the 2-D list kv), txn-rw-register-bug-dirty-apply, kafka with
crash_clients and kafka-bug-offset-reuse, 150 ticks each.

Before the last line it prints the card's name and power limit and one
JSON object with every kernel's launches, error, times and bound (``ms``
is the device time at the flagship shape; ``shapes`` holds each timed
shape's ``device_ms``, ``wrapper_ms``, ``plain_ms``, ``bound_ms`` and
``bound_share``; ``launches_by_path`` the launches of every driven
path; ``timing`` states the method); the last line is ``{"ok": true,
"device": {...}}``.

``--rehearse-on-cpu`` runs phases 2 and 4-14 at a tiny size with the
plain versions (no card, no nvcc) to check the script's own logic; it
exits 2 and prints no result line (its broadcast runs 5 nodes, not 25;
its phase 10 compares the CPU with itself; its phase 14 profiles with
the timed source and checks that the bench module refuses to run).
``--time-limit S`` runs the paths of phases 4-8 for at most ``S``
simulated seconds instead (a quicker check; the broadcast fleet for at
least 1 s, which it needs to converge after the heal).
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

# phase 4's depth: the flagship's 4 simulated seconds cut to 1 (1,000
# ticks) to keep the script inside its limit on a slow host
FLAGSHIP_TIME_LIMIT = 1.0
# the bare flagship's network counters at full width and that depth
# (NVIDIA H100 80GB HBM3; PERF.md): the all-healthy distribution keeps
# them
FLAGSHIP_NET = {"sent": 2345869, "delivered": 1930833,
                "dropped-partition": 287100, "dropped-loss": 117132,
                "dropped-overflow": 0}
# an active distribution over all four lanes
ACTIVE_FUZZ = {"windows": [2, 3], "gap": [40, 200], "duration": [30, 100],
               "crash": {"rate": 0.7, "victims": [1, 1]},
               "links": {"rate": 0.6, "edges": [1, 3], "block": 0.5,
                         "delay": [0, 20], "loss": [0.0, 0.3]},
               "skew": {"rate": 0.5, "victims": [1, 2],
                        "range": [0.5, 2.0]},
               "membership": {"rate": 0.5, "victims": [1, 1]}}
# an active fleet-shared plan over all four lanes (phase 3's 250 ticks)
ACTIVE_PLAN = {"phases": [
    {"until": 40, "members": [0, 1, 2]},
    {"until": 80, "crash": [0], "skew": {"1": 2.0, "2": 0.75}},
    {"until": 120, "links": [{"dst": 1, "src": 0, "block": True},
                             {"dst": 0, "src": 1, "delay": 7},
                             {"dst": 0, "src": 2, "loss": 0.4}]},
    {"until": 170, "remove": [1]},
    {"until": 200, "add": [1], "crash": [2]}]}
# crashes and degraded links (phase 3: healed at tick 100 in its
# 150-tick runs)
CRASH_LINKS_PLAN = {"phases": [
    {"until": 30},
    {"until": 80, "crash": [0]},
    {"until": 120, "links": [{"dst": 1, "src": 0, "block": True},
                             {"dst": 0, "src": 2, "delay": 6},
                             {"dst": 2, "src": 1, "loss": 0.5}]},
    {"until": 145, "crash": [1, 2]}]}
TUTORIAL = ("echo", "unique-ids", "broadcast", "g-set", "g-counter",
            "pn-counter")
# phase 3's txn and kafka runs: (label, workload, model flags, plan)
TXN_KAFKA_SMALL = (
    ("txn-list-append", "txn-list-append", {}, None),
    ("txn-list-append under a crash and links plan", "txn-list-append", {},
     CRASH_LINKS_PLAN),
    ("txn-rw-register-bug-dirty-apply", "txn-rw-register-bug-dirty-apply",
     {}, None),
    ("kafka with crash_clients", "kafka", {"crash_clients": True}, None),
    ("kafka-bug-offset-reuse", "kafka-bug-offset-reuse", {}, None))
# phase 8's fleets, txn-list-append first
TXN_KAFKA = ("txn-list-append", "txn-rw-register", "kafka")
# phase 9: the bug hunt's mutant and planned depth (cut from 2.5 s)
BUG_HUNT_MUTANT = "lin-kv-bug-double-vote"
BUG_HUNT_TIME_LIMIT = 0.6
# phase 10: the fuzz run that shrink takes apart — the JAX fuzz tests'
# HIT_OPTS and HIT_DIST (tests/test_fault_fuzz.py:74-85) cut from 0.8 s
# to 0.3 s at seed 17, where the one-instance fleet trips
# (tests/test_torch_forensics.py, FUZZ; no funnel: the shrink replays
# the tripped instance), and the shrink's replay budget: its first three
# candidates (drop the phase, drop either crash victim) no longer trip,
# the fourth (halve the phase) does, so 4 attempts keep one reduction
# and run its confirming replay
FUZZ_SHRINK_MUTANT = "lin-kv-bug-forget-snapshot"
FUZZ_SHRINK = dict(
    node_count=3, concurrency=4, n_instances=1, record_instances=1,
    time_limit=0.3, rate=300.0, latency=5.0, rpc_timeout=0.08,
    recovery_time=0.1, seed=17, inbox_k=2, pool_slots=24, pipeline="on",
    funnel=False, device_profile="off",
    fault_fuzz={"windows": [2, 2], "gap": [150, 260],
                "duration": [50, 90],
                "crash": {"rate": 1.0, "victims": [2, 2]},
                "links": {"rate": 0.6, "edges": [1, 3], "block": 0.5,
                          "delay": [0, 20], "loss": [0.0, 0.2]},
                "skew": {"rate": 0.4, "victims": [1, 1],
                         "range": [0.75, 1.5]}})
SHRINK_ATTEMPTS = 4
TRIAGE_MAX = 8
# phase 11 (a): the JAX routing test's double-vote fleet
# (tests/test_device_check.py:131-176, MUTANT_OPTS: 32 instances, all
# recorded, the flagship's inbox_k 1 and 16 slots, 300 ticks) in both
# mode, the farm at check_workers auto
LANES_MUTANT = dict(node_count=3, concurrency=6, n_instances=32,
                    record_instances=32, inbox_k=1, pool_slots=16,
                    time_limit=0.3, rate=200.0, latency=5.0,
                    rpc_timeout=1.0, nemesis=["partition"],
                    nemesis_interval=0.04, p_loss=0.05, recovery_time=0.0,
                    seed=7, telemetry=False, funnel=False, layout="lead",
                    check_mode="both", device_profile="off")
LANES_MUTANT_KW = dict(log_cap=64, heartbeat=8)
# phase 11 (b): the bug hunt's fleet (fleets.BUG_HUNT) with the correct
# lin-kv model, no fail-fast, 1,024 of the 4,096 instances recorded, 200
# ticks (cut from 2.5 s)
SWEEP_RECORDED = 1024
SWEEP_TIME_LIMIT = 0.2
# phase 12: the campaign item (the bare flagship, 1,000 ticks in 100-tick
# chunks, a checkpoint every 2 chunks), killed once its checkpoint
# reaches KILL_AT_TICKS, and the small card-against-CPU checkpointed run
CAMPAIGN = dict(time_limit=1.0, chunk_ticks=100, checkpoint_every=2,
                device_profile="off")
KILL_AT_TICKS = 400
CHILD_DEADLINE_S = 300
SMALL_CHECKPOINT = dict(n_instances=24, time_limit=0.15, chunk_ticks=50,
                        checkpoint_every=1, device_profile="off")
# phase 3's scripted run: the JAX tests' Figure-8 options
# (tests/test_tpu_raft.py:70-75) at 24 instances for 200 ticks, the
# rotating majorities in 50-tick phases until tick 150 (cut from 250 and
# 200)
FIGURE8_SMALL = dict(node_count=5, concurrency=4, n_instances=24,
                     record_instances=1, time_limit=0.2, rate=60.0,
                     latency=5.0, rpc_timeout=0.8, nemesis=["partition"],
                     nemesis_kind="scripted", recovery_time=0.05, seed=11,
                     telemetry=True, layout="lead")
# phase 13: the flagship (fleets.FLAGSHIP with its model) at 8,192 global
# instances, 300 ticks in 100-tick chunks (cut from 500 when phase 14
# joined its worker): one shard, two shards (a checkpoint at tick 200),
# and the tick-200 checkpoint resumed at four shards. 4 recorded
# instances in all (4, 2, 1 a shard), so that every shard count records
# the same global ids 0-3
MESH = dict(n_global=8192, time_limit=0.3, chunk=100, ckpt_tick=200,
            recorded=4, reshard=4)
# the small sharded run held card against CPU (state.npz): 24 instances a
# shard, two shards, 150 ticks in 50-tick chunks, a save every 2 chunks
SMALL_MESH = dict(n_instances=24, time_limit=0.15, chunk=50, every=2)
# phases 4-13 run without the device profiler (whose default is auto), so
# their ticks/s stay comparable with earlier calls; phase 14 prices it
NO_PROFILE = dict(device_profile="off")
# phase 14: the flagship (fleets.FLAGSHIP with its model) under
# BENCH_FUZZ_DIST, as phase 4 runs it, for 300 ticks in 100-tick chunks
# with device_profile off, auto and on in turns; a 50-tick run under a
# torch.profiler session (profile_dir); the bench module for 0.3
# simulated seconds
PROFILE = dict(time_limit=0.3, chunk=100, trace_ticks=50,
               bench_seconds=0.3, modes=("off", "auto", "on"))


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int, sync) -> float:
    """Mean wall time of ``fn`` over ``iters`` back-to-back calls after
    a warm-up: CUDA events on the card, the host clock on the CPU. Where
    a call's kernels take less device time than the host takes to issue
    them, this is the host's issue time, not the kernels' time."""
    for _ in range(3):
        fn()
    sync()
    if torch.cuda.is_available():
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


TIMING = ("device_ms: mean kernel duration recorded by CUPTI under "
          "torch.profiler over at least {n} recorded launches (sessions "
          "of {n} calls, repeated where CUPTI lost records), the 50 MB L2 "
          "cache flushed (a 128 MB read) before each; device_warm_ms: "
          "the same without the flush; wrapper_ms and plain_ms: CUDA events around {n} "
          "back-to-back Python calls (host issue included)")


def _check(dev, label, pools, parts, t, cfg):
    """Kernel vs plain version on one input, bit for bit."""
    from maelstrom_tpu_torch import netsim
    from maelstrom_tpu_torch.kernels import delivery
    pool = torch.from_numpy(pools).to(dev)
    part = torch.from_numpy(parts).to(dev)
    before = delivery.deliver.launches
    got = delivery.deliver(pool, part, t, cfg)
    ref = netsim.deliver_reference(pool, part, t, cfg)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        if delivery.deliver.launches != before + 1:
            raise AssertionError("deliver did not launch its kernel")
    err = max(int((g.long() - r.long()).abs().max()) if g.numel() else 0
              for g, r in zip(got, ref))
    if err != 0:
        raise AssertionError(f"delivery kernel != plain version at "
                             f"{label}: max abs err {err}")
    return pool, part, err


def check_delivery(dev, shapes, iters):
    """Kernel vs plain version at each shape and on every edge-case
    pool; device, wrapper and plain times with the bound at the timed
    shapes. Returns the kernel's record for the JSON line."""
    from maelstrom_tpu_torch import netsim
    from maelstrom_tpu_torch.kernels import delivery, devtime
    from maelstrom_tpu_torch.kernels import delivery_cases as dc
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: 0)
    max_err = 0
    for name, (n, c, S, K, body, I) in dc.EDGE_SHAPES.items():
        cfg = dc.net_config(n, c, S, K, body)
        cases = dc.edge_pools(cfg, I, 3)
        for case, (pools, parts, t) in cases.items():
            max_err = max(max_err, _check(dev, f"{name}/{case}", pools,
                                          parts, t, cfg)[2])
        log(f"phase 2: deliver edge pools at {name} I={I} S={S} K={K} "
            f"L={cfg.lanes}: {', '.join(cases)} bit-equal to "
            f"deliver_reference (tolerance 0)")
    per_shape = {}
    for name, (n, c, S, K, body, I) in shapes.items():
        cfg = dc.net_config(n, c, S, K, body)
        L, NT, t = cfg.lanes, cfg.n_total, 15
        pools, parts = dc.random_pools(np.random.RandomState(5), I, cfg)
        pool, part, err = _check(dev, name, pools, parts, t, cfg)
        max_err = max(max_err, err)
        log(f"phase 2: deliver {name} I={I} S={S} K={K} NT={NT} L={L}: "
            f"bit-equal to deliver_reference (tolerance 0)")
        if name not in dc.TIMED:
            continue
        call = lambda: delivery.deliver(pool, part, t, cfg)
        rec = {"I": I, "S": S, "K": K, "NT": NT, "L": L}
        if on_card:
            rec["device_ms"] = devtime.device_ms(
                call, delivery.KERNEL_NAME, iters)
            rec["device_warm_ms"] = devtime.device_ms(
                call, delivery.KERNEL_NAME, iters, flush_l2=False)
        else:
            rec["device_ms"] = rec["device_warm_ms"] = None
        rec["wrapper_ms"] = time_ms(call, iters, sync)
        rec["plain_ms"] = time_ms(
            lambda: netsim.deliver_reference(pool, part, t, cfg),
            max(1, iters // 4), sync)
        rec["bound_ms"], rec["bound_by"], nbytes, ops = dc.bound(
            pool, part, t, cfg)
        rec["bound_share"] = (rec["bound_ms"] / rec["device_ms"]
                              if rec["device_ms"] else None)
        rec["library_ms"] = None
        dev_txt = ("not measured (no card)" if rec["device_ms"] is None
                   else f"{rec['device_ms']:.6f} ms device time "
                        f"({rec['bound_share']:.1%} of bound; "
                        f"{rec['device_warm_ms']:.6f} ms with warm L2)")
        log(f"phase 2: deliver {name}: kernel {dev_txt}, wrapper "
            f"{rec['wrapper_ms']:.6f} ms per call, plain version "
            f"{rec['plain_ms']:.6f} ms, bound {rec['bound_ms']:.6f} ms "
            f"({rec['bound_by']}: {nbytes} B, {ops} int ops), library "
            f"call: none")
        per_shape[name] = rec
    # the launches above were comparisons, not the main path
    delivery.deliver.launches = 0
    main = per_shape["flagship"]
    return {"name": "deliver", "route": "cuda",
            "source": "maelstrom_tpu_torch/csrc/deliver.cu",
            "replaces": "maelstrom_tpu/ops/delivery.py:51",
            "launches": None, "max_abs_err": max_err,
            "ms": main["device_ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "timing": TIMING.format(n=iters),
            "shapes": per_shape}


def _make_model(spec):
    """A model from a picklable spec: ``("fleet", workload, model_opts)``
    (the model of ``fleets.fleet``) or ``("model", name, node_count,
    kwargs)`` (``get_model``)."""
    from maelstrom_tpu_torch import fleets
    from maelstrom_tpu_torch.models import get_model
    if spec[0] == "fleet":
        return fleets.fleet(spec[1], spec[2])[0]
    return get_model(spec[1], spec[2], **spec[3])


def _carry_seq(model, opts, dev):
    """The tick loop on ``dev``: the carry (numpy leaves) at every 25th
    tick, and the run's ``SimConfig``."""
    from maelstrom_tpu_torch import convert, harness, runtime
    sim = harness.make_sim_config(model, opts)
    carry = runtime.init_carry(model, sim, opts["seed"], dev)
    tick = runtime.make_tick_fn(model, sim, device=dev)
    seq = []
    with torch.no_grad():
        for t in range(sim.n_ticks):
            carry, _ = tick(carry, t)
            if t % 25 == 24:
                seq.append(convert.carry_to_numpy(carry))
    return sim, seq


def _carries(spec, opts, dev):
    """``(n_instances, n_ticks)`` and the carries at every 25th tick of
    the tick loop on device ``dev`` (a name)."""
    sim, seq = _carry_seq(_make_model(spec), opts, torch.device(dev))
    return (sim.n_instances, sim.n_ticks), seq


# --- work run in other processes while this one drives the card ------------
#
# Driving the card is bound by this process's kernel issue (the card idles
# ~90% of each tick, PERF.md §5), so the script hands work to two pools:
# reference workers (the CPU halves of the card-against-CPU checks; no
# CUDA) and one side card worker (phase 3's small card loops, phase 10's
# fuzz run and shrink), each its own process with its own launch counters.


def _worker_init(cuda: bool) -> None:
    """One thread (the ops are small); a reference worker never creates
    a CUDA context."""
    import os
    if not cuda:
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
    torch.set_num_threads(1)


def _timed(fn, *args):
    t0 = time.monotonic()
    out = fn(*args)
    return out, time.monotonic() - t0


def _cpu_test(spec, opts):
    """``run_torch_test`` on the CPU."""
    from maelstrom_tpu_torch import harness
    return harness.run_torch_test(_make_model(spec), opts, device="cpu")


def worker_pool(workers: int, cuda: bool):
    """``workers`` spawned processes (they share no CUDA context with
    this one); ``cuda`` False hides the card from them."""
    import concurrent.futures
    import multiprocessing
    return concurrent.futures.ProcessPoolExecutor(
        max_workers=workers, mp_context=multiprocessing.get_context("spawn"),
        initializer=_worker_init, initargs=(cuda,))


def submit(pool, fn, *args):
    """``fn(*args)`` in ``pool``: a future of ``(result, seconds)``."""
    return pool.submit(_timed, fn, *args)


def check_small_run_matches_cpu(dev, label, card_run, cpu_run,
                                phase="phase 3"):
    """The card's tick loop equals the CPU plain-version loop on a small
    input: every carry leaf at every 25th tick. ``card_run`` and
    ``cpu_run`` are :func:`_carries` on the same spec and options, on
    the card and on the CPU, with their seconds."""
    from maelstrom_tpu_torch import convert
    ((n_inst, n_ticks), card), t_card = card_run
    (_, cpu), t_cpu = cpu_run
    names = None
    for k, (a, b) in enumerate(zip(cpu, card)):
        leaves = dict(convert.carry_leaves(b))
        names = names or sorted(leaves)
        for name, x in convert.carry_leaves(a):
            if not np.array_equal(x, leaves.pop(name)):
                raise AssertionError(f"{dev} run differs from the CPU run "
                                     f"at tick {25 * k + 24} under "
                                     f"{label}: {name}")
        if leaves:
            raise AssertionError(f"{label}: leaves only on {dev}: "
                                 f"{sorted(leaves)}")
    if len(cpu) != len(card) or not card:
        raise AssertionError(f"{label}: {len(card)} card snapshots, "
                             f"{len(cpu)} CPU snapshots")
    if int(card[-1].stats.delivered) <= 0:
        raise AssertionError(f"{label}: nothing delivered")
    fault_leaves = sorted({n.split(".")[1] for n in names} - {
        "pool", "node_state", "client_state", "stats", "violations", "key",
        "telemetry", "check_summary"})
    log(f"{phase}: {n_inst}-instance {n_ticks}-tick run on {dev} under "
        f"{label} equals the CPU plain-version run at every 25th tick (all "
        f"{len(names)} carry leaves, exact; fault leaves "
        f"{', '.join(fault_leaves) or 'none'}); card run {t_card:.1f} s, "
        f"CPU run {t_cpu:.1f} s")


def run_path(dev, model, opts, label):
    """``run_torch_test`` on one path, every launch counter set to 0
    just before and read just after: a valid verdict and the delivery
    kernel once per tick on the card."""
    from maelstrom_tpu_torch import harness
    from maelstrom_tpu_torch.kernels import delivery
    delivery.deliver.launches = 0
    t0 = time.monotonic()
    res = harness.run_torch_test(model, opts, device=str(dev))
    wall = time.monotonic() - t0
    launches = {"deliver": delivery.deliver.launches}
    ticks = res["perf"]["ticks"]
    log(f"{label}: {model.name} x{res['instance-count']} for {ticks} "
        f"ticks: valid?={res['valid?']} wall {wall:.1f} s, "
        f"{res['perf']['ticks-per-sec']:.2f} ticks/s, "
        f"{res['perf']['msgs-per-sec']:.0f} simulated msgs/s, "
        f"net {json.dumps(res['net'])}, launches {launches}")
    if "fault-fuzz" in res:
        log(f"{label}: fault lanes {res['faults']['lanes']}, fleet "
            f"coverage {json.dumps(res['fault-fuzz'])}")
    if res["valid?"] is not True:
        raise AssertionError(f"{label} verdict {res['valid?']!r}")
    if launches["deliver"] != ticks and dev.type == "cuda":
        raise AssertionError(f"delivery kernel launched "
                             f"{launches['deliver']} times for {ticks} "
                             f"ticks")
    if res["net"]["delivered"] <= 0 or res["checked-instances"] < 1:
        raise AssertionError(f"{label} delivered nothing")
    return res, launches


def store_files(res):
    """The files of the store layout this run must have written."""
    names = ["results.json", "fleet-metrics.json", "fleet-rate.svg",
             "fleet-drops.svg", "fleet-latency.svg", "latency-raw.svg",
             "latency-quantiles.svg", "rate.svg", "timeline.html",
             "messages.svg", "heartbeat.jsonl"]
    for i in range(res["checked-instances"]):
        names += [f"history-{i}.jsonl", f"history-{i}.txt"]
    return names + [f"funnel-history-{i}.jsonl"
                    for i in res["funnel"]["ids"]]


def run_bug_hunt(dev, model, opts, label, root):
    """``run_torch_test`` on the bug hunt, stored under ``root``, the
    launch counter set to 0 just before and read just after: an invalid
    verdict, a fail-fast stop, the funnel's replay tripping every
    replayed instance, every funnel verdict, one delivery launch per
    tick run and per replayed tick, the journal block, and the whole
    store, ``messages.svg`` and ``heartbeat.jsonl`` included."""
    import os
    from maelstrom_tpu_torch import harness
    from maelstrom_tpu_torch.kernels import delivery
    delivery.deliver.launches = 0
    t0 = time.monotonic()
    res = harness.run_torch_test(model, dict(opts, store_root=root),
                                 device=str(dev))
    wall = time.monotonic() - t0
    launches = {"deliver": delivery.deliver.launches}
    perf, ff, fun = res["perf"], res.get("fail-fast"), res.get("funnel")
    phases = perf["phases"]
    planned = res["telemetry"]["ticks"]
    log(f"{label}: {model.name} x{res['instance-count']}: valid?="
        f"{res['valid?']}, wall {wall:.1f} s, stopped run "
        f"{perf['ticks']} of {planned} ticks at "
        f"{perf['ticks-per-sec']:.2f} ticks/s, "
        f"{perf['msgs-per-sec']:.0f} simulated msgs/s, funnel "
        f"{phases.get('funnel-s')} s, store write "
        f"{phases.get('store-s')} s, launches {launches}")
    pipe = phases.get("pipeline", {})
    log(f"{label}: chunks of {pipe.get('chunk-ticks')} ticks, issue s "
        f"per chunk {pipe.get('chunk-issue-s')}, fetch s "
        f"{pipe.get('fetch-s')}, init s {pipe.get('init-s')}")
    log(f"{label}: fail-fast {json.dumps(ff)}")
    log(f"{label}: invariants {json.dumps(res['invariants'])[:400]}")
    if res["valid?"] is not False:
        raise AssertionError(f"{label}: the mutant was not caught "
                             f"(valid? {res['valid?']!r})")
    if not ff or ff["stopped"] is not True \
            or not ff["ticks-dispatched"] < planned:
        raise AssertionError(f"{label}: no fail-fast stop: {ff}")
    if not fun or not (fun["replayed-violating"] == len(fun["ids"])
                       > 0):
        raise AssertionError(f"{label}: the funnel's replay did not "
                             f"trip every replayed instance: "
                             f"{fun and fun['replayed-violating']} "
                             f"of {fun and fun['ids']}")
    got = [v.get("instance") for v in fun["verdicts"]]
    if got != fun["ids"] or any("valid?" not in v
                                for v in fun["verdicts"]):
        raise AssertionError(f"{label}: funnel verdicts {got} for ids "
                             f"{fun['ids']}")
    log(f"{label}: funnel replayed {len(fun['ids'])} of "
        f"{fun['total-violating']} tripped instances over the full "
        f"{planned} ticks: all {fun['replayed-violating']} tripped "
        f"again; verdicts valid? "
        f"{[v['valid?'] for v in fun['verdicts']]}")
    expect = ff["ticks-dispatched"] + planned
    if dev.type == "cuda" and launches["deliver"] != expect:
        raise AssertionError(f"{label}: delivery kernel launched "
                             f"{launches['deliver']} times, expected "
                             f"{expect} (ticks run + replayed ticks)")
    run_dir = res["store-dir"]
    missing = [f for f in store_files(res)
               if not os.path.exists(os.path.join(run_dir, f))]
    if missing:
        raise AssertionError(f"{label}: store files missing: "
                             f"{missing}")
    with open(os.path.join(run_dir, "fleet-metrics.json")) as f:
        fleet = json.load(f)
    log(f"{label}: store has all {len(store_files(res))} files; "
        f"fleet-metrics.json parses ({fleet['instances']} instances, "
        f"{fleet['invariants']['tripped-instances']} tripped)")
    journal = res["net"].get("journal")
    if not journal or journal["stats"]["all"]["msg-count"] <= 0:
        raise AssertionError(f"{label}: no results.net.journal block "
                             f"or an empty journal: {journal}")
    log(f"{label}: journal of instance 0 (rows of L="
        f"{harness.make_sim_config(model, opts).net.lanes}): "
        f"{json.dumps(journal['stats']['all'])}, msgs-per-op "
        f"{journal['msgs-per-op']:.3f}; messages.svg "
        f"{os.path.getsize(os.path.join(run_dir, 'messages.svg'))} B")
    return res, launches


def _same_files(a, b, names, label):
    """Byte equality of ``names`` under the directories ``a`` and ``b``."""
    import os
    for name in names:
        with open(os.path.join(a, name), "rb") as f, \
                open(os.path.join(b, name), "rb") as g:
            if f.read() != g.read():
                raise AssertionError(f"{label}: {name} differs between "
                                     f"{a} and {b}")


def _cli(label, *argv):
    """``python -m maelstrom_tpu_torch ARGV`` in this process: exit code
    0, or the phase fails; its standard output's lines."""
    import contextlib
    import io
    from maelstrom_tpu_torch.__main__ import main as cli
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli(list(argv))
    lines = out.getvalue().strip().splitlines()
    if rc != 0:
        raise AssertionError(f"{label}: {argv[0]} exited {rc}: "
                             f"{lines[-5:]}")
    return lines


def _read_json(*path):
    import os
    with open(os.path.join(*path)) as f:
        return json.load(f)


def fuzz_run(dev_name, root):
    """Phase 10's fuzz run on ``dev_name`` (in the side card worker),
    stored under ``root``; the store copied twice, for the shrink on the
    card (``card``) and on the CPU (``cpu``). Returns the copies, the
    run's ticks and its delivery launches."""
    import os
    import shutil
    from maelstrom_tpu_torch import harness
    from maelstrom_tpu_torch.kernels import delivery
    from maelstrom_tpu_torch.models import get_model
    model = get_model(FUZZ_SHRINK_MUTANT, FUZZ_SHRINK["node_count"])
    delivery.deliver.launches = 0
    res = harness.run_torch_test(
        model, dict(FUZZ_SHRINK, store_root=os.path.join(root, "fuzz")),
        device=dev_name)
    launches = delivery.deliver.launches
    if res["invariants"]["violating-instance-ids"] != [0]:
        raise AssertionError(f"phase 10: the fuzz run did not trip "
                             f"instance 0: {res['invariants']}")
    out = {"ticks": res["perf"]["ticks"], "launches": launches}
    for side in ("card", "cpu"):
        out[side] = os.path.join(root, f"fuzz-{side}")
        shutil.copytree(res["store-dir"], out[side])
    return out


def shrink(dev_name, store, label):
    """``shrink`` of the fuzz run's copy ``store`` on ``dev_name``: its
    delivery launches."""
    from maelstrom_tpu_torch.kernels import delivery
    delivery.deliver.launches = 0
    _cli(label, "shrink", "--max-attempts", str(SHRINK_ATTEMPTS), store,
         "--device", dev_name)
    return delivery.deliver.launches


def run_forensics(dev, hunt, root, label, refs, shrink_refs):
    """Phase 10: the CLI's ``watch`` and ``triage`` on the card, triage
    held against the CPU (run by the reference workers ``refs``
    alongside), then the fuzz run and its ``shrink`` on the card and on
    the CPU, which ran in other processes (``shrink_refs``: futures of
    ``fuzz run``, ``card`` and ``cpu``). Returns the delivery launches of
    each path."""
    import os
    from maelstrom_tpu_torch.kernels import delivery
    on_card = dev.type == "cuda"
    run_dir = hunt["store-dir"]
    launches = {}

    t0 = time.monotonic()
    report = _cli(label, "watch", run_dir)
    if not report[-1].startswith("status: stopped"):
        raise AssertionError(f"{label}: watch report ends {report[-3:]}")
    log(f"{label}: watch exit 0 in {time.monotonic() - t0:.2f} s, "
        f"{len(report)} lines; {report[0]} ... {report[-1]}")

    t0 = time.monotonic()
    triage = ("triage", run_dir, "--max-instances", str(TRIAGE_MAX))
    cpu_out = os.path.join(root, "triage-cpu")
    cpu_triage = submit(refs, _cli, label, *triage, "-o", cpu_out,
                            "--device", "cpu")
    delivery.deliver.launches = 0
    _cli(label, *triage, "--device", str(dev))
    launches["triage"] = delivery.deliver.launches
    t_card = time.monotonic() - t0
    _, t_cpu = cpu_triage.result()
    card = _read_json(run_dir, "triage", "summary.json")
    cpu = _read_json(cpu_out, "summary.json")
    ids = [e["instance"] for e in card["triaged"]]
    want = min(TRIAGE_MAX, len(card["flagged"]))
    if not (len(ids) == want > 0 and card["replayed-violating"] == want):
        raise AssertionError(f"{label}: triage replayed {ids}, "
                             f"{card['replayed-violating']} tripped again")
    if on_card and launches["triage"] != card["ticks"]:
        raise AssertionError(f"{label}: delivery kernel launched "
                             f"{launches['triage']} times for "
                             f"{card['ticks']} replayed ticks")
    strip = lambda sm, d: json.dumps(sm, sort_keys=True).replace(d, "OUT")
    if strip(card, card["out-dir"]) != strip(cpu, cpu_out):
        raise AssertionError(f"{label}: card and CPU triage summaries "
                             f"differ")
    bundle = ("messages.svg", "journal.edn", "history.jsonl", "repro.json")
    for i in ids:
        _same_files(os.path.join(card["out-dir"], f"instance-{i}"),
                    os.path.join(cpu_out, f"instance-{i}"), bundle,
                    f"{label}: triage of instance {i}")
    log(f"{label}: triage replayed flagged instances {ids} over "
        f"{card['ticks']} ticks on {dev} in {t_card:.1f} s (CPU "
        f"{t_cpu:.1f} s, alongside): all {card['replayed-violating']} tripped "
        f"again, first-violation ticks "
        f"{[e['first-violation-tick'] for e in card['triaged']]}, journal "
        f"events {[e['journal-events'] for e in card['triaged']]}; "
        f"every bundle file ({', '.join(bundle)}) equal to the CPU's; "
        f"launches {launches['triage']}")

    fuzz, t_run = shrink_refs["fuzz run"].result()
    launches["fuzz run"] = fuzz["launches"]
    launches["shrink"], t_card = shrink_refs["card"].result()
    _, t_cpu = shrink_refs["cpu"].result()
    fuzz_dir, cpu_dir = fuzz["card"], fuzz["cpu"]
    card = _read_json(fuzz_dir, "triage", "shrink-summary.json")
    cpu = _read_json(cpu_dir, "triage", "shrink-summary.json")
    if len(card["shrunk"]) != 1:
        raise AssertionError(f"{label}: shrink summary {card}")
    rec, ref = dict(card["shrunk"][0]), dict(cpu["shrunk"][0])
    rec.pop("shrunk-plan-file"), ref.pop("shrunk-plan-file")
    if rec != ref or rec["verified"] is not True or not rec["kept"]:
        raise AssertionError(f"{label}: card shrink {rec} != CPU shrink "
                             f"{ref}, or unverified, or nothing kept")
    sub = os.path.join("triage", "instance-0")
    _same_files(os.path.join(fuzz_dir, sub), os.path.join(cpu_dir, sub),
                ("shrunk-plan.json",), f"{label}: shrink")
    replays = 1 + rec["attempts"] + (1 if rec["kept"] else 0)
    ticks = fuzz["ticks"]
    if on_card and (launches["shrink"] != replays * ticks
                    or launches["fuzz run"] != ticks):
        raise AssertionError(f"{label}: delivery kernel launched "
                             f"{launches} times for {replays} replays "
                             f"of {ticks} ticks")
    log(f"{label}: fuzz run of {FUZZ_SHRINK_MUTANT} stored on {dev} in "
        f"{t_run:.1f} s, instance 0 tripped; shrink on {dev} "
        f"{t_card:.1f} s, on the CPU {t_cpu:.1f} s (both in other "
        f"processes, during phases 4-9): "
        f"{rec['original-phases']} phase(s)/{rec['original-victims']} "
        f"victim(s) -> {rec['shrunk-phases']}/{rec['shrunk-victims']} in "
        f"{rec['attempts']} attempt(s), kept {rec['kept']}, verified "
        f"{rec['verified']}; the record and shrunk-plan.json equal to the "
        f"CPU's; launches {launches['fuzz run']} (run) + "
        f"{launches['shrink']} ({replays} replays)")
    return launches


def run_lanes_card_vs_cpu(dev, spec, opts, label, cpu_carries, cpu_test):
    """Phase 11 (a): the device verdict lanes on the double-vote mutant
    in ``both`` mode, card against CPU — every carry leaf
    (``check_summary`` included) at every 25th tick, then
    ``run_torch_test`` on each: the ``check`` block, the invariants, the
    network counters and every per-instance verdict equal, a non-empty
    flagged set, a complete audit, and the farm pooled. ``cpu_carries``
    and ``cpu_test`` are the futures of the CPU's tick loop and
    ``run_torch_test`` (:func:`submit`). Returns the card run's
    delivery launches."""
    from maelstrom_tpu_torch import harness
    from maelstrom_tpu_torch.checkers.pool import resolve_check_workers
    from maelstrom_tpu_torch.kernels import delivery
    check_small_run_matches_cpu(dev, "the device verdict lanes (" + label
                                + ")", _timed(_carries, spec, opts,
                                              str(dev)),
                                cpu_carries.result(), phase="phase 11")
    delivery.deliver.launches = 0
    t0 = time.monotonic()
    card = harness.run_torch_test(_make_model(spec), opts, device=str(dev))
    launches = delivery.deliver.launches
    t_card = time.monotonic() - t0
    cpu, t_cpu = cpu_test.result()
    for k in ("valid?", "check", "invariants", "net", "instances"):
        if card[k] != cpu[k]:
            raise AssertionError(f"phase 11 ({label}): {k} differs between "
                                 f"{dev} and the CPU")
    chk, rec = card["check"], card["perf"]["phases"]["check"]
    if card["valid?"] is not False or not chk["flagged-instance-ids"]:
        raise AssertionError(f"phase 11 ({label}): valid? {card['valid?']}"
                             f", flagged {chk['flagged-instance-ids']}")
    if not chk["device-vs-farm"]["complete"]:
        raise AssertionError(f"phase 11 ({label}): audit {chk}")
    if resolve_check_workers(opts.get("check_workers"),
                             opts["record_instances"]) > 0 \
            and rec["mode"] != "pooled":
        raise AssertionError(f"phase 11 ({label}): the farm did not run "
                             f"pooled: {rec}")
    ticks = card["perf"]["ticks"]
    if dev.type == "cuda" and launches != ticks:
        raise AssertionError(f"phase 11 ({label}): delivery kernel "
                             f"launched {launches} times for {ticks} "
                             f"ticks")
    log(f"phase 11 ({label}): run_torch_test on {dev} {t_card:.1f} s, on "
        f"the CPU {t_cpu:.1f} s in a reference worker: check, invariants, net and all "
        f"{len(card['instances'])} verdicts equal; flagged "
        f"{chk['flagged-instance-ids']}, audit complete, farm "
        f"{rec['mode']} x{rec['workers']}; launches {launches}")
    return launches


def run_sweep(dev, model, opts, mode):
    """Phase 11 (b): one ``check_mode`` of the correct model's
    fleet-scale sweep, the launch counter set to 0 just before and read
    just after: valid, the farm pooled, the delivery kernel once per
    tick."""
    from maelstrom_tpu_torch import harness
    from maelstrom_tpu_torch.kernels import delivery
    delivery.deliver.launches = 0
    t0 = time.monotonic()
    res = harness.run_torch_test(model, dict(opts, check_mode=mode),
                                 device=str(dev))
    wall = time.monotonic() - t0
    launches = delivery.deliver.launches
    rec, chk = res["perf"]["phases"]["check"], res["check"]
    ticks = res["perf"]["ticks"]
    log(f"phase 11 (sweep, {mode}): {model.name} x{res['instance-count']}"
        f", {res['checked-instances']} recorded, {ticks} ticks: valid?="
        f"{res['valid?']}, wall {wall:.1f} s, "
        f"{res['perf']['ticks-per-sec']:.2f} ticks/s, check-s "
        f"{rec['check-s']}, decode-s {rec['decode-s']}, feed-s "
        f"{rec.get('feed-s')}, farm {rec['mode']} x{rec['workers']}, "
        f"flagged-instances {chk['flagged-instances']}, farm-instances "
        f"{chk['farm-instances']}, farm-load-fraction "
        f"{chk['farm-load-fraction']}, launches {launches}")
    if rec["mode"] != "pooled":
        raise AssertionError(f"phase 11 (sweep, {mode}): the farm did not "
                             f"run pooled: {rec}")
    if res["valid?"] is not True:
        raise AssertionError(f"phase 11 (sweep, {mode}): valid? "
                             f"{res['valid?']!r}")
    if dev.type == "cuda" and launches != ticks:
        raise AssertionError(f"phase 11 (sweep, {mode}): delivery kernel "
                             f"launched {launches} times for {ticks} ticks")
    return res, launches


def flag_bits(dev, model, opts, ids):
    """Which FLAGS bits the lanes raised in instances ``ids``: a replay of
    just those instances with the lanes on."""
    from maelstrom_tpu_torch import harness, runtime
    from maelstrom_tpu_torch.checkers import device_summary as ds
    sim = harness.make_sim_config(model, dict(
        opts, n_instances=len(ids), record_instances=0,
        check_mode="device"))
    carry, _ = runtime.run_sim(model, sim, opts["seed"], dev,
                               torch.tensor(ids, dtype=torch.int32,
                                            device=dev))
    flags = carry.check_summary[:, ds.L_FLAGS].cpu().numpy()
    return {name: int(((flags & bit) != 0).sum()) for name, bit in (
        ("diverged", ds.FLAG_DIVERGED), ("regression", ds.FLAG_REGRESSION),
        ("model", ds.FLAG_MODEL))}


def _child_env():
    """The environment of a child ``python -m maelstrom_tpu_torch``: this
    checkout on its path."""
    import os
    repo = os.path.dirname(os.path.abspath(__file__))
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH")) if p))


def _ckpt_ticks(run_dir):
    """The tick frontier of ``run_dir``'s checkpoint (its header alone),
    or None."""
    import os
    from maelstrom_tpu_torch.campaign.checkpoint import checkpoint_path
    path = checkpoint_path(run_dir)
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return json.loads(bytes(z["__meta__"]).decode())["ticks"]


def _segment_rates(run_dir):
    """Ticks per second of each heartbeat segment (the killed run, then
    each resumed one): its ticks over its last chunk record's wall-s."""
    import os
    with open(os.path.join(run_dir, "heartbeat.jsonl")) as f:
        records = [json.loads(line) for line in f if line.strip()]
    rates, seg, start = [], [], None
    for rec in records:
        if rec.get("type") == "resume":
            seg, start = [], rec["from-ticks"]
            rates.append(None)
        elif rec.get("type") == "chunk":
            seg.append(rec)
            if start is None:
                start = 0
                rates.append(None)
            last = seg[-1]
            rates[-1] = round((last["t0"] + last["ticks"] - start)
                              / last["wall-s"], 3)
    return rates


def campaign_phase(dev_name, root, item_opts, kill_at):
    """Phase 12 in the side card worker: submit a one-item campaign,
    drain it in a child ``campaign run`` SIGKILLed at a checkpoint of
    tick ``kill_at`` or later, run the uninterrupted checkpointed
    reference here meanwhile, then ``campaign resume`` here. Checks the
    item against the reference; returns what the main process logs."""
    import os
    import signal
    import subprocess
    import threading
    from maelstrom_tpu_torch import harness
    from maelstrom_tpu_torch.campaign import queue as cqueue
    from maelstrom_tpu_torch.campaign.checkpoint import checkpoint_path
    from maelstrom_tpu_torch.kernels import delivery
    from maelstrom_tpu_torch.models import get_model
    label = "phase 12 (campaign)"
    spec = os.path.join(root, "flagship-campaign.json")
    with open(spec, "w") as f:
        json.dump({"name": "flagship", "items": [
            dict(item_opts, workload="lin-kv")]}, f)
    store = os.path.join(root, "campaign-store")
    cdir = _cli(label, "campaign", "submit", spec, "--store", store)[-1]
    out = {"cdir": cdir}
    child_log = os.path.join(root, "campaign-run.log")
    t0 = time.monotonic()
    with open(child_log, "w") as log_f:
        child = subprocess.Popen(
            [sys.executable, "-m", "maelstrom_tpu_torch", "campaign", "run",
             cdir, "--device", dev_name], env=_child_env(), stdout=log_f,
            stderr=subprocess.STDOUT)
    killed = {}

    def watch_and_kill():
        deadline = time.monotonic() + CHILD_DEADLINE_S
        while time.monotonic() < deadline and child.poll() is None:
            run_dir = cqueue.list_items(cdir)[0].get("run-dir")
            ticks = _ckpt_ticks(run_dir) if run_dir else None
            if ticks is not None and ticks >= kill_at:
                child.send_signal(signal.SIGKILL)
                killed.update(ticks=ticks, s=time.monotonic() - t0)
                return
            time.sleep(0.2)

    watcher = threading.Thread(target=watch_and_kill)
    watcher.start()
    try:
        # the uninterrupted reference, on the card alongside the child
        delivery.deliver.launches = 0
        t_ref = time.monotonic()
        ref = harness.run_torch_test(
            get_model("lin-kv", item_opts["node_count"]),
            dict(item_opts, store_root=os.path.join(root, "campaign-ref")),
            device=dev_name)
        out["ref_s"] = time.monotonic() - t_ref
        out["ref_launches"] = delivery.deliver.launches
    finally:
        watcher.join()
        if child.poll() is None:
            child.kill()
        child.wait()
    if not killed:
        with open(child_log) as f:
            tail = f.read()[-2000:]
        raise AssertionError(f"{label}: the child campaign run ended "
                             f"(rc {child.returncode}) or stalled before "
                             f"a checkpoint at tick {kill_at}: {tail}")
    item = cqueue.list_items(cdir)[0]
    if item["status"] != "running":
        raise AssertionError(f"{label}: the killed item is "
                             f"{item['status']}, not running")
    run_dir = item["run-dir"]
    delivery.deliver.launches = 0
    t_res = time.monotonic()
    lines = _cli(label, "campaign", "resume", cdir, "--device", dev_name)
    out["resume_s"] = time.monotonic() - t_res
    out["resume_launches"] = delivery.deliver.launches
    item = cqueue.list_items(cdir)[0]
    from maelstrom_tpu_torch.telemetry.stream import read_heartbeat
    hb = read_heartbeat(run_dir)
    results = _read_json(run_dir, "results.json")
    pipe = results["perf"]["phases"]["pipeline"]
    resumed_from = pipe.get("resumed-from-ticks")
    if not (item["status"] == "done" and item["valid?"] is True
            and item["resumed-from-checkpoint"] is True):
        raise AssertionError(f"{label}: item {item['status']}, valid? "
                             f"{item.get('valid?')}, resumed "
                             f"{item.get('resumed-from-checkpoint')}: "
                             f"{lines[-5:]}")
    ticks = results["perf"]["ticks"]
    if len(hb["resumes"]) != 1 or hb["end"] is None \
            or hb["end"]["ticks"] != ticks:
        raise AssertionError(f"{label}: heartbeat seams {hb['resumes']}, "
                             f"end {hb['end']}")
    if resumed_from is None or resumed_from < killed["ticks"]:
        raise AssertionError(f"{label}: resumed from {resumed_from}, the "
                             f"child was killed at a checkpoint of tick "
                             f"{killed['ticks']}")
    ref_j = json.loads(json.dumps(ref, default=repr))
    differ = [k for k in set(results) | set(ref_j)
              if k not in ("perf", "store-dir")
              and results.get(k) != ref_j.get(k)]
    if differ:
        raise AssertionError(f"{label}: the resumed item's results differ "
                             f"from the uninterrupted run's in {differ}")
    n_hist = results["checked-instances"]
    _same_files(run_dir, ref["store-dir"],
                [f"history-{i}.jsonl" for i in range(n_hist)], label)
    if dev_name != "cpu" and (out["resume_launches"] != ticks - resumed_from
                              or out["ref_launches"] != ticks):
        raise AssertionError(f"{label}: delivery kernel launched "
                             f"{out['resume_launches']} times for the "
                             f"{ticks - resumed_from} resumed ticks and "
                             f"{out['ref_launches']} for the reference's "
                             f"{ticks}")
    ref_pipe = ref["perf"]["phases"]["pipeline"]
    out.update(
        killed_at=killed["ticks"], killed_after_s=killed["s"],
        resumed_from=resumed_from, ticks=ticks, net=results["net"],
        npz_bytes=os.path.getsize(checkpoint_path(run_dir)),
        ref_save_s=ref_pipe.get("checkpoint-save-s"),
        resume_save_s=pipe.get("checkpoint-save-s"),
        restore_s=results["perf"]["phases"].get("restore-s"),
        ref_tps=ref["perf"]["ticks-per-sec"],
        segment_tps=_segment_rates(run_dir), histories=n_hist,
        attempts=item["attempts"])
    return out


def checkpoint_run(dev_name, root, opts):
    """Phase 12's small checkpointed flagship on ``dev_name``: the path of
    the last ``state.npz`` it wrote."""
    import os
    from maelstrom_tpu_torch import fleets, harness
    from maelstrom_tpu_torch.campaign.checkpoint import checkpoint_path
    model, _ = fleets.fleet("lin-kv")
    res = harness.run_torch_test(model, dict(
        opts, store_root=os.path.join(root, f"checkpoint-{dev_name}")),
        device=dev_name)
    return checkpoint_path(res["store-dir"])


def same_npz(a, b, label):
    """Two ``state.npz`` files equal array by array: the same keys, and
    every array's dtype, shape and values, the header included."""
    with np.load(a) as x, np.load(b) as y:
        if sorted(x.files) != sorted(y.files):
            raise AssertionError(f"{label}: keys differ")
        for k in x.files:
            if x[k].dtype != y[k].dtype or x[k].shape != y[k].shape \
                    or not np.array_equal(x[k], y[k]):
                raise AssertionError(f"{label}: {k} differs")
        header = json.loads(bytes(x["__meta__"]).decode())
        return len(x.files), header


def mesh_devices(dev_name, n):
    """``n`` shards' devices: round-robin over the visible cards (so two
    shards sit on the first two cards, or both on ``cuda:0`` on a
    one-card host), or ``n`` CPU shards."""
    if dev_name == "cpu":
        return [torch.device("cpu")] * n
    vis = torch.cuda.device_count()
    return [torch.device("cuda", s % vis) for s in range(n)]


def mesh_sim(model, opts, n_shards):
    """The fleet's per-shard sim at ``n_shards`` shards of
    ``MESH["n_global"]`` (or ``opts["n_global"]``) instances."""
    from maelstrom_tpu_torch import harness
    g = opts["n_global"]
    return harness.make_sim_config(model, dict(
        opts["fleet"], n_instances=g // n_shards,
        record_instances=opts["recorded"] // n_shards,
        time_limit=opts["time_limit"]))


def mesh_run(model, sim, seed, devices, chunk, **kw):
    """``run_sim_sharded_chunked`` on ``devices``, the launch counts set
    to 0 just before and read just after: ``(outputs, perf, wall s,
    launches by device)``."""
    from maelstrom_tpu_torch.kernels import delivery
    from maelstrom_tpu_torch.parallel import mesh
    perf = {}
    delivery.reset_launches()
    t0 = time.monotonic()
    out = mesh.run_sim_sharded_chunked(
        model, sim, seed, mesh=mesh.make_mesh(devices=devices), chunk=chunk,
        perf=perf, return_telemetry=True, **kw)
    wall = time.monotonic() - t0
    return out, perf, wall, dict(delivery.deliver.launches_by_device)


def same_mesh_outputs(ref, got, label):
    """Stats, violations, events and every merged telemetry leaf equal."""
    if tuple(ref[0]) != tuple(got[0]):
        raise AssertionError(f"{label}: stats {tuple(got[0])} differ from "
                             f"{tuple(ref[0])}")
    for name, a, b in (("violations", ref[1], got[1]),
                       ("events", ref[2], got[2])):
        if a.shape != b.shape or not np.array_equal(a, b):
            raise AssertionError(f"{label}: {name} differ")
    for f, a, b in zip(ref[3]._fields, ref[3], got[3]):
        if not np.array_equal(a, b):
            raise AssertionError(f"{label}: telemetry {f} differs")


def expect_launches(by_dev, devices, ticks, label, on_card):
    """The delivery kernel once per tick on every shard, by device."""
    want = {}
    for d in devices:
        want[str(d)] = want.get(str(d), 0) + ticks
    if on_card and by_dev != want:
        raise AssertionError(f"{label}: delivery launches by device "
                             f"{by_dev}, expected {want}")


def mesh_phase(dev_name, root, opts):
    """Phase 13 in its card worker: the 1-shard reference, the 2-shard run
    (checkpointed at ``ckpt_tick``), and the resume of that checkpoint at
    ``reshard`` shards, each held equal to the reference; the
    reference's recorded instances checked. Returns what the main
    process logs."""
    import os
    from maelstrom_tpu_torch import decode, fleets, harness
    from maelstrom_tpu_torch.campaign import checkpoint as ckpt
    from maelstrom_tpu_torch.checkers.pool import check_instances
    from maelstrom_tpu_torch.parallel import mesh
    from maelstrom_tpu_torch.pipeline import ResumeState
    label = "phase 13 (shards)"
    on_card = dev_name != "cpu"
    model, _ = fleets.fleet("lin-kv")
    seed = int(opts["fleet"]["seed"])
    chunk = opts["chunk"]
    out = {"visible": torch.cuda.device_count() if on_card else 0,
           "launches": {}, "rates": {}}
    sim1 = mesh_sim(model, opts, 1)
    ticks = sim1.n_ticks
    devs1 = mesh_devices(dev_name, 1)
    # a process's first run pays for the CUDA context: not timed
    mesh_run(model, mesh_sim(model, dict(opts, n_global=opts["recorded"],
                                         time_limit=0.01), 1),
             seed, devs1, chunk)
    ref, perf, wall, by_dev = mesh_run(model, sim1, seed, devs1, chunk)
    expect_launches(by_dev, devs1, ticks, f"{label}: 1 shard", on_card)
    out["launches"]["1 shard"] = by_dev
    out["rates"]["S=1"] = (ticks / wall, int(ref[0].delivered) / wall,
                           perf)
    hists = decode.LazyHistories(model, decode.decode_dense(model, ref[2]),
                                 opts["recorded"], sim1.client.final_start,
                                 harness.MS_PER_TICK)
    verdicts = check_instances(model, hists,
                               {**harness.TORCH_DEFAULTS, **opts["fleet"]},
                               final_start=sim1.client.final_start)
    out["valid"] = [v.get("valid?") for v in verdicts]
    if out["valid"] != [True] * opts["recorded"]:
        raise AssertionError(f"{label}: the reference's recorded instances "
                             f"are not all valid: {out['valid']}")
    # two shards, a checkpoint at ckpt_tick
    sim2 = mesh_sim(model, opts, 2)
    devs2 = mesh_devices(dev_name, 2)
    out["devices"] = [str(d) for d in devs2]
    ck_dir = os.path.join(root, "mesh-checkpoint")
    sink = ckpt.make_checkpoint_cb(ck_dir, kind=ckpt.KIND_SHARDED)
    saves = []

    def at_ckpt_tick(state, t, host):
        if t == opts["ckpt_tick"]:
            t_s = time.monotonic()
            sink(state, t, host)
            saves.append(time.monotonic() - t_s)

    got, perf, wall, by_dev = mesh_run(
        model, sim2, seed, devs2, chunk, checkpoint_cb=at_ckpt_tick,
        checkpoint_every=opts["ckpt_tick"] // chunk)
    same_mesh_outputs(ref, got, f"{label}: 2 shards")
    expect_launches(by_dev, devs2, ticks, f"{label}: 2 shards", on_card)
    out["launches"]["2 shards"] = by_dev
    # the save's own time is not the shards'
    run_s = wall - sum(perf.get("checkpoint-save-s", []))
    out["rates"]["S=2"] = (ticks / run_s, int(got[0].delivered) / run_s,
                           perf)
    if len(saves) != 1:
        raise AssertionError(f"{label}: {len(saves)} saves at tick "
                             f"{opts['ckpt_tick']}")
    out["checkpoint_s"] = saves[0]
    out["npz_bytes"] = os.path.getsize(ckpt.checkpoint_path(ck_dir))
    # the tick-ckpt_tick checkpoint resumed at another shard count
    S = opts["reshard"]
    simr = mesh_sim(model, opts, S)
    devsr = mesh_devices(dev_name, S)
    t_r = time.monotonic()
    ck = ckpt.load_checkpoint(ck_dir)
    wire = ckpt.restore_carry(
        mesh.wire_template(model, simr, mesh.make_mesh(devices=devsr)),
        ck["carry"], shard=ck["meta"]["shard"])
    out["restore_s"] = time.monotonic() - t_r
    resume = ResumeState(carry=wire, ticks=ck["ticks"], chunks=ck["chunks"],
                         events=tuple(ck["events"]))
    got, perf, wall, by_dev = mesh_run(model, simr, seed, devsr, chunk,
                                       resume=resume)
    same_mesh_outputs(ref, got, f"{label}: resumed at {S} shards")
    expect_launches(by_dev, devsr, ticks - ck["ticks"],
                    f"{label}: resumed at {S} shards", on_card)
    out["launches"][f"{S} shards, resumed suffix"] = by_dev
    out["resumed"] = (ck["meta"]["shard"]["n-shards"], ck["ticks"], S)
    out["rates"][f"S={S} resumed"] = ((ticks - ck["ticks"]) / wall, None,
                                      perf)
    out["net"] = {f: int(x) for f, x in zip(ref[0]._fields, ref[0])}
    return out


def small_mesh_checkpoint(dev_name, root, opts):
    """Phase 13's small sharded checkpointed flagship on ``dev_name``: the
    path of its last ``state.npz``."""
    import os
    from maelstrom_tpu_torch import fleets, harness
    from maelstrom_tpu_torch.campaign import checkpoint as ckpt
    from maelstrom_tpu_torch.parallel import mesh
    model, fl = fleets.fleet("lin-kv")
    o = small(fl, opts["n_instances"], opts["time_limit"])
    sim = harness.make_sim_config(model, o)
    d = os.path.join(root, f"mesh-small-{dev_name}")
    mesh.run_sim_sharded_chunked(
        model, sim, int(o["seed"]),
        mesh=mesh.make_mesh(devices=mesh_devices(dev_name, 2)),
        chunk=opts["chunk"], checkpoint_every=opts["every"],
        checkpoint_cb=ckpt.make_checkpoint_cb(d, kind=ckpt.KIND_SHARDED))
    return ckpt.checkpoint_path(d)


def _profiled_run(model, opts, dev_name, root, name):
    """``run_torch_test`` stored under ``root``, the delivery launches
    set to 0 just before and read just after: ``(results, final carry
    with numpy leaves, launches, wall s)``. The carry is the one the
    chunked executor returns to the harness."""
    import os
    from maelstrom_tpu_torch import convert, harness, pipeline
    from maelstrom_tpu_torch.kernels import delivery
    run = pipeline.run_sim_pipelined
    kept = {}

    def keep(*args, **kw):
        res = run(*args, **kw)
        kept["carry"] = convert.carry_to_numpy(res.carry)
        return res

    pipeline.run_sim_pipelined = keep
    delivery.deliver.launches = 0
    t0 = time.monotonic()
    try:
        res = harness.run_torch_test(model, dict(
            opts, store_root=os.path.join(root, name)), device=dev_name)
    finally:
        pipeline.run_sim_pipelined = run
    return (res, kept.get("carry"), delivery.deliver.launches,
            time.monotonic() - t0)


def profile_phase(dev_name, root, opts):
    """Phase 14 in phase 13's card worker: the flagship with
    ``device_profile`` off, auto and on in turns, each held to the
    off run's carry, counters and verdict; the profiled runs' heartbeat
    lanes and roll-up checked; ``profile`` on the "on" run in a child
    process; a ``profile_dir`` run; the bench module in a child process.
    Returns what the main process logs."""
    import glob
    import os
    import subprocess
    from maelstrom_tpu_torch import convert, fleets
    from maelstrom_tpu_torch.faults import BENCH_FUZZ_DIST
    from maelstrom_tpu_torch.telemetry.profiler import PHASE_LABELS
    from maelstrom_tpu_torch.telemetry.stream import read_heartbeat
    label = "phase 14 (device profile)"
    on_card = dev_name != "cpu"
    source = "trace" if on_card else "timed"
    model, _ = fleets.fleet("lin-kv")
    base = dict(opts["fleet"], time_limit=opts["time_limit"],
                chunk_ticks=opts["chunk"], pipeline="on",
                fault_fuzz=BENCH_FUZZ_DIST)
    out = {"runs": {}, "launches": {}}
    ref = None
    for mode in opts["modes"]:
        res, carry, launches, wall = _profiled_run(
            model, dict(base, device_profile=mode), dev_name, root,
            f"profile-{mode}")
        ticks = res["perf"]["ticks"]
        if on_card and launches != ticks:
            raise AssertionError(f"{label} ({mode}): {launches} delivery "
                                 f"launches for {ticks} ticks")
        view = (res["valid?"], res["net"], res["invariants"])
        if ref is None:
            ref = (view, carry)
        else:
            if view != ref[0]:
                raise AssertionError(f"{label}: the {mode} run's verdict or "
                                     f"counters differ from the off run's")
            want = dict(convert.carry_leaves(ref[1]))
            for name, x in convert.carry_leaves(carry):
                if not np.array_equal(x, want.pop(name)):
                    raise AssertionError(f"{label}: the {mode} run's carry "
                                         f"differs from the off run's: "
                                         f"{name}")
            if want:
                raise AssertionError(f"{label}: leaves missing: {want}")
        if res["valid?"] is not True:
            raise AssertionError(f"{label} ({mode}): valid? "
                                 f"{res['valid?']}")
        dev = res["perf"]["phases"].get("device")
        chunks = read_heartbeat(res["store-dir"])["chunks"]
        lanes = [c for c in chunks if c.get("device-ms")]
        n_chunks = len(chunks)
        if mode == "off":
            if dev is not None or lanes:
                raise AssertionError(f"{label}: the off run has device "
                                     f"records")
        else:
            # auto captures chunks 0-2, which are all of a 3-chunk run
            want_n = n_chunks if mode == "on" else min(n_chunks, 3)
            if dev is None or dev["captured-chunks"] != want_n \
                    or dev["source"] != source or len(lanes) != want_n:
                raise AssertionError(f"{label} ({mode}): roll-up {dev}, "
                                     f"{len(lanes)} lanes of {n_chunks}")
            for c in lanes:
                if not set(c["device-ms"]) <= set(PHASE_LABELS) \
                        or c["device-source"] != source:
                    raise AssertionError(f"{label} ({mode}): chunk record "
                                         f"{c}")
        out["runs"][mode] = {
            "ticks-per-s": res["perf"]["ticks-per-sec"], "wall-s": wall,
            "device": dev,
            "chunks": [{"chunk": c["chunk"], "device-s": c.get("device-s"),
                        "phase-sum-ms": (round(sum(c["device-ms"].values()),
                                               4)
                                         if c.get("device-ms") else None),
                        "issue-s": s}
                       for c, s in zip(chunks, res["perf"]["phases"][
                           "pipeline"]["chunk-issue-s"])]}
        out["launches"][f"phase 14 {mode}"] = launches
        if mode == "on":
            out["run_dir"] = res["store-dir"]
    # the profile report of the "on" run, as a user runs it
    repo = os.path.dirname(os.path.abspath(__file__))
    p = subprocess.run([sys.executable, "-m", "maelstrom_tpu_torch",
                        "profile", out["run_dir"]], cwd=repo,
                       env=_child_env(), capture_output=True, text=True,
                       timeout=120)
    if p.returncode != 0 or "hot scope:" not in p.stdout:
        raise AssertionError(f"{label}: profile exited {p.returncode}: "
                             f"{p.stdout[-500:]} {p.stderr[-500:]}")
    out["report"] = p.stdout.strip().splitlines()
    # a torch.profiler session over a short run
    trace_dir = os.path.join(root, "profile-trace")
    res, _, launches, wall = _profiled_run(
        model, dict(base, time_limit=opts["trace_ticks"] / 1000.0,
                    device_profile="off", profile_dir=trace_dir),
        dev_name, root, "profile-dir")
    traces = glob.glob(os.path.join(trace_dir, "trace-*.json"))
    if "profile-error" in res["perf"]["phases"] or len(traces) != 1:
        raise AssertionError(f"{label}: profile_dir: "
                             f"{res['perf']['phases'].get('profile-error')}"
                             f", traces {traces}")
    out["trace"] = {"bytes": os.path.getsize(traces[0]), "wall-s": wall,
                    "ticks": res["perf"]["ticks"]}
    out["launches"]["phase 14 profile_dir run"] = launches
    # the bench module, as a user runs it (no card: it must refuse)
    t_b = time.monotonic()
    p = subprocess.run([sys.executable, "-m", "maelstrom_tpu_torch.bench"],
                       cwd=repo, capture_output=True, text=True,
                       timeout=600, env=dict(
                           _child_env(),
                           BENCH_SIM_SECONDS=str(opts["bench_seconds"])))
    if not on_card:
        if p.returncode == 0 or "needs a CUDA card" not in p.stderr:
            raise AssertionError(f"{label}: the bench ran without a card")
        out["bench"] = None
        return out
    line = json.loads(p.stdout.strip().splitlines()[-1]) \
        if p.returncode == 0 else {}
    keys = ("metric", "value", "unit", "vs_baseline", "platform", "engine",
            "config", "inbox_k", "pool_slots", "instances", "sim_ticks",
            "delivered", "delivered_timed", "sent", "dropped_overflow",
            "wall_s", "msg_lanes", "bytes_per_msg_row", "fault_fuzz",
            "device_profile", "device_ms_per_tick",
            "device_phase_ms_per_tick")
    missing = [k for k in keys if k not in line]
    if missing or not line.get("value", 0) > 0 \
            or line["metric"] != "simulated_msgs_per_sec":
        raise AssertionError(f"{label}: bench exited {p.returncode}, "
                             f"missing {missing}: {p.stdout[-800:]} "
                             f"{p.stderr[-800:]}")
    out["bench"] = (line, time.monotonic() - t_b)
    return out


def log_profile_phase(dev, profile_ref):
    """Phase 14's results, logged in the main process: the delivery
    launches of its runs."""
    from maelstrom_tpu_torch.kernels.devtime import card_line
    label = "phase 14 (device profile)"
    m, t_prof = profile_ref.result()
    card = card_line() if dev.type == "cuda" else "no card (rehearsal)"
    runs = m["runs"]
    log(f"{label}: off, auto and on end with the same carry (every leaf), "
        f"counters and verdict; ticks/s "
        + ", ".join(f"{mode} {r['ticks-per-s']:.3f}"
                    for mode, r in runs.items()) + f" ({card})")
    for mode, r in runs.items():
        dev_rec = r["device"]
        if dev_rec:
            per = dev_rec["per-phase-ms-per-tick"]
            log(f"{label}: {mode}: {dev_rec['captured-chunks']} captured "
                f"chunks, source {dev_rec['source']}, device "
                f"{dev_rec['ms-per-tick']} ms/tick; per phase "
                f"{json.dumps(per)} (sum {sum(per.values()):.5f})")
        for c in r["chunks"]:
            log(f"{label}: {mode} chunk {c['chunk']}: issue "
                f"{c['issue-s']} s, device wall "
                + (f"{c['device-s']} s, phase sum {c['phase-sum-ms']} ms"
                   if c["device-s"] is not None else "not captured"))
    for line in m["report"]:
        log(f"{label}: profile | {line}")
    t = m["trace"]
    log(f"{label}: profile_dir: a {t['ticks']}-tick run wrote a "
        f"{t['bytes']} B Chrome trace; the run took {t['wall-s']:.1f} s")
    if m["bench"] is not None:
        line, t_b = m["bench"]
        log(f"{label}: bench module ({t_b:.1f} s): {json.dumps(line)}")
    log(f"{label}: launches {json.dumps(m['launches'])}; the worker's "
        f"phase 14 took {t_prof:.1f} s")
    return m["launches"]


def small(opts, n_instances=24, time_limit=0.3, interval=0.1):
    """A fleet's options cut to a small input: partitions every
    ``interval`` s, healed 0.05 s before the end."""
    return dict(opts, n_instances=n_instances, time_limit=time_limit,
                nemesis_interval=interval, recovery_time=0.05)


def main(argv) -> int:
    start = time.monotonic()

    def mark(phase):
        # on standard error too: a run stopped at its time limit shows
        # how far it got
        line = f"{phase} finished {time.monotonic() - start:.1f} s into " \
               f"the script"
        log(line)
        print(line, file=sys.stderr, flush=True)

    rehearse = "--rehearse-on-cpu" in argv
    if not rehearse and not torch.cuda.is_available():
        log("chip_smoke: no CUDA card (torch.cuda.is_available() is "
            "False); nothing run")
        return 1
    import maelstrom_tpu_torch  # noqa: F401 — fails outside the repo
    from maelstrom_tpu_torch import fleets
    from maelstrom_tpu_torch.kernels import delivery_cases
    from maelstrom_tpu_torch.models import get_model
    dev = torch.device("cpu" if rehearse else "cuda")
    shapes = dict(delivery_cases.SHAPES)
    flagship, opts = fleets.fleet("lin-kv")
    paths = {w: fleets.fleet(w) for w in TUTORIAL if w != "broadcast"}
    bmodel, bopts = fleets.fleet("broadcast")
    txn_paths = {w: fleets.fleet(w) for w in TXN_KAFKA}
    hunt_model, hunt_opts = fleets.fleet(BUG_HUNT_MUTANT)
    # instance 0 journaled: every row of the fleet carries the NETID lane
    hunt_opts |= dict(time_limit=BUG_HUNT_TIME_LIMIT, journal_instances=1)
    lanes_opts = dict(LANES_MUTANT)
    sweep_model = get_model("lin-kv", fleets.BUG_HUNT["node_count"])
    sweep_opts = dict(fleets.BUG_HUNT, fail_fast=False,
                      record_instances=SWEEP_RECORDED,
                      time_limit=SWEEP_TIME_LIMIT)
    campaign = (dict(fleets.FLAGSHIP, **CAMPAIGN), KILL_AT_TICKS,
                small(fleets.FLAGSHIP) | SMALL_CHECKPOINT)
    mesh_opts = dict(MESH, fleet=dict(fleets.FLAGSHIP))
    # paths cut to keep the script well inside its 1,200 s limit on a
    # slow host (PERF.md §6): the flagship to 1 s (from 4; healed at
    # tick 700), the broadcast fleet to 1 s (from 2; healed at tick
    # 700), the families to 0.4 s (from 1, then 0.6: healed before the
    # first partition phase at tick 400; at 0.3 s g-counter's final
    # reads come before it converges), the txn fleets and kafka to 0.5 s
    # (from 1, then 0.8; txn-list-append from 1; healed at tick 200)
    opts["time_limit"] = FLAGSHIP_TIME_LIMIT
    bopts["time_limit"] = 1.0
    for _, o in paths.values():
        o["time_limit"] = 0.4
    for _, o in txn_paths.values():
        o["time_limit"] = 0.5
    for o in ([opts, bopts, hunt_opts, sweep_opts]
              + [o for _, o in paths.values()]
              + [o for _, o in txn_paths.values()]):
        o.update(NO_PROFILE)
    profile_opts = dict(PROFILE, fleet=dict(fleets.FLAGSHIP))
    if rehearse:
        # small ops: one thread is as fast, and spares a loaded host
        torch.set_num_threads(1)
        shapes = {name: shape[:5] + (min(shape[5], 64),)
                  for name, shape in shapes.items()}
        opts = small(opts, 16)
        # 25 nodes need about 1 s to converge after the heal: the
        # rehearsal checks the script's logic on a 5-node tree
        bmodel = get_model("broadcast", 5, fleets.BROADCAST_25_TOPOLOGY)
        bopts = small(bopts, 4, 0.2) | dict(node_count=5, concurrency=5)
        paths = {w: (m, small(o, 8, 0.2) | dict(recovery_time=0.1))
                 for w, (m, o) in paths.items()}
        # Raft elects its first leader after 60-120 ticks: 0.3 s leaves
        # the txn fleets time to commit
        txn_paths = {w: (m, small(o, 8, 0.3) | dict(recovery_time=0.1))
                     for w, (m, o) in txn_paths.items()}
        # double-vote trips at tick 86 at 32 instances: the stop comes
        # after the third of four 50-tick chunks
        hunt_opts |= dict(n_instances=32, record_instances=2,
                          time_limit=0.2, chunk_ticks=50, funnel_max=4)
        lanes_opts |= dict(n_instances=16, record_instances=16,
                           time_limit=0.15)
        sweep_opts |= dict(n_instances=64, record_instances=32,
                           time_limit=0.1, chunk_ticks=50)
        # one checkpoint (tick 100 of 200) to kill at
        campaign = (campaign[0] | dict(n_instances=16, time_limit=0.2,
                                       chunk_ticks=50), 100, campaign[2])
        mesh_opts = dict(mesh_opts, n_global=32, time_limit=0.2, chunk=50,
                         ckpt_tick=100, fleet=small(fleets.FLAGSHIP))
        profile_opts = dict(profile_opts, time_limit=0.15, chunk=50,
                            trace_ticks=20, fleet=small(fleets.FLAGSHIP, 16))
    limit = None
    if "--time-limit" in argv:
        limit = float(argv[argv.index("--time-limit") + 1])
        opts["time_limit"] = limit
        if not rehearse:
            # the 25-node tree takes ~1 s to converge (0.3 s of recovery)
            bopts["time_limit"] = max(min(limit, bopts["time_limit"]), 1.0)
        for _, o in list(paths.values()) + list(txn_paths.values()):
            o["time_limit"] = min(limit, o["time_limit"])
    full = not rehearse and limit is None
    if not rehearse:
        from maelstrom_tpu_torch.kernels import build
        t0 = time.monotonic()
        build.build_all(["deliver"])
        log(f"phase 1: built csrc/deliver.cu in "
            f"{time.monotonic() - t0:.1f} s")
        for name, text in build.build_logs.items():
            for line in text.strip().splitlines():
                log(f"phase 1: nvcc[{name}] {line.strip()}")
        log(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda} "
            f"on {torch.cuda.get_device_name(0)}")

    record = check_delivery(dev, shapes, 5 if rehearse else 200)
    mark("phase 2")
    lanes_spec = ("model", "lin-kv-bug-double-vote", 3,
                  {"raft_kw": LANES_MUTANT_KW})
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix="bug-hunt-store-")
    refs, side = worker_pool(2, cuda=False), worker_pool(1, cuda=True)
    # phase 13's card work: a card worker of its own, alongside the rest
    shards = worker_pool(1, cuda=True)
    try:
        mesh_refs = (
            submit(shards, mesh_phase, str(dev), root, mesh_opts),
            submit(shards, small_mesh_checkpoint, str(dev), root,
                   SMALL_MESH),
            submit(refs, small_mesh_checkpoint, "cpu", root, SMALL_MESH))
        # phase 14's card work: behind phase 13, in its card worker
        profile_ref = submit(shards, profile_phase, str(dev), root,
                             profile_opts)
        return drive_paths(dev, full, rehearse, record, mark, refs, side,
                           root, opts, flagship, bopts, bmodel, paths,
                           txn_paths, hunt_model, hunt_opts, lanes_spec,
                           lanes_opts, sweep_model, sweep_opts, campaign,
                           mesh_refs, profile_ref)
    finally:
        for pool in (shards, side, refs):
            pool.shutdown(wait=True, cancel_futures=True)
        shutil.rmtree(root, ignore_errors=True)


def log_mesh_phase(dev, mesh_ref, card_npz_ref, cpu_npz_ref):
    """Phase 13's results, checked and logged in the main process: the
    delivery launches of each of its runs, by device."""
    from maelstrom_tpu_torch.kernels.devtime import card_line
    label = "phase 13 (shards)"
    m, t_mesh = mesh_ref.result()
    (card_npz, t_card), (cpu_npz, t_cpu) = (card_npz_ref.result(),
                                            cpu_npz_ref.result())
    card = card_line() if dev.type == "cuda" else "no card (rehearsal)"
    g = m["rates"]
    log(f"{label}: {m['visible']} visible card(s); the two shards on "
        f"{m['devices']}; {card}")
    log(f"{label}: the 1-shard reference and the 2-shard run agree on "
        f"stats, violations, events and every merged telemetry leaf; the "
        f"recorded instances' verdicts {m['valid']}; net "
        f"{json.dumps(m['net'])}")
    s0, t0, s1 = m["resumed"]
    log(f"{label}: the {s0}-shard checkpoint at tick {t0} resumed at {s1} "
        f"shards equals the reference; state.npz {m['npz_bytes']} B, "
        f"checkpoint-s {m['checkpoint_s']:.4f}, restore-s "
        f"{m['restore_s']:.4f} ({card})")
    for name, (tps, mps, perf) in g.items():
        log(f"{label}: {name}: {tps:.3f} ticks/s"
            + ("" if mps is None else f", {mps:.0f} simulated msgs/s")
            + f"; shard-issue-s {perf['shard-issue-s']}, merge-s "
              f"{perf['merge-s']}, init-s {perf['init-s']} ({card})")
    log(f"{label}: the worker's phase 13 took {t_mesh:.1f} s")
    n_arrays, header = same_npz(card_npz, cpu_npz,
                                "phase 13 (sharded checkpoint, card vs CPU)")
    log(f"phase 13 (sharded checkpoint, card vs CPU): the 2 x "
        f"{SMALL_MESH['n_instances']}-instance sharded flagship's state.npz "
        f"at tick {header['ticks']} ({n_arrays} arrays, "
        f"{header['n-events']} event blocks) on {dev} ({t_card:.1f} s) "
        f"equals the CPU's ({t_cpu:.1f} s) array by array, header "
        f"included")
    return {f"phase 13 {k}": v for k, v in m["launches"].items()}


def phase3_runs(opts, bopts, paths):
    """Phase 3's small card-against-CPU runs: ``(label, model spec,
    options)``."""
    from maelstrom_tpu_torch import fleets
    runs = [("an active four-lane fault distribution", ("fleet", "lin-kv",
             None), small(opts, time_limit=0.25)
             | dict(fault_fuzz=ACTIVE_FUZZ)),
            ("an active fault plan (crash, links, skew, membership)",
             ("fleet", "lin-kv", None), small(opts, time_limit=0.25)
             | dict(fault_plan=ACTIVE_PLAN))]
    for w in TUTORIAL:
        o = bopts if w == "broadcast" else paths[w][1]
        label = w
        if w in ("g-set", "pn-counter"):
            # 150 ticks, partitioned in [50, 100) (cut from 200)
            o = small(o, time_limit=0.15, interval=0.05)
            o["fault_plan"] = CRASH_LINKS_PLAN
            label += " under a crash and links plan"
        else:
            # 100 ticks, partitioned in [25, 50) (cut from 150)
            o = small(o, time_limit=0.1, interval=0.025)
        runs.append((label, ("fleet", w, None), o))
    for label, w, mopts, plan in TXN_KAFKA_SMALL:
        # 150 ticks (cut from 200), the plan healed at tick 100
        o = small(fleets.fleet(w, mopts)[1], time_limit=0.15)
        if plan is not None:
            o["fault_plan"] = plan
        runs.append((label, ("fleet", w, mopts), o))
    # the bug hunt's own mutant is held card against CPU by phase 10's
    # triage of the bug hunt's trippers
    runs.append(("the scripted rotating-majorities schedule "
                 "(lin-kv-bug-no-term-guard, 5 nodes)",
                 ("model", "lin-kv-bug-no-term-guard", 5, {}),
                 dict(FIGURE8_SMALL, nemesis_schedule=(
                     fleets.rotating_majorities(5, 50, 150)))))
    return runs


def drive_paths(dev, full, rehearse, record, mark, refs, side, root, opts,
                flagship, bopts, bmodel, paths, txn_paths, hunt_model,
                hunt_opts, lanes_spec, lanes_opts, sweep_model,
                sweep_opts, campaign, mesh_refs, profile_ref) -> int:
    """Phases 3-12 and the result lines. Phase 10's fuzz run and card
    shrink, then phase 3's card runs, then phase 12's card work go to
    the side card worker ``side``, and the CPU halves of phases 3, 10,
    11 (a) and 12 to the reference workers ``refs``, while this process
    drives phases 4-9; phase 3 is checked after phase 9, phase 12 after
    phase 11. ``campaign`` is phase 12's ``(item options, kill tick,
    small checkpointed run's options)``."""
    import os
    from maelstrom_tpu_torch.faults import BENCH_FUZZ_DIST
    dev_name = str(dev)
    forensics = "phase 10 (forensics)"
    shrink_refs = {"fuzz run": submit(side, fuzz_run, dev_name, root),
                   "card": submit(side, shrink, dev_name,
                                  os.path.join(root, "fuzz-card"),
                                  forensics)}
    small_runs = [] if rehearse else phase3_runs(opts, bopts, paths)
    small_refs = [(submit(side, _carries, spec, o, dev_name),
                   submit(refs, _carries, spec, o, "cpu"))
                  for _, spec, o in small_runs]
    lanes_refs = (
        submit(refs, _carries, lanes_spec, lanes_opts, "cpu"),
        # the serial farm on the CPU: a pool gives the same verdicts
        # byte for byte (tests/test_torch_check_pool.py)
        submit(refs, _cpu_test, lanes_spec,
               dict(lanes_opts, check_workers=0)))
    item_opts, kill_at, small_ckpt = campaign
    campaign_refs = (
        submit(side, campaign_phase, dev_name, root, item_opts, kill_at),
        submit(side, checkpoint_run, dev_name, root, small_ckpt),
        submit(refs, checkpoint_run, "cpu", root, small_ckpt))
    res, launches = run_path(dev, flagship,
                             dict(opts, fault_fuzz=BENCH_FUZZ_DIST),
                             "phase 4 (flagship, BENCH_FUZZ_DIST)")
    if full and res["net"] != FLAGSHIP_NET:
        raise AssertionError(f"phase 4 network counters {res['net']} "
                             f"differ from the bare flagship's "
                             f"{FLAGSHIP_NET}")
    if full:
        log("phase 4: network counters equal the bare flagship run's "
            "exactly")
    mark("phase 4")
    # the fuzz run's store is copied by now (it ran first, alongside)
    shrink_refs["cpu"] = submit(refs, shrink, "cpu",
                                shrink_refs["fuzz run"].result()[0]["cpu"],
                                forensics)
    # 250 ticks (the fleet's fault windows fire in every lane before the
    # heal at tick 125): cut from 1,000 to keep the script inside its limit
    short = dict(opts, time_limit=min(0.25, opts["time_limit"]))
    bare, bare_launches = run_path(dev, flagship, short, "phase 5 (bare)")
    fuzzed, fuzz_launches = run_path(dev, flagship,
                                     dict(short, fault_fuzz=ACTIVE_FUZZ),
                                     "phase 5 (active fault distribution)")
    idle = [k for k, v in fuzzed["fault-fuzz"].items()
            if k.endswith("-windows") and v == 0]
    if idle:
        raise AssertionError(f"phase 5: no window fired in {idle}")
    log(f"phase 5: ticks/s bare {bare['perf']['ticks-per-sec']:.2f}, "
        f"active fault distribution "
        f"{fuzzed['perf']['ticks-per-sec']:.2f}")
    mark("phase 5")
    bres, b_launches = run_path(dev, bmodel, bopts,
                                "phase 6 (broadcast, 25 nodes, tree4)")
    if bres["net"]["dropped-overflow"] != 0:
        raise AssertionError(f"phase 6: {bres['net']['dropped-overflow']} "
                             f"sends dropped for pool overflow")
    lost = [r.get("lost-count") for r in bres["instances"]]
    log(f"phase 6: broadcast fleet {bres['perf']['ticks-per-sec']:.2f} "
        f"ticks/s, {bres['perf']['msgs-per-sec']:.0f} simulated msgs/s, "
        f"lost-count per recorded instance {lost}")
    mark("phase 6")
    by_path = {
        "phase 4 flagship, BENCH_FUZZ_DIST": launches["deliver"],
        "phase 5 bare": bare_launches["deliver"],
        "phase 5 active fault distribution": fuzz_launches["deliver"],
        "phase 6 broadcast-25 tree4": b_launches["deliver"]}
    for w, (model, o) in paths.items():
        fres, f_launches = run_path(dev, model, o, f"phase 7 ({w})")
        log(f"phase 7: {w} dropped-overflow "
            f"{fres['net']['dropped-overflow']}")
        by_path[f"phase 7 {w}"] = f_launches["deliver"]
    mark("phase 7")
    for w, (model, o) in txn_paths.items():
        tres, t_launches = run_path(dev, model, o, f"phase 8 ({w})")
        inst = tres["instances"]
        counts = ([r.get("txn-count") for r in inst] if w.startswith("txn")
                  else [(r.get("send-count"), r.get("poll-count"))
                        for r in inst])
        kinds = sorted(set().union(*(r.get("anomaly-types") or []
                                     for r in inst)))
        check_s = tres["perf"]["phases"]["check"]["check-s"]
        log(f"phase 8: {w} check-s {check_s}, "
            f"{'txn-count' if w.startswith('txn') else '(send, poll) count'}"
            f" per recorded instance {counts}, anomaly types "
            f"{kinds or 'none'}, dropped-overflow "
            f"{tres['net']['dropped-overflow']}")
        if w.startswith("txn") and not any(counts):
            raise AssertionError(f"phase 8: {w} committed no txn in the "
                                 f"recorded instances")
        by_path[f"phase 8 {w}"] = t_launches["deliver"]
    mark("phase 8")
    hunt, h_launches = run_bug_hunt(dev, hunt_model, hunt_opts,
                                    "phase 9 (bug hunt)", root)
    mark("phase 9")
    for (label, _, _), (card, cpu) in zip(small_runs, small_refs):
        check_small_run_matches_cpu(dev, label, card.result(), cpu.result())
    if small_runs:
        mark("phase 3 (run alongside phases 4-9)")
    f_launches = run_forensics(dev, hunt, root, forensics, refs,
                               shrink_refs)
    mark("phase 10")
    by_path["phase 9 bug hunt (L=21), run and funnel replay"] = \
        h_launches["deliver"]
    by_path["phase 10 triage replay (L=21)"] = f_launches["triage"]
    by_path["phase 10 fuzz run (L=20)"] = f_launches["fuzz run"]
    by_path["phase 10 shrink replays (L=20)"] = f_launches["shrink"]
    by_path["phase 11 lanes, double-vote both mode"] = run_lanes_card_vs_cpu(
        dev, lanes_spec, lanes_opts, "double-vote, both mode", *lanes_refs)
    both, b_launches = run_sweep(dev, sweep_model, sweep_opts, "both")
    device, d_launches = run_sweep(dev, sweep_model, sweep_opts, "device")
    if not both["check"]["device-vs-farm"]["complete"]:
        raise AssertionError(f"phase 11 (sweep): audit {both['check']}")
    if [v["valid?"] for v in device["instances"]] != \
            [v["valid?"] for v in both["instances"]]:
        raise AssertionError("phase 11 (sweep): device mode's verdicts "
                             "differ from both mode's")
    flagged = both["check"]["flagged-instance-ids"]
    if flagged:
        log(f"phase 11 (sweep): the correct model raised flags in "
            f"{both['check']['flagged-instances']} instances; flag bits "
            f"of the first {len(flagged[:64])}: "
            f"{flag_bits(dev, sweep_model, sweep_opts, flagged[:64])}")
    log(f"phase 11 (sweep): the both-mode audit is complete and device "
        f"mode's {len(device['instances'])} per-instance verdicts equal "
        f"both mode's")
    by_path["phase 11 sweep, both mode"] = b_launches
    by_path["phase 11 sweep, device mode"] = d_launches
    mark("phase 11")
    camp, t_camp = campaign_refs[0].result()
    (card_npz, t_card), (cpu_npz, t_cpu) = (campaign_refs[1].result(),
                                            campaign_refs[2].result())
    label = "phase 12 (campaign)"
    log(f"{label}: {camp['cdir']}: the child `campaign run` was SIGKILLed "
        f"{camp['killed_after_s']:.1f} s after its start, at a checkpoint of "
        f"tick {camp['killed_at']}; `campaign resume` resumed the item "
        f"from tick {camp['resumed_from']} and finished it in "
        f"{camp['resume_s']:.1f} s: done, valid, resumed, attempts "
        f"{camp['attempts']}, one heartbeat seam, the end at "
        f"{camp['ticks']} ticks; results and {camp['histories']} "
        f"recorded history equal to the uninterrupted checkpointed run "
        f"({camp['ref_s']:.1f} s, alongside the child); net "
        f"{json.dumps(camp['net'])}; the side worker's phase 12 "
        f"{t_camp:.1f} s")
    log(f"{label}: state.npz {camp['npz_bytes']} B; checkpoint-s per "
        f"save: uninterrupted run {camp['ref_save_s']}, resumed segment "
        f"{camp['resume_save_s']}; restore-s {camp['restore_s']}")
    log(f"{label}: ticks/s: the checkpointed uninterrupted run "
        f"{camp['ref_tps']:.2f}, the killed and the resumed segments "
        f"{camp['segment_tps']} (heartbeat), phase 4's flagship "
        f"{res['perf']['ticks-per-sec']:.2f} (its own model, under "
        f"BENCH_FUZZ_DIST, not checkpointed)")
    n_arrays, header = same_npz(card_npz, cpu_npz,
                                "phase 12 (checkpoint, card vs CPU)")
    log(f"phase 12 (checkpoint, card vs CPU): the "
        f"{small_ckpt['n_instances']}-instance "
        f"{int(small_ckpt['time_limit'] * 1000)}-tick checkpointed "
        f"flagship's state.npz at tick {header['ticks']} ({n_arrays} "
        f"arrays) on {dev} ({t_card:.1f} s) equals the CPU's "
        f"({t_cpu:.1f} s) array by array, header included")
    by_path["phase 12 campaign resume, resumed suffix"] = \
        camp["resume_launches"]
    by_path["phase 12 uninterrupted checkpointed run"] = \
        camp["ref_launches"]
    mark("phase 12 (its card work in the side worker)")
    by_path.update(log_mesh_phase(dev, *mesh_refs))
    mark("phase 13 (its card work in a card worker of its own)")
    by_path.update(log_profile_phase(dev, profile_ref))
    mark("phase 14 (its card work behind phase 13, in its card worker)")
    record["launches"] = launches["deliver"]
    record["launches_by_path"] = by_path
    record["launches_not_counted"] = {
        "phase 12 campaign run child": "SIGKILLed mid-run: its launch "
        "count dies with the process; the resumed suffix and the "
        "uninterrupted run of the same item are counted",
        "phase 14 bench module": "a child process of its own; its "
        "launches are the ticks it runs"}
    # the journaled bug hunt's rows: its shape's launches on the path
    record["shapes"]["bug-hunt-netid"]["launches"] = (
        h_launches["deliver"] + f_launches["triage"])
    for name, r in record["shapes"].items():
        dev_txt = ("not measured" if r["device_ms"] is None
                   else f"{r['device_ms']:.6f} ms device time per launch "
                        f"({r['bound_share']:.1%} of the bound)")
        log(f"kernel deliver at {name}: {dev_txt}, bound "
            f"{r['bound_ms']:.6f} ms ({r['bound_by']}), wrapper "
            f"{r['wrapper_ms']:.6f} ms per call, plain version "
            f"{r['plain_ms']:.6f} ms, library call: none")
    log(f"kernel deliver: {record['launches']} launches on the main path, "
        f"by path {json.dumps(by_path)}")
    if rehearse:
        log("chip_smoke: CPU rehearsal passed (no card: no result line)")
        return 2
    from maelstrom_tpu_torch.kernels.devtime import card_line
    log(card_line())
    log(json.dumps({"kernels": [record]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
