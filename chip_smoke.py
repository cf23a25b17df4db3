#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # needs a CUDA card and nvcc

Phases (any failure exits non-zero and prints no result line):

1. build every CUDA source of the port (one ``nvcc`` per source, all
   started together) and print nvcc's ``-Xptxas -v`` report;
2. hold each kernel against its plain PyTorch version on the card
   (tolerance: exact — all outputs are int32) at the Pallas test shape,
   the flagship shape (S=16, K=1) and the CLI-default shape (S=128,
   K=8), 4096 instances each, and on edge-case pools at small I
   (``kernels/delivery_cases.py``); at the flagship and default shapes
   time the kernel's device time per launch (CUPTI durations under
   ``torch.profiler``, L2 flushed before each launch, and warm), the
   wrapper's time per call (host issue included) and the plain version,
   beside the kernel's bound;
3. check on a small input (24 instances, 300 ticks) that the card's
   run equals the CPU run of the plain versions at every 25th tick, all
   carry leaves exact (the CPU path is the one held to the JAX
   reference by the tests): under an active four-lane fault
   distribution, then under an active fleet-shared fault plan with
   crash, links, skew and membership;
4. drive the main path — ``run_torch_test`` on lin-kv Raft exactly as
   ``bench.py`` runs its flagship: 3 nodes, 6 clients, 4096 instances,
   4 simulated seconds, under the all-healthy fault distribution
   ``BENCH_FUZZ_DIST`` — with every launch counter set to 0 just before
   and read just after; every kernel of the path must have launched,
   the delivery kernel once per tick, the verdict must be valid, and
   the network counters must equal the bare run's (the distribution
   is value-neutral);
5. drive the same fleet for 1,000 ticks bare and then under an active
   four-lane fault distribution (counters reset before and read after
   each): both valid, the delivery kernel once per tick, and the
   fuzzed fleet's drawn windows fired in every lane.

Before the last line it prints the card's name and power limit and one
JSON object with every kernel's launches, error, times and bound (``ms``
is the device time at the flagship shape; ``shapes`` holds each timed
shape's ``device_ms``, ``wrapper_ms``, ``plain_ms``, ``bound_ms`` and
``bound_share``; ``timing`` states the method); the last line is
``{"ok": true, "device": {...}}``.

``--rehearse-on-cpu`` runs phases 2, 4 and 5 at a tiny size with the
plain versions (no card, no nvcc) to check the script's own logic; it
exits 2 and prints no result line. ``--time-limit S`` runs the main
path for ``S`` simulated seconds instead and phase 5 for at most ``S``
(a quicker check).
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

# bench.py's flagship lin-kv options; the main path adds its fault
# distribution (faults.fuzz.BENCH_FUZZ_DIST)
MAIN_OPTS = dict(node_count=3, concurrency=6, n_instances=4096,
                 record_instances=1, time_limit=4.0, rate=200.0,
                 latency=5.0, rpc_timeout=1.0, nemesis=["partition"],
                 nemesis_interval=0.4, p_loss=0.05, recovery_time=0.3,
                 seed=7, telemetry=True, inbox_k=1, pool_slots=16,
                 layout="lead")
MODEL_KW = dict(n_nodes_hint=3, log_cap=64, heartbeat=8)
# the bare flagship's network counters at full width and depth (NVIDIA
# H100 80GB HBM3; PERF.md): the all-healthy distribution keeps them
FLAGSHIP_NET = {"sent": 9708913, "delivered": 7537375,
                "dropped-partition": 1675883, "dropped-loss": 484098,
                "dropped-overflow": 0}
# an active distribution over all four lanes
ACTIVE_FUZZ = {"windows": [2, 3], "gap": [40, 200], "duration": [30, 100],
               "crash": {"rate": 0.7, "victims": [1, 1]},
               "links": {"rate": 0.6, "edges": [1, 3], "block": 0.5,
                         "delay": [0, 20], "loss": [0.0, 0.3]},
               "skew": {"rate": 0.5, "victims": [1, 2],
                        "range": [0.5, 2.0]},
               "membership": {"rate": 0.5, "victims": [1, 1]}}
# an active fleet-shared plan over all four lanes (phase 3's 300 ticks)
ACTIVE_PLAN = {"phases": [
    {"until": 40, "members": [0, 1, 2]},
    {"until": 80, "crash": [0], "skew": {"1": 2.0, "2": 0.75}},
    {"until": 120, "links": [{"dst": 1, "src": 0, "block": True},
                             {"dst": 0, "src": 1, "delay": 7},
                             {"dst": 0, "src": 2, "loss": 0.4}]},
    {"until": 170, "remove": [1]},
    {"until": 200, "add": [1], "crash": [2]}]}


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


def check_small_run_matches_cpu(dev, label, faults):
    """The card's tick loop equals the CPU plain-version loop on a small
    input: every carry leaf at every 25th tick."""
    from maelstrom_tpu_torch import convert, harness, runtime
    from maelstrom_tpu_torch.models.raft import RaftModel
    model = RaftModel(**MODEL_KW)
    opts = dict(MAIN_OPTS, n_instances=24, time_limit=0.3,
                nemesis_interval=0.1, recovery_time=0.05, **faults)
    sim = harness.make_sim_config(model, opts)
    carries = []
    for d in (torch.device("cpu"), dev):
        carry = runtime.init_carry(model, sim, opts["seed"], d)
        tick = runtime.make_tick_fn(model, sim, device=d)
        seq = []
        with torch.no_grad():
            for t in range(sim.n_ticks):
                carry, _ = tick(carry, t)
                if t % 25 == 24:
                    seq.append(convert.carry_to_numpy(carry))
        carries.append(seq)
    names = None
    for k, (a, b) in enumerate(zip(*carries)):
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
    fault_leaves = sorted({n.split(".")[1] for n in names} - {
        "pool", "node_state", "client_state", "stats", "violations", "key",
        "telemetry"})
    log(f"phase 3: {sim.n_instances}-instance {sim.n_ticks}-tick run on "
        f"{dev} under {label} equals the CPU plain-version run at every "
        f"25th tick (all {len(names)} carry leaves, exact; fault leaves "
        f"{', '.join(fault_leaves)})")


def run_path(dev, opts, label):
    """``run_torch_test`` on one path, every launch counter set to 0
    just before and read just after: a valid verdict and the delivery
    kernel once per tick on the card."""
    from maelstrom_tpu_torch import harness
    from maelstrom_tpu_torch.kernels import delivery
    from maelstrom_tpu_torch.models.raft import RaftModel
    delivery.deliver.launches = 0
    t0 = time.monotonic()
    res = harness.run_torch_test(RaftModel(**MODEL_KW), opts,
                                 device=str(dev))
    wall = time.monotonic() - t0
    launches = {"deliver": delivery.deliver.launches}
    ticks = res["perf"]["ticks"]
    log(f"{label}: lin-kv x{res['instance-count']} for {ticks} ticks: "
        f"valid?={res['valid?']} wall {wall:.1f} s, "
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


def main(argv) -> int:
    start = time.monotonic()
    mark = lambda phase: log(f"{phase} finished {time.monotonic() - start:.1f}"
                             f" s into the script")
    rehearse = "--rehearse-on-cpu" in argv
    if not rehearse and not torch.cuda.is_available():
        log("chip_smoke: no CUDA card (torch.cuda.is_available() is "
            "False); nothing run")
        return 1
    import maelstrom_tpu_torch  # noqa: F401 — fails outside the repo
    from maelstrom_tpu_torch.faults import BENCH_FUZZ_DIST
    from maelstrom_tpu_torch.kernels import delivery_cases
    dev = torch.device("cpu" if rehearse else "cuda")
    shapes = dict(delivery_cases.SHAPES)
    opts = dict(MAIN_OPTS)
    if rehearse:
        shapes = {name: shape[:5] + (min(shape[5], 64),)
                  for name, shape in shapes.items()}
        opts.update(n_instances=16, time_limit=0.3, nemesis_interval=0.1,
                    recovery_time=0.05)
    full = opts == MAIN_OPTS and "--time-limit" not in argv
    if "--time-limit" in argv:
        opts["time_limit"] = float(argv[argv.index("--time-limit") + 1])
    else:
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
    if not rehearse:
        check_small_run_matches_cpu(dev, "an active four-lane fault "
                                    "distribution",
                                    dict(fault_fuzz=ACTIVE_FUZZ))
        check_small_run_matches_cpu(dev, "an active fault plan (crash, "
                                    "links, skew, membership)",
                                    dict(fault_plan=ACTIVE_PLAN))
        mark("phase 3")
    res, launches = run_path(dev, dict(opts, fault_fuzz=BENCH_FUZZ_DIST),
                             "phase 4 (flagship, BENCH_FUZZ_DIST)")
    if full and res["net"] != FLAGSHIP_NET:
        raise AssertionError(f"phase 4 network counters {res['net']} "
                             f"differ from the bare flagship's "
                             f"{FLAGSHIP_NET}")
    if full:
        log("phase 4: network counters equal the bare flagship run's "
            "exactly")
    mark("phase 4")
    short = dict(opts, time_limit=min(1.0, opts["time_limit"]))
    bare, bare_launches = run_path(dev, short, "phase 5 (bare)")
    fuzzed, fuzz_launches = run_path(dev, dict(short,
                                               fault_fuzz=ACTIVE_FUZZ),
                                     "phase 5 (active fault distribution)")
    idle = [k for k, v in fuzzed["fault-fuzz"].items()
            if k.endswith("-windows") and v == 0]
    if idle:
        raise AssertionError(f"phase 5: no window fired in {idle}")
    log(f"phase 5: ticks/s bare {bare['perf']['ticks-per-sec']:.2f}, "
        f"active fault distribution "
        f"{fuzzed['perf']['ticks-per-sec']:.2f}")
    mark("phase 5")
    record["launches"] = launches["deliver"]
    record["launches_by_path"] = {
        "phase 4 flagship, BENCH_FUZZ_DIST": launches["deliver"],
        "phase 5 bare": bare_launches["deliver"],
        "phase 5 active fault distribution": fuzz_launches["deliver"]}
    for name, r in record["shapes"].items():
        dev_txt = ("not measured" if r["device_ms"] is None
                   else f"{r['device_ms']:.6f} ms device time per launch "
                        f"({r['bound_share']:.1%} of the bound)")
        log(f"kernel deliver at {name}: {dev_txt}, bound "
            f"{r['bound_ms']:.6f} ms ({r['bound_by']}), wrapper "
            f"{r['wrapper_ms']:.6f} ms per call, plain version "
            f"{r['plain_ms']:.6f} ms, library call: none")
    log(f"kernel deliver: {record['launches']} launches on the main path")
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
