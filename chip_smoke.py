#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # needs a CUDA card and nvcc

Phases (any failure exits non-zero and prints no result line):

1. build every CUDA source of the port (one ``nvcc`` per source, all
   started together) and print nvcc's ``-Xptxas -v`` report;
2. hold each kernel against its plain PyTorch version on the card at the
   shapes of the main path (tolerance: exact — all outputs are int32)
   and time both with CUDA events;
3. check on a small input that the card's run equals the CPU run of the
   plain versions, tick for tick (the CPU path is the one held to the
   JAX reference by the tests);
4. drive the main path — ``run_torch_test`` on lin-kv Raft at the
   flagship width (3 nodes, 6 clients, 4096 instances, 4 simulated
   seconds) — with every launch counter set to 0 just before and read
   just after; every kernel of the path must have launched, the
   delivery kernel once per tick, and the verdict must be valid.

Before the last line it prints the card's name and power limit and one
JSON object with every kernel's launches, error, times and bound; the
last line is ``{"ok": true, "device": {...}}``.

``--rehearse-on-cpu`` runs phases 2-4 at a tiny size with the plain
versions (no card, no nvcc) to check the script's own logic; it exits 2
and prints no result line. ``--time-limit S`` runs the main path for
``S`` simulated seconds instead (a quicker check).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# the card's peak rates (NVIDIA's H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12   # non-tensor-core 32-bit rate (FP32 figure)

# the main path: bench.py's flagship lin-kv options (without the fault
# fuzz distribution, whose all-healthy draw leaves the trajectory as is)
MAIN_OPTS = dict(node_count=3, concurrency=6, n_instances=4096,
                 record_instances=1, time_limit=4.0, rate=200.0,
                 latency=5.0, rpc_timeout=1.0, nemesis=["partition"],
                 nemesis_interval=0.4, p_loss=0.05, recovery_time=0.3,
                 seed=7, telemetry=True, inbox_k=1, pool_slots=16,
                 layout="lead")
MODEL_KW = dict(n_nodes_hint=3, log_cap=64, heartbeat=8)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, sync) -> float:
    """Mean wall time of ``fn`` over ``iters`` runs after a warm-up:
    CUDA events on the card, the host clock on the CPU."""
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


def deliver_bound(I, S, L, NT, K):
    """(bound_ms, bound_by, bytes, ops) of one delivery round: each input
    read once (pool, partition plane), each output written once (pool',
    inbox, two counts); about six integer ops per (endpoint, slot, k)
    scan step."""
    nbytes = 2 * I * S * L * 4 + I * NT * K * L * 4 + I * NT * NT \
        + 2 * I * 4
    ops = 6 * I * NT * S * K
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def check_delivery(dev, shapes, timed_shape):
    """Kernel vs plain version at each shape; returns the timed record."""
    from maelstrom_tpu_torch import netsim, wire
    from maelstrom_tpu_torch.kernels import delivery
    record = None
    for name, (n, c, S, K, body, I) in shapes.items():
        cfg = netsim.NetConfig(n_nodes=n, n_clients=c, pool_slots=S,
                               inbox_k=K, body_lanes=body, latency_mean=5.0,
                               latency_dist=2, p_loss=0.0)
        L, NT = cfg.lanes, cfg.n_total
        rs = np.random.RandomState(5)
        pools = np.zeros((I, S, L), np.int32)
        occ = rs.random_sample((I, S)) < 0.6
        pools[..., wire.VALID] = occ
        for lane, hi in ((wire.SRC, NT), (wire.DEST, NT),
                         (wire.ORIGIN, NT), (wire.DTICK, 30),
                         (wire.TYPE, 14)):
            pools[..., lane] = rs.randint(0, hi, (I, S)) * occ
        pools[..., wire.BODY:] = rs.randint(0, 100, (I, S, L - wire.BODY)) \
            * occ[..., None]
        parts = rs.random_sample((I, NT, NT)) < 0.25
        pool = torch.from_numpy(pools).to(dev)
        part = torch.from_numpy(parts).to(dev)
        t = 15
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
                                 f"{name}: max abs err {err}")
        log(f"phase 2: deliver {name} I={I} S={S} K={K} NT={NT} L={L}: "
            f"bit-equal to deliver_reference (tolerance 0)")
        if name != timed_shape:
            continue
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: 0)
        iters = 200 if dev.type == "cuda" else 5
        ms = time_ms(lambda: delivery.deliver(pool, part, t, cfg), iters,
                     sync)
        plain_ms = time_ms(
            lambda: netsim.deliver_reference(pool, part, t, cfg),
            max(1, iters // 4), sync)
        bound_ms, bound_by, nbytes, ops = deliver_bound(I, S, L, NT, K)
        log(f"phase 2: deliver {name}: kernel {ms:.6f} ms, plain version "
            f"{plain_ms:.6f} ms, bound {bound_ms:.6f} ms ({bound_by}: "
            f"{nbytes} B, {ops} int ops), library call: none")
        record = {"name": "deliver", "route": "cuda",
                  "source": "maelstrom_tpu_torch/csrc/deliver.cu",
                  "replaces": "maelstrom_tpu/ops/delivery.py:51",
                  "launches": None, "max_abs_err": err, "ms": ms,
                  "plain_ms": plain_ms, "bound_ms": bound_ms,
                  "bound_by": bound_by, "library_ms": None}
    # the timed launches above were comparisons, not the main path
    delivery.deliver.launches = 0
    return record


def check_small_run_matches_cpu(dev):
    """The card's tick loop equals the CPU plain-version loop on a small
    input: every carry leaf at every 25th tick."""
    from maelstrom_tpu_torch import convert, harness, runtime
    from maelstrom_tpu_torch.models.raft import RaftModel
    model = RaftModel(**MODEL_KW)
    opts = dict(MAIN_OPTS, n_instances=24, time_limit=0.3,
                nemesis_interval=0.1, recovery_time=0.05)
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
    for k, (a, b) in enumerate(zip(*carries)):
        for name, x, y in _leaves(a, b):
            if not np.array_equal(x, y):
                raise AssertionError(f"{dev} run differs from the CPU run "
                                     f"at tick {25 * k + 24}: {name}")
    log(f"phase 3: {sim.n_instances}-instance {sim.n_ticks}-tick run on "
        f"{dev} equals the CPU plain-version run at every 25th tick "
        f"(all carry leaves, exact)")


def _leaves(a, b, prefix="carry"):
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        for f in a._fields:
            yield from _leaves(getattr(a, f), getattr(b, f), f"{prefix}.{f}")
    elif a is not None:
        yield prefix, np.asarray(a), np.asarray(b)


def run_main_path(dev, opts):
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
    log(f"phase 4: lin-kv x{res['instance-count']} for {ticks} ticks: "
        f"valid?={res['valid?']} wall {wall:.1f} s, "
        f"{res['perf']['ticks-per-sec']:.2f} ticks/s, "
        f"{res['perf']['msgs-per-sec']:.0f} simulated msgs/s, "
        f"net {json.dumps(res['net'])}, launches {launches}")
    if res["valid?"] is not True:
        raise AssertionError(f"main path verdict {res['valid?']!r}")
    if launches["deliver"] != ticks and dev.type == "cuda":
        raise AssertionError(f"delivery kernel launched "
                             f"{launches['deliver']} times for {ticks} "
                             f"ticks")
    if res["net"]["delivered"] <= 0 or res["checked-instances"] < 1:
        raise AssertionError("main path delivered nothing")
    return res, launches


def main(argv) -> int:
    rehearse = "--rehearse-on-cpu" in argv
    if not rehearse and not torch.cuda.is_available():
        log("chip_smoke: no CUDA card (torch.cuda.is_available() is "
            "False); nothing run")
        return 1
    import maelstrom_tpu_torch  # noqa: F401 — fails outside the repo
    dev = torch.device("cpu" if rehearse else "cuda")
    shapes = {"pallas-test": (3, 3, 32, 4, 6, 8),
              "flagship": (3, 6, 16, 1, 12, 4096)}
    opts = dict(MAIN_OPTS)
    if rehearse:
        shapes = {"pallas-test": (3, 3, 32, 4, 6, 8),
                  "flagship": (3, 6, 16, 1, 12, 64)}
        opts.update(n_instances=16, time_limit=0.3, nemesis_interval=0.1,
                    recovery_time=0.05)
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

    record = check_delivery(dev, shapes, "flagship")
    if not rehearse:
        check_small_run_matches_cpu(dev)
    res, launches = run_main_path(dev, opts)
    record["launches"] = launches["deliver"]
    for k in ("ms", "plain_ms", "bound_ms"):
        record[k] = float(record[k])
    log(f"kernel deliver: {record['ms']:.6f} ms per launch (bound "
        f"{record['bound_ms']:.6f} ms, {record['bound_by']}), plain version "
        f"{record['plain_ms']:.6f} ms, library call: none, "
        f"{record['launches']} launches on the main path")
    if rehearse:
        log("chip_smoke: CPU rehearsal passed (no card: no result line)")
        return 2
    log(card_line())
    log(json.dumps({"kernels": [record]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
