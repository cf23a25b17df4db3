"""The flagship's simulated messages per second on the card.

    python -m maelstrom_tpu_torch.bench

The twin of ``bench.py``'s headline: the lin-kv flagship of
``bench.py:190-258`` (``fleets.FLAGSHIP`` and its model: 3 nodes, 6
clients, ``inbox_k`` 1, 16 pool slots, 5% loss, partitions every 0.4 s,
telemetry on, seed 7, 4,096 instances for 4 simulated seconds, under the
all-healthy fault distribution ``faults.BENCH_FUZZ_DIST``) on ``cuda``,
chunk by chunk with compacted events, as the chunked executor runs it.
A warm-up segment (two 32-tick chunks, after the delivery kernel is
built) sizes the timed chunks (the largest power of two up to 1,024
ticks that keeps one chunk under 8 s); the timed window runs the rest of
the horizon (a tail shorter than 32 ticks is dropped), each chunk's
counters read back once the next one is queued. Prints ``bench.py``'s
metric line as the last line: ``value`` is the messages delivered in
the timed window over its wall time, against the reference's 60,000
msgs/s. With the device profiler on (``auto``, as the harness runs it)
the line adds ``device_ms_per_tick`` and the per-phase split of the
captured chunks (``telemetry/profiler.py``).

Environment knobs, those of ``bench.py`` that mean something here:
``BENCH_INSTANCES`` (4096), ``BENCH_SIM_SECONDS`` (4.0),
``BENCH_TELEMETRY=0`` (no flight recorder), ``BENCH_FUZZ=0`` (no fault
distribution), ``BENCH_RECORD_INSTANCES`` (1), ``BENCH_CHECK_MODE``
(``farm``; ``device`` or ``both`` add the device verdict lanes to the
tick) and ``BENCH_DEVICE_PROFILE=0`` (no profiler). Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

BASELINE_MSGS_PER_SEC = 60_000.0
WARMUP_TICKS = 32
MAX_CHUNK_TICKS = 1024
DISPATCH_BUDGET_S = 8.0


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("maelstrom_tpu_torch.bench needs a CUDA card")
    from . import fleets, harness, pipeline, runtime
    from .faults.fuzz import BENCH_FUZZ_DIST
    from .kernels import build, delivery, devtime
    from .telemetry.profiler import DeviceProfiler

    n_instances = int(os.environ.get("BENCH_INSTANCES", 4096))
    sim_seconds = float(os.environ.get("BENCH_SIM_SECONDS", 4.0))
    bench_telemetry = os.environ.get("BENCH_TELEMETRY") != "0"
    bench_fuzz = os.environ.get("BENCH_FUZZ") != "0"
    bench_profile = os.environ.get("BENCH_DEVICE_PROFILE") != "0"
    check_mode = os.environ.get("BENCH_CHECK_MODE", "farm")
    model, opts = fleets.fleet("lin-kv")
    opts.update(n_instances=n_instances, time_limit=sim_seconds,
                record_instances=int(os.environ.get(
                    "BENCH_RECORD_INSTANCES", "1")),
                telemetry=bench_telemetry, check_mode=check_mode)
    if bench_fuzz:
        opts["fault_fuzz"] = BENCH_FUZZ_DIST
    sim = harness.make_sim_config(model, opts)
    dev = torch.device("cuda")
    log(devtime.card_line())

    t_b = time.monotonic()
    build.build_all([delivery.SOURCE])
    log(f"delivery kernel built in {time.monotonic() - t_b:.1f} s")
    ids = runtime.default_instance_ids(sim, dev)
    carry = runtime.init_carry(model, sim, int(opts["seed"]), dev, ids)
    tick = runtime.make_tick_fn(model, sim, ids, dev)
    R, V = sim.record_instances, model.ev_vals
    cap = pipeline.event_capacity(sim, model, MAX_CHUNK_TICKS)
    prof = (DeviceProfiler("auto", model=model, sim=sim, device=dev)
            if bench_profile else None)
    n_chunks = [0]

    def issue(c, t0: int, length: int):
        buf = pipeline.new_buffer(cap, V, dev) if R > 0 else None
        for t in range(t0, t0 + length):
            c, ys = tick(c, t)
            if buf is not None:
                buf = pipeline.compact_tick(buf, t, ys.events, V)
        return c, torch.stack(list(c.stats))

    def step(c, t0: int, length: int):
        """One chunk queued on the card: the carry and its counters'
        pending copy."""
        if prof is not None and prof.should_capture(n_chunks[0]):
            (c, svec), _ = prof.capture(issue, (c, t0, length), length,
                                        devices=[dev])
        else:
            c, svec = issue(c, t0, length)
        n_chunks[0] += 1
        return c, pipeline.start_fetch(svec)

    def counters(fetch):
        """(sent, delivered, dropped_overflow) after the chunk."""
        s = pipeline.finish_fetch(fetch)[0].numpy()
        return int(s[0]), int(s[1]), int(s[4])

    n_ticks = sim.n_ticks
    W = min(WARMUP_TICKS, n_ticks)
    with torch.no_grad():
        t0 = time.monotonic()
        carry, fetch = step(carry, 0, W)
        sent, delivered, ovf = counters(fetch)
        ticks = W
        log(f"warm-up chunk of {W} ticks in {time.monotonic() - t0:.2f} s")
        if ticks + W <= n_ticks:
            t1 = time.monotonic()
            carry, fetch = step(carry, ticks, W)
            sent, delivered, ovf = counters(fetch)
            per_tick = (time.monotonic() - t1) / W
            ticks += W
        else:
            per_tick = (time.monotonic() - t0) / W
        L = W
        while (L * 2 <= MAX_CHUNK_TICKS
               and L * 2 * per_tick <= DISPATCH_BUDGET_S
               and ticks + L * 2 <= n_ticks):
            L *= 2
        log(f"{per_tick * 1e3:.1f} ms/tick after the warm-up: {L}-tick "
            f"chunks")

        delivered0 = delivered
        t_start = time.monotonic()
        pending = None
        while ticks < n_ticks:
            rem = n_ticks - ticks
            use = L if rem >= L else (W if rem >= W else 0)
            if use == 0:
                break
            carry, fetch = step(carry, ticks, use)
            ticks += use
            if pending is not None:
                sent, delivered, ovf = counters(pending)
            pending = fetch
        if pending is not None:
            sent, delivered, ovf = counters(pending)
        wall = time.monotonic() - t_start

    delivered_timed = delivered - delivered0
    value = delivered_timed / wall if wall > 0 else 0.0
    rec = {
        "metric": "simulated_msgs_per_sec",
        "value": round(value, 1),
        "unit": "msgs/s",
        "vs_baseline": round(value / BASELINE_MSGS_PER_SEC, 3),
        "platform": "gpu",
        "engine": "torch",
        "layout": "lead",
        "config": "k1",
        "inbox_k": sim.net.inbox_k,
        "pool_slots": sim.net.pool_slots,
        "instances": n_instances,
        "sim_ticks": ticks,
        "delivered": delivered,
        "delivered_timed": delivered_timed,
        "sent": sent,
        "dropped_overflow": ovf,
        "wall_s": round(wall, 3),
        "msg_lanes": sim.net.lanes,
        "bytes_per_msg_row": 4 * sim.net.lanes,
        "fault_fuzz": bench_fuzz,
        **({"fuzz_phases": 2 * sim.faults.fuzz.windows_max}
           if bench_fuzz and sim.faults.has_fuzz else {}),
        "check_mode": check_mode,
        "telemetry": bench_telemetry,
        "device_profile": bench_profile,
    }
    if sim.check_summary:
        from .checkers import device_summary
        flagged = device_summary.flagged_mask(
            carry.violations.cpu().numpy(),
            carry.check_summary.cpu().numpy())
        rec["flagged_instances"] = int(np.sum(flagged))
    if prof is not None and prof.records:
        ds = prof.summary()
        rec["device_ms_per_tick"] = ds["ms-per-tick"]
        rec["device_phase_ms_per_tick"] = ds["per-phase-ms-per-tick"]
        rec["device_source"] = ds["source"]
        rec["device_chunks"] = ds["captured-chunks"]
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
