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
captured chunks (``telemetry/profiler.py``). After the timed window it
adds the static fields of ``bench.py``'s line, from a trace of the same
sim's tick on ``meta`` tensors (``analysis/cost_model.py``): ``ir_eqns``
(operators per tick of the heaviest tick variant), ``ir_bytes_est``
(their output bytes), ``lanes_live``, ``lanes_dead`` and
``lanes_dead_bytes`` (``analysis/lane_liveness.py``), and
``ovf_margin_bits`` (``analysis/absint.py``: the minimum proven counter
headroom, in bits to int32 max, of this sim's tick at the production
horizon or the proven one if shorter; 0 = unproven), and
``collectives_per_tick`` and ``ici_bytes_est`` (``analysis/
shard_audit.py``: the collectives in a shard's tick and the bytes one
shard would move per tick at 8 shards); a failure logs and leaves its
fields ``null``. The chunks go through the certified store of the kernel
libraries (``aot_store.py``, ``--aot-store DIR|auto|off``, default
``auto``): the line carries ``aot`` (the store's outcome, or ``false``
when it is off), ``aot_load_s`` and ``first_dispatch_s``, the wall from
the start of the store's work (or the kernel's build) to the warm-up
chunk's counters on the host.

Environment knobs, those of ``bench.py`` that mean something here:
``BENCH_INSTANCES`` (4096), ``BENCH_SIM_SECONDS`` (4.0),
``BENCH_TELEMETRY=0`` (no flight recorder), ``BENCH_FUZZ=0`` (no fault
distribution), ``BENCH_RECORD_INSTANCES`` (1), ``BENCH_CHECK_MODE``
(``farm``; ``device`` or ``both`` add the device verdict lanes to the
tick), ``BENCH_DEVICE_PROFILE=0`` (no profiler), ``BENCH_LANES=0`` (no
lane fields) and ``BENCH_RANGES=0`` (no ``ovf_margin_bits``) and ``BENCH_SHARD=0`` (no
shard fields); ``MAELSTROM_AOT=0`` or ``--aot-store off`` turns the store
off. Needs a CUDA card.
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


def static_fields(model, sim) -> dict:
    """The bench line's static fields, from a trace of ``sim``'s tick on
    ``meta`` tensors: the cost model's (``ir_eqns``, ``ir_bytes_est``)
    unless ``BENCH_LANES=0`` the lane pass's (``lanes_live``,
    ``lanes_dead``, ``lanes_dead_bytes``), and unless ``BENCH_RANGES=0``
    the ranges pass's ``ovf_margin_bits``. A failure logs and leaves its
    fields ``None``: it never stops the bench."""
    out = dict(ir_eqns=None, ir_bytes_est=None, lanes_live=None,
               lanes_dead=None, lanes_dead_bytes=None,
               ovf_margin_bits=None, collectives_per_tick=None,
               ici_bytes_est=None)
    from .analysis import cost_model
    cache: dict = {}
    cost = None
    t0 = time.monotonic()
    try:
        cost = cost_model.tick_cost(model, sim, cache=cache)
        out.update(ir_eqns=cost.eqns, ir_bytes_est=cost.hbm_bytes)
        log(f"static tick: {cost.eqns} operators ({cost.variant} tick; "
            f"{cost.variants}), ~{cost.hbm_bytes / 1e6:.1f} MB of outputs "
            f"per tick, traced in {time.monotonic() - t0:.1f} s")
    except Exception as e:
        log(f"tick_cost unavailable: {e!r}")
    if os.environ.get("BENCH_LANES") != "0":
        try:
            out.update(cost_model.tick_lane_stats(model, sim, cost=cost,
                                                  cache=cache))
            log(f"lane liveness: {out['lanes_live']} live / "
                f"{out['lanes_dead']} dead lanes, "
                f"~{out['lanes_dead_bytes'] / 1e3:.0f} kB/tick dead")
        except Exception as e:
            log(f"tick_lane_stats unavailable: {e!r}")
    if os.environ.get("BENCH_RANGES") != "0":
        t0 = time.monotonic()
        try:
            out.update(cost_model.tick_range_stats(model, sim, cache=cache))
            log(f"value ranges: {out['ovf_margin_bits']} bit(s) of proven "
                f"counter headroom at the production horizon "
                f"({time.monotonic() - t0:.1f} s)")
        except Exception as e:
            log(f"tick_range_stats unavailable: {e!r}")
    if os.environ.get("BENCH_SHARD") != "0":
        try:
            out.update(cost_model.tick_shard_stats(model, sim, 8,
                                                   cache=cache))
            log(f"shard comms: {out['collectives_per_tick']} collective(s) "
                f"in a shard's tick, ~{out['ici_bytes_est']} B/tick at 8 "
                f"shards")
        except Exception as e:
            log(f"shard_stats unavailable: {e!r}")
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="python -m maelstrom_tpu_torch.bench")
    ap.add_argument("--aot-store", default="auto",
                    help="the kernel-library store: a directory, auto "
                         "(build/aot) or off")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("maelstrom_tpu_torch.bench needs a CUDA card")
    from . import fleets, harness, pipeline, runtime
    from .aot_store import finalize_record, resolve_store_dir, wrap_pipelined
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

    store_dir = resolve_store_dir(args.aot_store)
    t_first = time.monotonic()
    if store_dir is None:
        build.build_all([delivery.SOURCE])
        log(f"delivery kernel built in {time.monotonic() - t_first:.1f} s")
    ids = runtime.default_instance_ids(sim, dev)
    carry = runtime.init_carry(model, sim, int(opts["seed"]), dev, ids)
    tick = runtime.make_tick_fn(model, sim, ids, dev)
    R, V = sim.record_instances, model.ev_vals
    cap = pipeline.event_capacity(sim, model, MAX_CHUNK_TICKS)
    prof = (DeviceProfiler("auto", model=model, sim=sim, device=dev)
            if bench_profile else None)
    n_chunks = [0]

    def issue(c, t0: int, length: int):
        # the chunked executor's dispatch, the fleet's counters copied
        return pipeline.issue_chunk(
            tick, c, t0, length, cap=cap, V=V, R=R,
            J=sim.journal_instances, instance_ids=ids,
            scan_k=pipeline.DEFAULT_SCAN_TOP_K, with_stats=True,
            device=dev)

    # the store resolves each chunk length before its first chunk: a hit
    # loads the delivery library, a miss builds it into the store
    wrapped, aot_rec = wrap_pipelined(
        issue, model=model, sim=sim, instance_ids=ids, cap=cap,
        scan_k=pipeline.DEFAULT_SCAN_TOP_K, stats=True, device=dev,
        store_dir=store_dir)
    if wrapped is not None:
        issue = wrapped

    def step(c, t0: int, length: int):
        """One chunk queued on the card: the carry and its counters'
        pending copy."""
        if prof is not None and prof.should_capture(n_chunks[0]):
            (c, out), _ = prof.capture(issue, (c, t0, length), length,
                                       devices=[dev])
        else:
            c, out = issue(c, t0, length)
        n_chunks[0] += 1
        return c, pipeline.start_fetch(out[-2])

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
        first_dispatch_s = time.monotonic() - t_first
        log(f"warm-up chunk of {W} ticks in {time.monotonic() - t0:.2f} s; "
            f"{first_dispatch_s:.2f} s from the start of the store's work "
            f"(or the build) to its counters")
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
    static = static_fields(model, sim)
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
        **static,
        "first_dispatch_s": round(first_dispatch_s, 3),
        "aot": (False if aot_rec is None else {
            "hit": aot_rec["hit"], "fingerprint": aot_rec["fingerprint"],
            "lengths": dict(aot_rec["lengths"]),
            **({"error": aot_rec["error"]} if "error" in aot_rec else {})}),
    }
    if aot_rec is not None:
        finalize_record(aot_rec)
        rec["aot_load_s"] = aot_rec["load-s"]
        log(f"aot store: {json.dumps(aot_rec)}")
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
