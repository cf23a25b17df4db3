"""Host-side harness of the port: configure, run, decode, check.

Counterpart of ``maelstrom_tpu/tpu/harness.py`` for the lin-kv slice:
:func:`run_torch_test` builds a :class:`SimConfig` from CLI-style opts,
runs the fleet (chunked with event compaction, or in one loop), decodes
the recorded instances' events into histories, checks every recorded
instance, and writes ``results.json`` + ``history-<i>.jsonl`` into the
store. The virtual clock is 1 tick = ``ms_per_tick`` simulated ms.

Runs go to the card (``device="cuda"``) unless the caller asks for the
CPU; with no card and no CPU request they raise — a measurement path
never falls back to the CPU.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .checkers import checker_failure, compose_valid
from .decode import LazyHistories, decode_compact_rows, decode_dense
from .faults import (FAULT_KINDS, compile_fault_fuzz, compile_fault_plan,
                     generate_fault_plan)
from .faults import fuzz as faults_fuzz
from .faults.engine import plan_summary
from .netsim import LATENCY_DISTS, NetConfig
from .runtime import (ClientConfig, Model, NEMESIS_KINDS, NemesisConfig,
                      SimConfig, run_sim)
from .telemetry.recorder import TelemetryConfig

MS_PER_TICK = 1

# the JAX harness's TPU_DEFAULTS, for every field this port implements
TORCH_DEFAULTS = dict(
    node_count=1,
    concurrency=2,           # clients per instance
    rate=100.0,              # ops/sec per instance
    time_limit=2.0,          # simulated seconds
    latency=10.0,            # mean inter-node latency, ms (= ticks)
    latency_dist="exponential",
    p_loss=0.0,
    nemesis=[],
    nemesis_interval=0.5,    # simulated seconds between phase flips
    rpc_timeout=1.0,         # simulated seconds
    recovery_time=0.5,       # final heal + quiesce window (simulated s)
    n_instances=64,
    record_instances=8,
    pool_slots=128,
    inbox_k=8,
    ms_per_tick=MS_PER_TICK,
    layout="lead",           # the port implements the batch-leading layout
    telemetry=True,
    telemetry_stride=0,      # 0 = auto (<= 256 windows)
    telemetry_hist_buckets=16,
    pipeline="auto",         # chunked executor when the horizon spans
                             # several chunks
    chunk_ticks=100,
    event_capacity=0,        # 0 = auto from the client rate
    scan_top_k=8,
    nemesis_kind="random-halves",
    nemesis_schedule=(),     # kind="scripted": ((until_tick, ((dst, src),
                             # ...)), ...)
    fault_plan=None,         # fault-plan dict (faults/spec.py)
    fault_fuzz=None,         # fault distribution dict (faults/fuzz.py)
    fault_snapshot_every=None,  # slab stride; None = the plan's own
    seed=0,
)

# run-lifecycle options of the JAX harness that change neither the
# trajectory nor the verdict: accepted and not used
LIFECYCLE_OPTS = ("heartbeat", "device_profile", "aot_store",
                  "check_workers", "compile_cache")
# JAX-harness options the port implements only at their neutral value
NEUTRAL_OPTS = {"journal_instances": (0, None), "netid": (None, False),
                "check_mode": ("farm", None)}
# model-selection flags (models.get_model builds the model from them; the
# harness holds the model to them) and the Elle checker's model names
MODEL_OPTS = ("crash_clients", "txn_dirty_apply", "consistency_models")
KNOWN_OPTS = (set(TORCH_DEFAULTS) | set(LIFECYCLE_OPTS) | set(NEUTRAL_OPTS)
              | set(MODEL_OPTS) | {"store_root", "device"})


def resolve_device(device: Optional[str]) -> torch.device:
    """``cuda`` unless the caller names another device; a CUDA request
    on a machine without a card raises instead of running on the CPU."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "maelstrom_tpu_torch runs on a CUDA card and none is "
            "available; pass device='cpu' (--device cpu) to run the "
            "plain PyTorch versions on the CPU")
    return dev


def make_sim_config(model: Model, opts: Dict[str, Any]) -> SimConfig:
    """The static run configuration from CLI-style options. An option
    the port does not implement raises, naming it: nothing is dropped
    silently."""
    unknown = sorted(set(opts) - KNOWN_OPTS)
    if unknown:
        raise ValueError(f"option(s) {', '.join(unknown)} not implemented "
                         f"by maelstrom_tpu_torch")
    for k, neutral in NEUTRAL_OPTS.items():
        if opts.get(k) not in neutral:
            raise ValueError(f"option {k}={opts[k]!r} is not implemented "
                             f"by maelstrom_tpu_torch (only "
                             f"{' or '.join(map(repr, neutral))})")
    _check_model_opts(model, opts)
    o = {**TORCH_DEFAULTS, **opts}
    if o.get("layout", "lead") not in ("lead", "auto"):
        raise ValueError("maelstrom_tpu_torch implements the batch-leading "
                         "carry layout only (layout='lead')")
    mpt = o["ms_per_tick"]
    n_ticks = int(o["time_limit"] * 1000 / mpt)
    # the delivery priority encodes the deadline as ((1 << 20) - dtick) * S
    if n_ticks >= (1 << 20):
        raise ValueError(
            f"time_limit {o['time_limit']}s at {mpt} ms/tick needs "
            f"{n_ticks} ticks, past the 2^20-tick delivery horizon; "
            f"raise ms_per_tick")
    net = NetConfig(
        n_nodes=o["node_count"], n_clients=o["concurrency"],
        pool_slots=o["pool_slots"], inbox_k=o["inbox_k"],
        body_lanes=model.body_lanes,
        latency_mean=float(o["latency"]) / mpt,
        latency_dist=LATENCY_DISTS[o["latency_dist"]],
        p_loss=float(o["p_loss"]))
    model.validate_config(net)
    # final window: partitions stop at stop_tick, clients keep the main
    # mix through half the window, then switch to final reads
    recovery_ticks = min(int(o["recovery_time"] * 1000 / mpt), n_ticks // 2)
    stop_tick = n_ticks - recovery_ticks
    client = ClientConfig(
        n_clients=o["concurrency"],
        rate=min(1.0, float(o["rate"]) / o["concurrency"] / 1000.0 * mpt),
        timeout_ticks=int(o["rpc_timeout"] * 1000 / mpt),
        final_start=stop_tick + recovery_ticks // 2)
    kind = o["nemesis_kind"]
    if kind not in NEMESIS_KINDS:
        raise ValueError(f"nemesis kind {kind!r} is not ported "
                         f"(ported: {', '.join(NEMESIS_KINDS)})")
    unknown = [k for k in (o["nemesis"] or [])
               if k != "partition" and k not in FAULT_KINDS]
    if unknown:
        raise ValueError(f"nemesis {', '.join(unknown)} is not ported "
                         f"(ported: partition, {', '.join(FAULT_KINDS)})")
    interval = max(1, int(o["nemesis_interval"] * 1000 / mpt))
    nemesis = NemesisConfig(
        enabled="partition" in (o["nemesis"] or []),
        interval=interval, kind=kind, stop_tick=stop_tick,
        schedule=tuple(sorted(
            ((int(until), tuple((int(d), int(s)) for d, s in pairs))
             for until, pairs in o["nemesis_schedule"]),
            key=lambda p: p[0])))
    faults = _fault_config(o, n_ticks, interval, stop_tick)
    stride = int(o.get("telemetry_stride") or 0)
    if stride <= 0:
        stride = max(1, -(-n_ticks // 256))
    telemetry = TelemetryConfig(
        enabled=bool(o.get("telemetry", True)),
        hist_buckets=min(max(int(o.get("telemetry_hist_buckets", 16)), 1),
                         31),
        stride=stride, n_windows=max(1, -(-n_ticks // stride)))
    return SimConfig(net=net, client=client, nemesis=nemesis,
                     n_instances=o["n_instances"], n_ticks=n_ticks,
                     record_instances=min(o["record_instances"],
                                          o["n_instances"]),
                     telemetry=telemetry, faults=faults)


def _check_model_opts(model: Model, opts: Dict[str, Any]) -> None:
    """The model-selection flags must describe ``model``: a flag the
    model was not built with raises instead of being dropped."""
    if opts.get("crash_clients") and not getattr(model, "crash_clients",
                                                 False):
        raise ValueError(
            f"crash_clients is a kafka option and {model.name} was not "
            f"built with it (models.get_model(..., opts={{'crash_clients'"
            f": True}}) builds a kafka model that crashes its clients)")
    if opts.get("txn_dirty_apply") and not (
            model.name.startswith("txn-")
            and getattr(model, "apply_uncommitted", False)):
        raise ValueError(
            f"txn_dirty_apply selects the txn dirty-apply mutant and "
            f"{model.name} is not it (models.get_model(..., opts="
            f"{{'txn_dirty_apply': True}}) builds it)")


def _fault_config(o: Dict[str, Any], n_ticks: int, interval: int,
                  stop_tick: int):
    """The fault plan (an explicit ``fault_plan``, or the fault kinds in
    ``nemesis`` generated on the partition interval grid) or the fuzz
    distribution; both heal at ``stop_tick``. The JAX harness's rules:
    one schedule source per run, and requested fault kinds that make no
    fault are refused."""
    fault_kinds = [k for k in (o["nemesis"] or []) if k in FAULT_KINDS]
    plan = o["fault_plan"]
    dist = o["fault_fuzz"]
    if plan and fault_kinds:
        raise ValueError(
            f"--fault-plan and the generated fault nemesis kinds "
            f"({', '.join(fault_kinds)}) are mutually exclusive — put "
            f"the faults in the plan file")
    if dist and (plan or fault_kinds):
        raise ValueError(
            "--fault-fuzz (per-instance randomized schedules) is "
            "mutually exclusive with --fault-plan and the generated "
            "fault nemesis kinds — one run speaks one schedule source")
    if not plan and fault_kinds:
        plan = generate_fault_plan(fault_kinds, o["node_count"], n_ticks,
                                   interval, stop_tick)
    every = o["fault_snapshot_every"]
    every = None if every is None else int(every)
    if dist:
        faults = compile_fault_fuzz(dist, o["node_count"], stop_tick,
                                    snapshot_every=every)
    else:
        faults = compile_fault_plan(plan, o["node_count"], stop_tick,
                                    snapshot_every=every)
    if fault_kinds and not faults.active:
        raise ValueError(
            f"--nemesis {'/'.join(fault_kinds)} generated no fault "
            f"lanes for node_count={o['node_count']} (crash-restart "
            f"and link-degrade need >= 2 server nodes; use clock-skew "
            f"or an explicit --fault-plan for single-node workloads)")
    return faults


def resolve_pipeline(sim: SimConfig, opts: Dict[str, Any]) -> bool:
    mode = opts.get("pipeline", "auto")
    if mode in (True, "on"):
        return True
    if mode in (False, "off", None):
        return False
    from .pipeline import plan_chunks
    return len(plan_chunks(sim.n_ticks,
                           int(opts.get("chunk_ticks") or 100))) > 1


def device_info(device: torch.device) -> Dict[str, Any]:
    if device.type == "cuda":
        return {"type": "cuda", "name": torch.cuda.get_device_name(device),
                "count": torch.cuda.device_count()}
    return {"type": device.type, "name": device.type, "count": 1}


def prepare_store_dir(name: str, store_root: str) -> str:
    """A fresh run directory ``<store_root>/<name>-torch/<timestamp>``
    with a ``latest`` symlink repointed atomically."""
    from datetime import datetime
    base = datetime.now().strftime("%Y%m%d-%H%M%S-%f")
    parent = os.path.join(store_root, f"{name}-torch")
    d = os.path.join(parent, base)
    for attempt in range(2, 100):
        try:
            os.makedirs(d, exist_ok=False)
            break
        except FileExistsError:
            d = os.path.join(parent, f"{base}-{attempt}")
    latest = os.path.join(parent, "latest")
    tmp = os.path.join(parent, f".latest-tmp-{os.getpid()}")
    try:
        os.symlink(os.path.basename(d), tmp)
        os.replace(tmp, latest)
    except OSError:
        if os.path.lexists(tmp):
            os.unlink(tmp)
    return d


def write_store(run_dir: str, results: Dict[str, Any], histories) -> None:
    """``results.json`` + one ``history-<i>.jsonl`` per recorded
    instance (the JAX harness's store layout)."""
    with open(os.path.join(run_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=2, default=repr)
    for i, h in enumerate(histories):
        with open(os.path.join(run_dir, f"history-{i}.jsonl"), "w") as f:
            for r in h:
                f.write(json.dumps(r) + "\n")


def _telemetry_summary(tel) -> Optional[Dict[str, Any]]:
    if tel is None:
        return None
    t = {f: getattr(tel, f).cpu().numpy() for f in tel._fields}
    return {
        "sent": int(t["sent"].sum()), "delivered": int(t["delivered"].sum()),
        "delivered-servers": int(t["delivered_servers"].sum()),
        "invokes": int(t["invokes"].sum()), "acks": int(t["acks"].sum()),
        "inbox-hwm": int(t["inbox_hwm"].max()),
        "pool-hwm": int(t["pool_hwm"].max()),
        "partition-ticks": int(t["partition_ticks"].sum()),
        "nemesis-epochs": int(t["nemesis_epochs"].sum()),
        "rpc-latency-hist": t["rpc_hist"].sum(axis=0).tolist(),
    }


def run_torch_test(model: Model, opts: Optional[Dict[str, Any]] = None,
                   device: Optional[str] = None) -> Dict[str, Any]:
    """Configure, run, decode, check — one run of the fleet.

    ``device`` (or ``opts["device"]``) defaults to ``cuda``."""
    opts = {**TORCH_DEFAULTS, **(opts or {})}
    dev = resolve_device(device or opts.get("device"))
    sim = make_sim_config(model, opts)
    run_dir = (prepare_store_dir(model.name, opts["store_root"])
               if opts.get("store_root") else None)
    R, C = sim.record_instances, sim.client.n_clients
    phases: Dict[str, Any] = {}
    scan = None
    t0 = time.monotonic()
    if resolve_pipeline(sim, opts):
        from .pipeline import run_sim_pipelined
        res = run_sim_pipelined(
            model, sim, int(opts["seed"]), dev,
            chunk=int(opts.get("chunk_ticks") or 100),
            event_cap=int(opts.get("event_capacity") or 0) or None,
            scan_k=int(opts.get("scan_top_k") or 1))
        carry, scan = res.carry, res.scan
        phases["pipeline"] = res.perf
        rows = [r[:min(n, r.shape[0])] for r, n in res.compact]
        allrows = (np.concatenate(rows, axis=0) if rows
                   else np.zeros((0, 3 + model.ev_vals), np.int32))
        decode = lambda: decode_compact_rows(model, C, R, allrows)
    else:
        carry, events = run_sim(model, sim, int(opts["seed"]), dev)
        events = (events.cpu().numpy() if events is not None
                  else np.zeros((sim.n_ticks, 0, C, 2, 2 + model.ev_vals),
                                np.int32))
        decode = lambda: decode_dense(model, events)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_dec = time.monotonic()
    wall = t_dec - t0
    slabs = decode()
    histories = LazyHistories(model, slabs, R, sim.client.final_start,
                              opts["ms_per_tick"])
    phases["decode-s"] = round(time.monotonic() - t_dec, 4)

    t_chk = time.monotonic()
    checker = model.checker()
    per_instance: List[dict] = []
    for inst in range(R):
        try:
            per_instance.append(checker(histories[inst], opts))
        except Exception as e:   # a checker blow-up is a failing verdict
            per_instance.append(checker_failure(
                e, checker=getattr(model, "checker_name", "workload"),
                instance=inst))
    phases["check-s"] = round(time.monotonic() - t_chk, 4)

    violations = carry.violations.cpu().numpy()
    n_violating = int((violations > 0).sum())
    overall = compose_valid(r.get("valid?", True) for r in per_instance)
    if n_violating > 0:
        overall = False
    stats = {f: int(getattr(carry.stats, f)) for f in carry.stats._fields}
    results: Dict[str, Any] = {
        "valid?": overall,
        "invariants": {
            "violating-instances": n_violating,
            "violating-instance-ids":
                np.nonzero(violations)[0][:1024].tolist(),
            "total-violation-ticks": int(violations.sum()),
            # the device scan's earliest trippers: [first tick, instance]
            **({"earliest": [[int(tk), int(i)] for _, tk, i in scan
                             if i >= 0]} if scan is not None else {}),
        },
        "instance-count": sim.n_instances,
        "checked-instances": len(per_instance),
        "valid-instances": sum(1 for r in per_instance
                               if r.get("valid?") in (True, "unknown")),
        "instances": [dict(r, instance=i)
                      if r.get("valid?") is not True or i < 32
                      else {"instance": i, "valid?": True}
                      for i, r in enumerate(per_instance)],
        "net": {
            "sent": stats["sent"],
            "delivered": stats["delivered"],
            "dropped-partition": stats["dropped_partition"],
            "dropped-loss": stats["dropped_loss"],
            "dropped-overflow": stats["dropped_overflow"],
        },
        "device": device_info(dev),
        "perf": {
            "wall-s": wall,
            "ticks": sim.n_ticks,
            "ticks-per-sec": sim.n_ticks / wall if wall > 0 else 0.0,
            "msgs-per-sec": stats["delivered"] / wall if wall > 0 else 0.0,
            "instance-ticks-per-sec": (sim.n_instances * sim.n_ticks / wall
                                       if wall > 0 else 0.0),
            "phases": phases,
        },
    }
    tel = _telemetry_summary(carry.telemetry)
    if tel is not None:
        results["telemetry"] = tel
    if sim.faults.active:
        results["faults"] = plan_summary(sim.faults)
    if sim.faults.has_fuzz:
        # schedule-space coverage: a CPU re-draw of the fleet's windows
        results["fault-fuzz"] = faults_fuzz.fleet_coverage(
            faults_fuzz.fleet_windows(sim.faults, sim.net.n_nodes,
                                      int(opts["seed"]),
                                      np.arange(sim.n_instances)))
    if phases.get("pipeline", {}).get("overflowed-chunks"):
        results["events-truncated"] = True
    if run_dir is not None:
        write_store(run_dir, results, histories)
        results["store-dir"] = run_dir
    return results
