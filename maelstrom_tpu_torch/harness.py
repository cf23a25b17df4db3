"""Host-side harness of the port: configure, run, decode, check.

Counterpart of ``maelstrom_tpu/tpu/harness.py``: :func:`run_torch_test`
builds a :class:`SimConfig` from CLI-style opts, runs the fleet (chunked
with event compaction, optionally stopping early on an invariant trip,
or in one loop), decodes the recorded instances' events into histories
as the chunks arrive and checks them in the checker farm
(``checkers/pool.py``) — every recorded instance, or with
``check_mode="device"`` only those the device verdict lanes flagged —
replays the instances whose on-device invariants tripped (the funnel),
and writes the JAX harness's store layout. With ``checkpoint_every`` K
a stored chunked run checkpoints its carry every K chunks, and
``run_torch_test(..., resume_from=run_dir)`` finishes a killed one in
place (``campaign/``). The virtual clock is 1 tick = ``ms_per_tick``
simulated ms.

Runs go to the card (``device="cuda"``) unless the caller asks for the
CPU; with no card and no CPU request they raise — a measurement path
never falls back to the CPU.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .checkers import compose_valid, device_summary
from .checkers.availability import availability_checker
from .checkers.pool import (VerdictPipeline, check_instances,
                            resolve_check_workers)
from .decode import LazyHistories, decode_dense
from .faults import (FAULT_KINDS, compile_fault_fuzz, compile_fault_plan,
                     generate_fault_plan)
from .faults import fuzz as faults_fuzz
from .faults.engine import plan_summary
from .netsim import LATENCY_DISTS, NetConfig
from .runtime import (ClientConfig, Model, NEMESIS_KINDS, NemesisConfig,
                      SimConfig, run_sim)
from .telemetry.fleet import (fleet_summary, write_fleet_metrics,
                              write_fleet_svgs)
from .telemetry.recorder import TelemetryConfig
from .telemetry.stream import scan_to_violation, scan_to_violations

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
    journal_instances=0,     # instances whose message traffic is
                             # journaled (messages.svg, results.net.journal)
    netid=None,              # the NETID lane; None = on when journaling
    pool_slots=128,
    inbox_k=8,
    ms_per_tick=MS_PER_TICK,
    layout="lead",           # the port implements the batch-leading layout
    telemetry=True,
    telemetry_stride=0,      # 0 = auto (<= 256 windows)
    telemetry_hist_buckets=16,
    profile_dir=None,        # a torch.profiler session over the run,
                             # its Chrome trace written into this dir
    device_profile="auto",   # per-chunk device time by phase (telemetry/
                             # profiler.py): "auto" the first chunks and
                             # then every 8th, "on" every chunk, "off"
                             # none; captured chunks gain the heartbeat's
                             # device-ms lane and feed results.perf.
                             # phases.device; trajectories are the same
                             # at every setting
    pipeline="auto",         # chunked executor when the horizon spans
                             # several chunks
    chunk_ticks=100,
    event_capacity=0,        # 0 = auto from the client rate
    heartbeat=True,          # write heartbeat.jsonl into the store dir
    fail_fast=False,         # stop issuing chunks once a chunk's
                             # violation scan trips (at most one chunk
                             # in flight runs past it)
    scan_top_k=8,
    checkpoint_every=0,      # chunks between carry checkpoints (campaign/
                             # checkpoint.py; 0 = off): a checkpointed
                             # run killed at any point resumes in place
                             # (`campaign resume <run-dir>`)
    run_tag=None,            # store-dir suffix (<ts>-<tag>): campaign
                             # items pass item<k>
    nemesis_kind="random-halves",
    nemesis_schedule=(),     # kind="scripted": ((until_tick, ((dst, src),
                             # ...)), ...)
    fault_plan=None,         # fault-plan dict (faults/spec.py)
    fault_fuzz=None,         # fault distribution dict (faults/fuzz.py)
    fault_snapshot_every=None,  # slab stride; None = the plan's own
    seed=0,
    # read with .get() by the JAX harness, with these defaults
    availability=None,       # None, "total" or a fraction of ok ops
    funnel=True,             # replay the invariant-tripping instances
    funnel_max=32,           # ... at most this many
    check_workers=None,      # checker-farm worker processes (checkers/
                             # pool.py): 0 = serial, None = auto (a pool
                             # for >= 16 recorded instances on a
                             # multi-core host); verdicts are identical
                             # at every setting
    check_mode="farm",       # verdict routing: "farm" checks every
                             # recorded instance on the host; "device"
                             # runs the device verdict lanes (checkers/
                             # device_summary.py) and the farm checks
                             # only the flagged instances; "both" runs
                             # both and audits the lanes against the farm
)
CHECK_MODES = ("farm", "device", "both")

# options of the JAX harness that change neither the trajectory nor the
# verdict and have no counterpart here, accepted and not used: the
# executable store and the compilation cache (the port compiles nothing
# per run)
LIFECYCLE_OPTS = ("aot_store", "compile_cache")
# model-selection flags (models.get_model builds the model from them; the
# harness holds the model to them) and the Elle checker's model names
MODEL_OPTS = ("crash_clients", "txn_dirty_apply", "consistency_models")
KNOWN_OPTS = (set(TORCH_DEFAULTS) | set(LIFECYCLE_OPTS) | set(MODEL_OPTS)
              | {"store_root", "store_dir", "device"})


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
    journal_instances = min(o["journal_instances"], o["n_instances"])
    # the NETID pairing lane rides only when the run journals (or the
    # caller forces the wide format); the journal decoder needs it
    netid = o.get("netid")
    netid = journal_instances > 0 if netid is None else bool(netid)
    if journal_instances > 0 and not netid:
        raise ValueError(
            "journal_instances > 0 needs the wire format's NETID "
            "pairing lane; drop netid=False or disable journaling")
    net = NetConfig(
        n_nodes=o["node_count"], n_clients=o["concurrency"],
        pool_slots=o["pool_slots"], inbox_k=o["inbox_k"],
        body_lanes=model.body_lanes,
        latency_mean=float(o["latency"]) / mpt,
        latency_dist=LATENCY_DISTS[o["latency_dist"]],
        p_loss=float(o["p_loss"]), netid=netid)
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
    check_mode = o.get("check_mode") or "farm"
    if check_mode not in CHECK_MODES:
        raise ValueError(f"unknown check_mode {check_mode!r} "
                         "(expected farm/device/both)")
    return SimConfig(net=net, client=client, nemesis=nemesis,
                     n_instances=o["n_instances"], n_ticks=n_ticks,
                     record_instances=min(o["record_instances"],
                                          o["n_instances"]),
                     journal_instances=journal_instances,
                     telemetry=telemetry, faults=faults,
                     check_summary=check_mode in ("device", "both"))


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


def prepare_store_dir(name: str, store_root: str,
                      tag: Optional[str] = None) -> str:
    """A fresh run directory ``<store_root>/<name>-torch/<timestamp>``
    (``<timestamp>-<tag>`` with a ``tag``: campaign items pass
    ``item<k>``) with a ``latest`` symlink repointed atomically."""
    from datetime import datetime
    ts = datetime.now().strftime("%Y%m%d-%H%M%S-%f")
    base = f"{ts}-{tag}" if tag else ts
    parent = os.path.join(store_root, f"{name}-torch")
    d = os.path.join(parent, base)
    for attempt in range(2, 100):
        try:
            os.makedirs(d, exist_ok=False)
            break
        except FileExistsError:
            d = os.path.join(parent, f"{base}-{attempt}")
    latest = os.path.join(parent, "latest")
    # one temporary name per call: threads of one process share the pid
    tmp = os.path.join(parent, f".latest-tmp-{os.getpid()}-{id(d)}")
    try:
        os.symlink(os.path.basename(d), tmp)
        os.replace(tmp, latest)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
    return d


def _start_trace(profile_dir: Optional[str], dev: torch.device,
                 phases: Dict[str, Any]):
    """A ``torch.profiler`` session over the run (the card's kernels
    too on a card), or None; a session that cannot start is recorded
    under ``phases["profile-error"]`` and the run goes on."""
    if not profile_dir:
        return None
    try:
        from torch.profiler import ProfilerActivity, profile
        os.makedirs(profile_dir, exist_ok=True)
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        session = profile(activities=acts)
        session.__enter__()
        return session
    except Exception as e:
        phases["profile-error"] = repr(e)[:160]
        return None


def _stop_trace(session, profile_dir: str, dev: torch.device,
                phases: Dict[str, Any]) -> None:
    """End the session and write its Chrome trace into
    ``profile_dir`` (``trace-<pid>-<timestamp>.json``)."""
    try:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        session.__exit__(None, None, None)
        session.export_chrome_trace(os.path.join(
            profile_dir, f"trace-{os.getpid()}-"
                         f"{time.strftime('%Y%m%d-%H%M%S')}.json"))
    except Exception as e:
        phases["profile-error"] = repr(e)[:160]


def write_store(run_dir: str, results: Dict[str, Any], histories,
                journal=None, funnel: Optional[Dict[str, Any]] = None,
                fleet: Optional[Dict[str, Any]] = None) -> None:
    """The JAX harness's store layout (``_write_store``):
    ``fleet-metrics.json`` and the fleet SVGs when telemetry ran; the
    Lamport diagram ``messages.svg`` when a journal was recorded; the
    perf plots and ``timeline.html`` from the first recorded history;
    ``results.json``; ``history-<i>.jsonl`` and ``history-<i>.txt`` per
    recorded instance; and ``funnel-history-<id>.jsonl`` per replayed
    instance, named by its instance id in the fleet. (The heartbeat,
    ``heartbeat.jsonl``, is written during the run.)"""
    from .checkers.perf import plot_perf
    from .checkers.timeline import render_timeline
    from .gen.history import write_txt
    if fleet is not None:
        write_fleet_metrics(fleet, run_dir)
        write_fleet_svgs(fleet, run_dir)
    if journal is not None:
        from .net.viz import plot_lamport
        plot_lamport(journal, os.path.join(run_dir, "messages.svg"))
    if histories:
        plot_perf(histories[0], run_dir)
        render_timeline(histories[0], os.path.join(run_dir,
                                                   "timeline.html"))
    with open(os.path.join(run_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=2, default=repr)
    for i, h in enumerate(histories):
        _write_jsonl(os.path.join(run_dir, f"history-{i}.jsonl"), h)
        write_txt(h, os.path.join(run_dir, f"history-{i}.txt"))
    if funnel:
        for iid, h in funnel["histories"].items():
            _write_jsonl(os.path.join(run_dir,
                                      f"funnel-history-{iid}.jsonl"), h)


def _write_jsonl(path: str, records) -> None:
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")


def replay_instances(model: Model, opts: Dict[str, Any],
                     instance_ids: List[int], device=None
                     ) -> Dict[str, Any]:
    """Re-simulate exactly ``instance_ids`` over the full planned horizon
    (same seed and options) with every one recorded, check each, and
    return ``{ids, replayed-violating, verdicts, histories}``. Draws are
    pure functions of (seed, purpose, tick, instance id), so each
    instance replays the trajectory it had in the fleet; the count of
    replayed instances whose invariants trip again is the self-check.
    The checks go through the checker farm with the run's
    ``check_workers`` (serial for a small replay under auto)."""
    opts = {**TORCH_DEFAULTS, **opts}
    dev = resolve_device(device or opts.get("device"))
    K = len(instance_ids)
    sim = make_sim_config(model, {**opts, "n_instances": K,
                                  "record_instances": K,
                                  "journal_instances": 0})
    ids = torch.tensor(instance_ids, dtype=torch.int32, device=dev)
    carry, ys = run_sim(model, sim, int(opts["seed"]), dev, ids)
    histories = LazyHistories(model, decode_dense(model,
                                                  ys.events.cpu().numpy()),
                              K, sim.client.final_start,
                              opts["ms_per_tick"])
    verdicts = check_instances(
        model, histories, opts,
        workers=resolve_check_workers(opts.get("check_workers"), K),
        final_start=sim.client.final_start,
        ms_per_tick=opts["ms_per_tick"])
    for iid, h, v in zip(instance_ids, histories, verdicts):
        v["instance"] = int(iid)
        v["ops"] = sum(1 for r in h if r["type"] == "invoke")
    return {
        "ids": [int(i) for i in instance_ids],
        "replayed-violating": int((carry.violations > 0).sum()),
        "verdicts": verdicts,
        "histories": {int(i): h for i, h in zip(instance_ids, histories)},
    }


# options that, with the model, fix a run's trajectory, and the policy
# knobs a resumed run keeps: the heartbeat's run-start record carries
# them, so triage, shrink and campaign resume can rebuild the run (the
# JAX harness's list)
_REPRO_OPT_KEYS = (
    "node_count", "concurrency", "rate", "time_limit", "latency",
    "latency_dist", "p_loss", "nemesis", "nemesis_interval",
    "nemesis_kind", "nemesis_schedule", "rpc_timeout", "recovery_time",
    "n_instances", "record_instances", "journal_instances", "netid",
    "pool_slots", "inbox_k", "ms_per_tick", "layout", "telemetry",
    "telemetry_stride", "telemetry_hist_buckets", "chunk_ticks",
    "event_capacity", "seed", "topology", "availability",
    "consistency_models", "key_count", "pipeline", "fail_fast",
    "scan_top_k", "funnel", "funnel_max", "checkpoint_every",
    "check_workers", "check_mode",
    "aot_store", "fault_plan", "fault_fuzz", "fault_snapshot_every",
    "crash_clients", "txn_dirty_apply")


def heartbeat_meta(model: Model, sim: SimConfig, opts: Dict[str, Any],
                   fuzz_windows=None) -> Dict[str, Any]:
    """The run-start record's payload: enough to label a ``watch``
    report and to replay the run (``triage``, ``shrink``).
    ``fuzz_windows`` is the fleet's ``fuzz.fleet_windows`` on a fuzz
    run."""
    repro = {}
    for k in _REPRO_OPT_KEYS:
        if k in opts:
            try:
                json.dumps(opts[k])
            except (TypeError, ValueError):
                continue
            repro[k] = opts[k]
    meta = {
        "workload": model.name,
        "instances": sim.n_instances,
        "ticks": sim.n_ticks,
        "record-instances": sim.record_instances,
        "journal-instances": sim.journal_instances,
        "wire-format": sim.net.wire_format,
        "chunk-ticks": int(opts.get("chunk_ticks") or 100),
        "layout": "lead",
        "seed": int(opts.get("seed") or 0),
        "opts": repro,
        # scalar model knobs: the replay rebuilds the same automaton
        "model-config": {k: v for k, v in vars(model).items()
                         if isinstance(v, (bool, int, float, str))},
    }
    if sim.faults.active:
        meta["faults"] = plan_summary(sim.faults)
    if fuzz_windows is not None:
        meta["fault-fuzz"] = faults_fuzz.fleet_coverage(fuzz_windows)
    return meta


def _resume_state(model: Model, sim: SimConfig, seed: int, run_dir: str,
                  dev: torch.device):
    """The cut a killed run left in ``<run_dir>/checkpoint/``, its carry
    rebuilt on ``dev`` in the structure of the port's own init carry."""
    from .campaign.checkpoint import (KIND_PIPELINED, CheckpointError,
                                      load_checkpoint, restore_carry)
    from .pipeline import ResumeState
    from .runtime import init_carry
    ck = load_checkpoint(run_dir)
    if ck is None:
        raise CheckpointError(
            f"{run_dir} has no checkpoint to resume from "
            f"(checkpointing is opt-in: --checkpoint-every K)")
    if ck["kind"] != KIND_PIPELINED:
        raise CheckpointError(
            f"{run_dir} holds a {ck['kind']!r} checkpoint; "
            f"run_torch_test resumes single-device runs only")
    template = init_carry(model, sim, seed, dev)
    return ResumeState(carry=restore_carry(template, ck["carry"],
                                           device=dev),
                       ticks=int(ck["ticks"]), chunks=int(ck["chunks"]),
                       compact=tuple(ck["compact"]),
                       journal=tuple(ck["journal"]))


def run_torch_test(model: Model, opts: Optional[Dict[str, Any]] = None,
                   device: Optional[str] = None,
                   resume_from: Optional[str] = None) -> Dict[str, Any]:
    """Configure, run, decode, check — one run of the fleet.

    ``device`` (or ``opts["device"]``) defaults to ``cuda``. The results
    carry the JAX harness's keys in its order, and the port's
    ``device``, ``perf.ticks-per-sec``, ``faults`` and ``fault-fuzz``.
    A run with a store streams ``heartbeat.jsonl`` into its directory
    from the first chunk on (``heartbeat=False`` turns it off).

    ``resume_from`` continues a checkpointed run in place: pass the
    killed run's store dir, with ``opts`` rebuilt from its heartbeat's
    run-start record (``campaign.runner.resume_run`` does both). The run
    restores the carry and the host accumulators from
    ``<run_dir>/checkpoint/``, appends a resume seam to the heartbeat,
    and rewrites the run dir's artifacts with results equal to an
    uninterrupted run's."""
    opts = {**TORCH_DEFAULTS, **(opts or {})}
    dev = resolve_device(device or opts.get("device"))
    sim = make_sim_config(model, opts)
    run_dir = None
    resume = None
    phases: Dict[str, Any] = {}
    if resume_from is not None:
        t_r = time.monotonic()
        run_dir = os.path.realpath(resume_from)
        resume = _resume_state(model, sim, int(opts["seed"]), run_dir, dev)
        phases["restore-s"] = round(time.monotonic() - t_r, 4)
        opts = {**opts, "pipeline": "on"}   # checkpoints are chunked
    elif opts.get("store_dir"):
        # the caller made (and recorded) the run dir: a campaign item
        # knows where its checkpoint lives before the run starts
        run_dir = opts["store_dir"]
        os.makedirs(run_dir, exist_ok=True)
    elif opts.get("store_root"):
        run_dir = prepare_store_dir(model.name, opts["store_root"],
                                    tag=opts.get("run_tag"))
    R, C = sim.record_instances, sim.client.n_clients
    pipe_res = None
    use_pipe = resolve_pipeline(sim, opts)
    if opts.get("fail_fast") and not use_pipe:
        print("note: fail_fast has no effect on the single-loop executor "
              "(one dispatch for the whole horizon); use pipeline='on' or "
              "a multi-chunk horizon", file=sys.stderr)
    # the fleet's drawn fault windows, re-drawn once on the host for the
    # heartbeat and the results' schedule-space coverage
    fuzz_windows = (faults_fuzz.fleet_windows(
        sim.faults, sim.net.n_nodes, int(opts["seed"]),
        np.arange(sim.n_instances, dtype=np.int32))
        if sim.faults.has_fuzz else None)
    hb = None
    if run_dir and opts.get("heartbeat", True):
        from .telemetry.stream import HeartbeatWriter
        if resume is not None:
            hb = HeartbeatWriter(run_dir, {"workload": model.name,
                                           "chunks-done": resume.chunks},
                                 resume_from=resume.ticks)
        else:
            hb = HeartbeatWriter(run_dir, dict(
                heartbeat_meta(model, sim, opts, fuzz_windows),
                pipeline=bool(use_pipe)))
    checkpoint_cb = None
    if int(opts.get("checkpoint_every") or 0) > 0:
        if run_dir and use_pipe:
            from .campaign.checkpoint import (KIND_PIPELINED,
                                              make_checkpoint_cb)
            checkpoint_cb = make_checkpoint_cb(
                run_dir, kind=KIND_PIPELINED,
                meta={"workload": model.name, "seed": int(opts["seed"]),
                      "layout": "lead",
                      "chunk-ticks": int(opts.get("chunk_ticks") or 100)})
        else:
            # durability the caller asked for would not exist: say so,
            # as the JAX harness does
            why = ("no store dir to hold checkpoint/" if not run_dir
                   else "the monolithic executor has no chunk "
                        "boundaries to checkpoint at")
            print(f"note: --checkpoint-every has no effect here "
                  f"({why}); the run will NOT be resumable",
                  file=sys.stderr)
    # the verdict stage: the farm's workers start before the run (their
    # start-up overlaps the card's work) and take each chunk's slabs as
    # the executor consumes it
    verdict = VerdictPipeline(
        model, C, R, sim.client.final_start, opts["ms_per_tick"], opts,
        resolve_check_workers(opts.get("check_workers"), R))
    if resume is not None:
        # the checkpointed chunks go through the stream decoder ahead of
        # the live suffix, so the histories cover the whole horizon
        for rows, count in resume.compact:
            verdict.feed_chunk(np.asarray(rows), int(count), 0, 0)
    # per-chunk device time (telemetry/profiler.py) on the chunked
    # executor; "off" builds no profiler and pays for no weight pass
    prof = None
    mode = str(opts.get("device_profile") or "auto")
    if use_pipe and mode != "off":
        from .telemetry.profiler import DeviceProfiler
        prof = DeviceProfiler(mode, model=model, sim=sim, device=dev)
    events = None
    session = _start_trace(opts.get("profile_dir"), dev, phases)
    t0 = time.monotonic()
    try:
        if use_pipe:
            from .pipeline import run_sim_pipelined
            pipe_res = run_sim_pipelined(
                model, sim, int(opts["seed"]), dev,
                chunk=int(opts.get("chunk_ticks") or 100),
                event_cap=int(opts.get("event_capacity") or 0) or None,
                scan_k=int(opts.get("scan_top_k") or 1),
                fail_fast=bool(opts.get("fail_fast")), heartbeat=hb,
                fuzz_windows=fuzz_windows, event_sink=verdict.feed_chunk,
                check_mode=opts.get("check_mode"),
                checkpoint_cb=checkpoint_cb,
                checkpoint_every=int(opts.get("checkpoint_every") or 0),
                resume=resume, profiler=prof)
            carry = pipe_res.carry
            journal_sends = pipe_res.journal_sends
            journal_recvs = pipe_res.journal_recvs
            phases["pipeline"] = pipe_res.perf
            if prof is not None and prof.records:
                # device ms/tick by phase, next to the host timers
                phases["device"] = prof.summary()
        else:
            carry, ys = run_sim(model, sim, int(opts["seed"]), dev)
            events = (ys.events.cpu().numpy() if ys.events is not None
                      else np.zeros((sim.n_ticks, 0, C, 2,
                                     2 + model.ev_vals), np.int32))
            journal_sends, journal_recvs = (
                None if x is None else x.cpu().numpy()
                for x in (ys.journal_sends, ys.journal_recvs))
    except BaseException:
        verdict.close()
        if hb is not None:
            # no run-end record: the heartbeat's prefix marks a dead run
            hb.close()
        raise
    finally:
        trace_s = 0.0
        if session is not None:
            t_tr = time.monotonic()
            _stop_trace(session, opts["profile_dir"], dev, phases)
            trace_s = time.monotonic() - t_tr
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    # the trace's export is not the run's
    wall = time.monotonic() - t0 - trace_s
    fleet = None
    if carry.telemetry is not None:
        tel = carry.telemetry
        fleet = fleet_summary(type(tel)(*(x.cpu().numpy() for x in tel)),
                              sim, opts["ms_per_tick"])
    if events is not None:
        verdict.feed_dense(events)
    # --check-mode device: the lanes and the invariants pick the recorded
    # instances the farm checks; the others were screened clean on the
    # card and cost no host checker work
    check_mode = opts.get("check_mode") or "farm"
    violations = carry.violations.cpu().numpy()
    summ = (carry.check_summary.cpu().numpy()
            if carry.check_summary is not None else None)
    flagged_all = device_summary.flagged_mask(violations, summ)
    flagged_ids = np.nonzero(flagged_all)[0]
    per_instance, histories, check_rec = verdict.finish(
        flagged=[int(i) for i in flagged_ids if i < R]
        if check_mode == "device" else None)
    if summ is not None:
        check_rec["check-mode"] = check_mode
        check_rec["farm-load-fraction"] = round(
            check_rec["farm-instances"] / max(1, R), 6)
    phases["check"] = check_rec
    availability = None
    if opts.get("availability") is not None:
        availability = availability_checker(
            [r for h in histories for r in h], opts["availability"])

    n_violating = int((violations > 0).sum())
    violating_ids = np.nonzero(violations)[0]
    overall = compose_valid(r.get("valid?", True) for r in per_instance)
    if n_violating > 0:
        overall = False
    checker_errors = sum(1 for r in per_instance if "traceback" in r)
    stats = {f: int(getattr(carry.stats, f)) for f in carry.stats._fields}
    pipe_stats = phases.get("pipeline")
    stopped = bool(pipe_stats and pipe_stats.get("stopped-early"))
    # on a fail-fast stop only the issued prefix ran
    ticks_run = pipe_stats["ticks-dispatched"] if stopped else sim.n_ticks
    results: Dict[str, Any] = {
        "valid?": overall,
        "invariants": {
            "violating-instances": n_violating,
            "violating-instance-ids": violating_ids[:1024].tolist(),
            "total-violation-ticks": int(violations.sum()),
        },
        "instance-count": sim.n_instances,
        "checked-instances": len(per_instance),
        "valid-instances": sum(1 for r in per_instance
                               if r.get("valid?") in (True, "unknown")),
        **({"checker-errors": checker_errors} if checker_errors else {}),
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
    }
    if summ is not None:
        results["check"] = {
            "mode": check_mode,
            # fleet-wide, recorded or not: triage replays these
            "flagged-instances": int(flagged_all.sum()),
            "flagged-instance-ids": flagged_ids[:1024].tolist(),
            "farm-instances": check_rec["farm-instances"],
            "farm-load-fraction": check_rec["farm-load-fraction"],
            "summary-bytes-per-tick":
                device_summary.summary_bytes_per_tick(sim.n_instances),
        }
        if check_mode == "both":
            # the audit: the farm checked every recorded instance, so a
            # farm-invalid one the lanes did not flag is a screening gap
            # (device mode would have passed it)
            missed = [i for i, r in enumerate(per_instance)
                      if r.get("valid?") is False
                      and not bool(flagged_all[i])]
            results["check"]["device-vs-farm"] = {
                "complete": not missed, "missed-instance-ids": missed}
            if missed:
                results["valid?"] = False
    results["device"] = device_info(dev)
    results["perf"] = {
        "wall-s": wall,
        "ticks": ticks_run,
        "ticks-per-sec": ticks_run / wall if wall > 0 else 0.0,
        "msgs-per-sec": stats["delivered"] / wall if wall > 0 else 0.0,
        "instance-ticks-per-sec": (sim.n_instances * ticks_run / wall
                                   if wall > 0 else 0.0),
        "phases": phases,
    }
    if pipe_stats and pipe_stats.get("overflowed-chunks"):
        results["events-truncated"] = True
    if stopped:
        results["fail-fast"] = {
            "stopped": True,
            "ticks-dispatched": pipe_stats["ticks-dispatched"],
            "ticks-planned": sim.n_ticks,
            "first-violation": scan_to_violation(pipe_res.scan),
            "violations": scan_to_violations(pipe_res.scan),
        }
    if fleet is not None:
        # the condensed fleet view; the full dict is fleet-metrics.json
        results["telemetry"] = {k: v for k, v in fleet.items()
                                if k not in ("series", "latency-hist",
                                             "per-instance")}
    if availability is not None:
        results["availability"] = availability
        if availability["valid?"] is False:
            results["valid?"] = False
    funnel = None
    if opts["funnel"] and len(violating_ids) > 0:
        t_fun = time.monotonic()
        target = [int(i) for i in violating_ids[:int(opts["funnel_max"])]]
        funnel = replay_instances(model, opts, target, dev)
        funnel["total-violating"] = n_violating
        results["funnel"] = {k: v for k, v in funnel.items()
                             if k != "histories"}
        phases["funnel-s"] = round(time.monotonic() - t_fun, 4)
    if sim.faults.active:
        results["faults"] = plan_summary(sim.faults)
    if fuzz_windows is not None:
        results["fault-fuzz"] = faults_fuzz.fleet_coverage(fuzz_windows)
    journal = None
    if sim.journal_instances > 0:
        from .checkers.net_stats import net_stats_checker
        from .journal import TpuJournal
        journal = TpuJournal(model, sim.net, journal_sends, journal_recvs,
                             instance=0, ms_per_tick=opts["ms_per_tick"])
        # instance 0's own drop counters, as fleet-metrics.json has them
        drops = None
        if carry.telemetry is not None:
            tel = carry.telemetry
            drops = {"dropped-partition": int(tel.dropped_partition[0]),
                     "dropped-loss": int(tel.dropped_loss[0]),
                     "dropped-overflow": int(tel.dropped_overflow[0])}
        ns = net_stats_checker(journal, histories[0] if histories else [],
                               drops=drops)
        results["net"]["journal"] = {
            "stats": ns["stats"],
            "msgs-per-op": ns["msgs-per-op"],
            **({"drops": ns["drops"]} if drops is not None else {}),
            "instance": 0,
        }
    if run_dir is not None:
        t_st = time.monotonic()
        write_store(run_dir, results, histories, journal=journal,
                    funnel=funnel, fleet=fleet)
        # in the returned results only: results.json is written within
        phases["store-s"] = round(time.monotonic() - t_st, 4)
        results["store-dir"] = run_dir
    if hb is not None:
        hb.finish(
            status="stopped" if results.get("fail-fast") else "complete",
            **{"valid?": results["valid?"],
               "violating-instances": n_violating,
               # the verdict stage's record (perf.phases.check)
               "check": check_rec,
               **({"store-dir": run_dir} if run_dir else {})})
    return results
