"""Violation forensics: from a flagged run dir to per-instance evidence.

Counterpart of ``maelstrom_tpu/checkers/triage.py``. ``python -m
maelstrom_tpu_torch triage <run-dir>``:

1. **Selects** the flagged instances: results.json's
   ``invariants.violating-instance-ids`` when the run completed, else
   every instance the heartbeat's violation scans named
   (``telemetry.stream.flagged_instances``), so a run killed mid-horizon
   or stopped by fail-fast is still triageable.
2. **Replays** exactly those instances (a trajectory depends only on
   ``(seed, instance id)``) with every one recorded and journaled, over
   exactly the ticks the run dispatched, through the chunked executor;
   each instance's history is expanded from the compacted stream alone
   (``expand_compact_events(..., instances=[k])``).
3. **Writes** each instance's bundle under
   ``<run-dir>/triage/instance-<id>/``: ``messages.svg`` (the Lamport
   diagram of its message traffic), ``journal.edn`` (the send/recv
   journal as EDN maps), ``history.jsonl`` and ``repro.json`` (what
   replays this one instance), plus ``schedule.json`` (its drawn fault
   schedule as a plan) on fuzz runs.

The replay checks itself: each replayed instance's invariants must trip
again (``replayed-violating`` in summary.json).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import torch

TRIAGE_DIR = "triage"
SUMMARY_FILE = "summary.json"


class TriageError(ValueError):
    """A run dir that cannot be triaged (missing or unusable inputs)."""


def load_run_info(run_dir: str) -> Dict[str, Any]:
    """What the run dir knows about itself: results.json (when the run
    completed) and the heartbeat prefix. Returns ``{run-dir, results,
    heartbeat, workload, opts, model-config, seed, ticks, chunk-ticks,
    flagged}``; ``flagged`` comes from the results when there are any
    (the tripped instances, then those only the device verdict lanes
    flagged), else from the heartbeat in first-seen order."""
    from ..telemetry.stream import (HEARTBEAT_FILE, flagged_instances,
                                    read_heartbeat)

    run_dir = os.path.realpath(run_dir)
    if not os.path.isdir(run_dir):
        raise TriageError(f"not a run directory: {run_dir}")
    results = None
    try:
        with open(os.path.join(run_dir, "results.json")) as f:
            results = json.load(f)
    except (OSError, json.JSONDecodeError):
        pass   # partial run: triage proceeds from the heartbeat alone
    hb = None
    hb_path = os.path.join(run_dir, HEARTBEAT_FILE)
    if os.path.exists(hb_path):
        hb = read_heartbeat(hb_path)
    header = (hb or {}).get("header") or {}
    opts = header.get("opts")
    if opts is None:
        raise TriageError(
            f"{run_dir} has no heartbeat run-start record with repro "
            f"opts (heartbeat.jsonl missing or truncated before the "
            f"first line); triage needs it to replay the run — re-run "
            f"with the heartbeat enabled (the default for stored runs)")
    workload = header.get("workload")
    if not workload:
        raise TriageError(f"{run_dir}: heartbeat header names no "
                          f"workload")

    flagged: List[int] = []
    if results:
        flagged = list(results.get("invariants", {})
                       .get("violating-instance-ids", []))
        # the device verdict lanes (check_mode device or both) flag
        # instances beyond the invariant trips: triage replays them too
        for i in (results.get("check", {})
                  .get("flagged-instance-ids", [])):
            if i not in flagged:
                flagged.append(i)
    if not flagged and hb:
        flagged = flagged_instances(hb)

    # the ticks the run dispatched: a fail-fast or killed run covers a
    # prefix, and the replay covers the same prefix
    ticks = header.get("ticks")
    if hb and hb.get("chunks"):
        ticks = max(rec.get("t0", 0) + rec.get("ticks", 0)
                    for rec in hb["chunks"])
    if hb and hb.get("end") and hb["end"].get("ticks"):
        ticks = hb["end"]["ticks"]
    if results:
        ff = results.get("fail-fast")
        if ff and ff.get("ticks-dispatched"):
            ticks = ff["ticks-dispatched"]
        elif not ff:
            ticks = results.get("perf", {}).get("ticks", ticks)
    return {
        "run-dir": run_dir,
        "results": results,
        "heartbeat": hb,
        "workload": workload,
        "opts": dict(opts),
        "model-config": header.get("model-config") or {},
        "seed": int(header.get("seed", opts.get("seed", 0) or 0)),
        "ticks": int(ticks) if ticks else None,
        "chunk-ticks": int(header.get("chunk-ticks") or 100),
        "flagged": [int(i) for i in flagged],
    }


def resolve_model(info: Dict[str, Any]):
    """Rebuild the run's model: the registry's model of the workload
    name, then the recorded scalar knobs (log_cap, heartbeat, n_keys,
    ...), so the replay runs the same automaton."""
    from ..models import get_model
    opts = info["opts"]
    model = get_model(info["workload"], int(opts.get("node_count", 1)),
                      opts.get("topology") or "grid", opts=opts)
    for k, v in info.get("model-config", {}).items():
        if hasattr(model, k):
            setattr(model, k, v)
    return model


def _journal_edn_lines(journal):
    """The instance's message journal as line-delimited EDN maps
    (``{:time .. :type :send|:recv :message {:id .. :src ..}}``, the
    shape ``net/journal.clj`` streams)."""
    from ..utils.edn import Keyword, dumps

    def kw(d):
        return {Keyword(k.replace("_", "-")): v for k, v in d.items()}

    for ev in journal.events():
        m = ev["message"]
        rec = {
            Keyword("time"): ev["time"],
            Keyword("type"): Keyword(ev["type"]),
            Keyword("message"): kw({
                "id": m["id"], "src": m["src"], "dest": m["dest"],
                "body": kw(m["body"]),
            }),
        }
        yield dumps(rec)


def check_fingerprint(info: Dict[str, Any], model, opts: Dict[str, Any],
                      error, verb: str) -> None:
    """The executable store's drift gate, as the JAX package's triage
    and campaign resume hold it: a run-start record carrying an
    ``aot-fingerprint`` that this package wrote (``aot-engine``) is
    recomputed from the record's options for the recorded device
    (``harness.aot_fingerprint_for``); a match goes on, a drift raises
    ``error`` naming EXE901, and ``MAELSTROM_AOT=0`` (or the record's
    store off) skips the gate. A fingerprint the JAX package wrote keys
    an XLA executable, which this package cannot recompute: refused by
    name."""
    header = ((info.get("heartbeat") or {}).get("header") or {})
    recorded = header.get("aot-fingerprint")
    if not recorded:
        return
    from ..harness import AOT_ENGINE, aot_fingerprint_for
    if header.get("aot-engine") != AOT_ENGINE:
        raise error(
            f"{info['run-dir']}: the run-start record carries the JAX "
            f"package's executable fingerprint (aot-fingerprint "
            f"{recorded}), which keys an XLA executable that "
            f"maelstrom_tpu_torch cannot recompute, so it cannot show "
            f"the {verb} runs the run's own code — {verb} this run with "
            f"python -m maelstrom_tpu")
    dsig = header.get("aot-device")
    current = aot_fingerprint_for(model, opts,
                                  device_sig=tuple(dsig) if dsig else None)
    if current is not None and current != recorded:
        raise error(
            f"EXE901: executable fingerprint drifted since this run "
            f"(recorded {recorded}, current {current}) — the dispatch's "
            f"sources, toolchain or run config changed, so the {verb} "
            f"would not be bit-identical to the original dispatch. Run "
            f"it from the matching checkout (and re-certify with "
            f"`python -m maelstrom_tpu_torch lint --aot --update-aot`), "
            f"or set MAELSTROM_AOT=0 to go on anyway")


def triage_run(run_dir: str, ids: Optional[List[int]] = None,
               max_instances: int = 8, out_root: Optional[str] = None,
               max_svg_events: int = 1500, device=None) -> Dict[str, Any]:
    """Replay a run's flagged instances on ``device`` (``cuda`` unless
    the caller names another) and write their bundles. Returns the
    summary dict (also written to ``triage/summary.json``). ``ids``
    overrides the flagged set."""
    from . import checker_failure
    from ..decode import LazyHistories, decode_dense
    from ..harness import make_sim_config, resolve_device
    from ..journal import TpuJournal
    from ..net.viz import plot_lamport
    from ..pipeline import expand_compact_events, run_sim_pipelined

    info = load_run_info(run_dir)
    targets = [int(i) for i in (ids if ids else info["flagged"])]
    dropped = max(0, len(targets) - int(max_instances))
    targets = targets[:int(max_instances)]
    out_dir = out_root or os.path.join(info["run-dir"], TRIAGE_DIR)
    summary: Dict[str, Any] = {
        "run-dir": info["run-dir"],
        "workload": info["workload"],
        "flagged": info["flagged"],
        "triaged": [],
        "dropped": dropped,
        "out-dir": out_dir,
    }
    if not targets:
        summary["note"] = ("no flagged instances (run is clean or the "
                           "heartbeat saw no violation scan hits)")
        return summary

    dev = resolve_device(device)
    model = resolve_model(info)
    # the store's drift gate (EXE901): the replay contract is bit-identity
    # with the run's own dispatch
    check_fingerprint(info, model, info["opts"], TriageError, "triage")
    K = len(targets)
    sub_opts = {**info["opts"], "n_instances": K, "record_instances": K,
                "journal_instances": K}
    ms_per_tick = float(sub_opts.get("ms_per_tick", 1) or 1)
    sim = make_sim_config(model, {**sub_opts, "device": dev.type})
    # fuzz runs: each instance's schedule is a pure function of (seed,
    # instance id); sim.faults is the run's own compiled distribution
    fuzz_fx = sim.faults if info["opts"].get("fault_fuzz") else None
    if info["ticks"] and info["ticks"] < sim.n_ticks:
        # the run dispatched a prefix: replay exactly those ticks
        sim = sim._replace(n_ticks=info["ticks"])
    res = run_sim_pipelined(
        model, sim, info["seed"], dev,
        instance_ids=torch.tensor(targets, dtype=torch.int32, device=dev),
        chunk=info["chunk-ticks"])
    replay_viol = res.carry.violations.cpu().numpy()
    first_viol = (res.carry.telemetry.first_violation.cpu().numpy()
                  if res.carry.telemetry is not None else None)
    summary["replayed-violating"] = int((replay_viol > 0).sum())
    summary["ticks"] = int(sim.n_ticks)
    checker = model.checker()
    checker_name = (getattr(model, "checker_name", None)
                    or f"{model.name}-checker")

    os.makedirs(out_dir, exist_ok=True)
    for k, gid in enumerate(targets):
        inst_dir = os.path.join(out_dir, f"instance-{gid}")
        os.makedirs(inst_dir, exist_ok=True)
        # only this instance's compacted rows become dense
        dense = expand_compact_events(model, sim, res.compact,
                                      n_ticks=sim.n_ticks, instances=[k])
        history = list(LazyHistories(
            model, decode_dense(model, dense), 1, sim.client.final_start,
            ms_per_tick)[0])
        try:
            verdict = checker(history, sub_opts)
        except Exception as e:   # a checker blow-up is a failing verdict
            verdict = checker_failure(e, checker=checker_name,
                                      instance=gid)
        journal = TpuJournal(model, sim.net, res.journal_sends,
                             res.journal_recvs, instance=k,
                             ms_per_tick=ms_per_tick)
        plot_lamport(journal, os.path.join(inst_dir, "messages.svg"),
                     max_events=max_svg_events)
        with open(os.path.join(inst_dir, "journal.edn"), "w") as f:
            for line in _journal_edn_lines(journal):
                f.write(line + "\n")
        with open(os.path.join(inst_dir, "history.jsonl"), "w") as f:
            for rec in history:
                f.write(json.dumps(rec) + "\n")
        entry = {
            "instance": gid,
            "dir": inst_dir,
            "valid?": verdict.get("valid?"),
            "violation-ticks": int(replay_viol[k]),
            "first-violation-tick": (int(first_viol[k])
                                     if first_viol is not None
                                     else None),
            "ops": sum(1 for r in history if r["type"] == "invoke"),
            "journal-events": sum(1 for _ in journal.events()),
        }
        repro = {
            "workload": info["workload"],
            "instance": gid,
            "seed": info["seed"],
            "ticks": int(sim.n_ticks),
            "opts": info["opts"],
            "verdict": verdict,
            "violation-ticks": entry["violation-ticks"],
            "first-violation-tick": entry["first-violation-tick"],
            # the single-instance replay, as an API call
            "replay": {
                "call": "maelstrom_tpu_torch.harness.replay_instances",
                "args": {"workload": info["workload"],
                         "opts": info["opts"],
                         "instance_ids": [gid]},
            },
            "command": (f"python -m maelstrom_tpu_torch triage "
                        f"{info['run-dir']} --instance {gid}"),
        }
        if fuzz_fx is not None:
            from ..faults.fuzz import reconstruct_plan
            plan = reconstruct_plan(fuzz_fx, sim.net.n_nodes,
                                    info["seed"], gid)
            with open(os.path.join(inst_dir, "schedule.json"),
                      "w") as f:
                json.dump(plan, f, indent=2)
            repro["fault-schedule"] = plan
            repro["shrink-command"] = (
                f"python -m maelstrom_tpu_torch shrink {info['run-dir']} "
                f"--instance {gid}")
        with open(os.path.join(inst_dir, "repro.json"), "w") as f:
            json.dump(repro, f, indent=2, default=repr)
        summary["triaged"].append(entry)

    with open(os.path.join(out_dir, SUMMARY_FILE), "w") as f:
        json.dump(summary, f, indent=2, default=repr)
    return summary


def render_triage_report(summary: Dict[str, Any]) -> str:
    lines = [f"triage: {summary['workload']} run at "
             f"{summary['run-dir']}"]
    flagged = summary.get("flagged", [])
    if not summary.get("triaged"):
        lines.append(summary.get("note", "nothing triaged"))
        return "\n".join(lines)
    lines.append(
        f"flagged instances: {flagged}"
        + (f" (+{summary['dropped']} beyond --max-instances)"
           if summary.get("dropped") else ""))
    lines.append(f"replayed {len(summary['triaged'])} instance(s) over "
                 f"{summary.get('ticks', '?')} ticks; "
                 f"{summary.get('replayed-violating', '?')} re-tripped "
                 f"on-device invariants")
    if summary.get("replayed-violating", 0) < sum(
            1 for _ in summary["triaged"]):
        lines.append("WARNING: some replayed instances did NOT re-trip "
                     "— replay may not match the original run's config")
    for e in summary["triaged"]:
        ft = e.get("first-violation-tick")
        lines.append(
            f"  instance {e['instance']}: valid? {e['valid?']}, "
            f"{e['violation-ticks']} violation tick(s)"
            + (f" (first at {ft})" if ft is not None and ft >= 0 else "")
            + f", {e['ops']} ops, {e['journal-events']} journal events"
            + f" -> {e['dir']}")
    return "\n".join(lines)
