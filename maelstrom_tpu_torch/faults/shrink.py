"""Automatic failing-schedule shrinking: fuzz hit -> minimal nemesis.

Counterpart of ``maelstrom_tpu/faults/shrink.py``; the attempt order,
the candidate order and the ``kept`` labels are its own. ``python -m
maelstrom_tpu_torch shrink <run-dir>``, for each flagged instance:

1. **Reconstructs** the instance's schedule from the seed
   (``fuzz.reconstruct_plan``) as a deterministic ``--fault-plan`` dict;
   a ``--fault-plan`` run starts from its plan.
2. **Verifies** it: replays the single instance through the chunked
   executor (``pipeline.run_sim_pipelined`` with ``instance_ids=[id]``)
   under that plan; its invariants must trip again.
3. **Delta-debugs** the plan to a local minimum: ddmin complement
   rounds over the fault phases (drop halves, then quarters, ... in one
   replay each), then greedy passes that drop whole fault phases, single
   victims (crash nodes, link edges, skewed nodes, membership
   removals) and halve phase durations, keeping each reduction whose
   replay still trips, under an attempt budget.
4. **Writes** ``triage/instance-<id>/shrunk-plan.json`` (a plan file for
   ``--fault-plan``) and ``shrink.json`` with the weights and the
   verification.

Each replay is one instance over the run's full horizon, so the wall
time grows with ``max_attempts``.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any, Dict, List, Optional

import torch

from . import fuzz as _fuzz
from .spec import membership_heal_phases

SHRINK_FILE = "shrink.json"
SHRUNK_PLAN_FILE = "shrunk-plan.json"


class ShrinkError(ValueError):
    """A run/instance that cannot be shrunk (not a fuzz run, or the
    reconstruction does not reproduce the failure)."""


def _phase_content(ph: Dict[str, Any]) -> int:
    """State-changing keys of a phase — what _normalize must never
    merge away. Membership 'add' (rejoin) events and heal 'members'
    restores count here (they change the timeline) but NOT as fault
    content (they heal, the shrinker never targets them)."""
    return (_fault_content(ph) + len(ph.get("add") or []))


def _fault_content(ph: Dict[str, Any], members_fault: bool = True) -> int:
    """Shrink-targetable content of a phase. A ``members`` key is fault
    content only when it actually REMOVES a node — callers pass
    ``members_fault=False`` for the heal/restore phases identified by
    :func:`spec.membership_heal_phases` (dropping a restore would
    EXTEND the outage via inheritance, the opposite of shrinking)."""
    return (len(ph.get("crash") or []) + len(ph.get("links") or [])
            + len(ph.get("skew") or {})
            + len(ph.get("remove") or [])
            + (1 if members_fault
               and ph.get("members") is not None else 0))


def _normalize(plan: Dict[str, Any]) -> Dict[str, Any]:
    """Merge adjacent healthy phases and drop a healthy tail — pure
    cosmetics for the written artifact (searchsorted semantics are
    unchanged by either)."""
    phases = [dict(p) for p in plan.get("phases", ())]
    out: List[Dict[str, Any]] = []
    for ph in phases:
        if out and _phase_content(out[-1]) == 0 \
                and _phase_content(ph) == 0:
            out[-1]["until"] = ph["until"]
        else:
            out.append(ph)
    while out and _phase_content(out[-1]) == 0:
        out.pop()
    if not out:
        return {}
    return {**{k: v for k, v in plan.items() if k != "phases"},
            "phases": out}


def _strip_faults(ph: Dict[str, Any],
                  keep_members: bool = False) -> Dict[str, Any]:
    """A phase with its fault content removed: the timeline boundary
    stays, and so does any membership 'add' (rejoin) event or — with
    ``keep_members`` — a heal/restore ``members`` set; dropping a heal
    would ENLARGE the fault, not shrink it."""
    kept = {"until": ph["until"]}
    if ph.get("add"):
        kept["add"] = ph["add"]
    if keep_members and ph.get("members") is not None:
        kept["members"] = ph["members"]
    return kept


def _candidates(plan: Dict[str, Any], n_nodes=None):
    """Yield reduced candidate plans, most aggressive first: whole
    fault phases dropped, then single victims, then halved durations.
    Each candidate is an independent copy of ``plan``."""
    phases = plan.get("phases", ())
    # recomputed on every (normalized) reduction — phase indices shift
    heals = membership_heal_phases(plan, n_nodes)
    fault_idx = [i for i, ph in enumerate(phases)
                 if _fault_content(ph, members_fault=i not in heals) > 0]
    for i in fault_idx:
        cand = copy.deepcopy(plan)
        cand["phases"][i] = _strip_faults(phases[i],
                                          keep_members=i in heals)
        yield f"drop-phase-{i}", cand
    for i in fault_idx:
        ph = phases[i]
        for v in ph.get("crash") or []:
            cand = copy.deepcopy(plan)
            cand["phases"][i]["crash"] = [
                x for x in ph["crash"] if x != v]
            if not cand["phases"][i]["crash"]:
                del cand["phases"][i]["crash"]
            yield f"phase-{i}-drop-crash-{v}", cand
        for v in ph.get("remove") or []:
            # keep a node in the cluster (its later rejoin 'add'
            # becomes a harmless no-op — membership_walk adds are
            # idempotent)
            cand = copy.deepcopy(plan)
            cand["phases"][i]["remove"] = [
                x for x in ph["remove"] if x != v]
            if not cand["phases"][i]["remove"]:
                del cand["phases"][i]["remove"]
            yield f"phase-{i}-drop-remove-{v}", cand
        if ph.get("members") is not None and i not in heals:
            cand = copy.deepcopy(plan)
            del cand["phases"][i]["members"]
            yield f"phase-{i}-drop-members", cand
        for j in range(len(ph.get("links") or [])):
            cand = copy.deepcopy(plan)
            del cand["phases"][i]["links"][j]
            if not cand["phases"][i]["links"]:
                del cand["phases"][i]["links"]
            yield f"phase-{i}-drop-edge-{j}", cand
        for node in list((ph.get("skew") or {})):
            cand = copy.deepcopy(plan)
            del cand["phases"][i]["skew"][node]
            if not cand["phases"][i]["skew"]:
                del cand["phases"][i]["skew"]
            yield f"phase-{i}-drop-skew-{node}", cand
    for i in fault_idx:
        prev = int(phases[i - 1]["until"]) if i else 0
        width = int(phases[i]["until"]) - prev
        if width >= 2:
            cand = copy.deepcopy(plan)
            cand["phases"][i]["until"] = prev + width // 2
            yield f"phase-{i}-halve-duration", cand


def make_replayer(model, opts: Dict[str, Any], instance_id: int,
                  device=None):
    """Build ``replay(plan) -> bool`` (True = the single-instance
    replay trips the invariants). The replay runs through the chunked
    executor on ``device`` with the run's options — same seed, same
    instance id, recording and journaling off."""
    from ..harness import make_sim_config, resolve_device
    from ..pipeline import run_sim_pipelined

    base = {**opts, "fault_fuzz": None, "n_instances": 1,
            "record_instances": 0, "journal_instances": 0,
            "funnel": False, "heartbeat": False, "fail_fast": False}
    seed = int(base.get("seed") or 0)
    chunk = int(base.get("chunk_ticks") or 100)
    dev = resolve_device(device)
    ids = torch.tensor([int(instance_id)], dtype=torch.int32, device=dev)

    def replay(plan: Optional[Dict[str, Any]]) -> bool:
        sim = make_sim_config(model, {**base,
                                      "fault_plan": plan or None})
        res = run_sim_pipelined(model, sim, seed, dev, instance_ids=ids,
                                chunk=chunk)
        return int(res.carry.violations[0]) > 0

    return replay


def _drop_phase_set(plan: Dict[str, Any], idxs,
                    heals=frozenset()) -> Dict[str, Any]:
    cand = copy.deepcopy(plan)
    for i in idxs:
        cand["phases"][i] = _strip_faults(cand["phases"][i],
                                          keep_members=i in heals)
    return cand


def _ddmin_phases(plan: Dict[str, Any], replay, attempts: int,
                  max_attempts: int, kept: List[str], n_nodes=None):
    """ddmin-style complement reduction over the FAULT PHASES: drop
    whole subsets (halves, then quarters, ...) of the fault-carrying
    phases in one verified replay each. One kept drop eliminates
    ``len(phases)/k`` phases for ONE replay — on multi-phase schedules
    this converges in O(log) replays where the greedy single-phase
    pass pays one replay per phase. Every kept reduction is
    replay-verified, exactly like the greedy pass. Returns
    ``(plan, attempts)``."""
    current = plan
    k = 2
    while attempts < max_attempts:
        heals = membership_heal_phases(current, n_nodes)
        fault_idx = [i for i, ph in enumerate(current.get("phases", ()))
                     if _fault_content(ph, members_fault=i not in heals)
                     > 0]
        if len(fault_idx) < 2:
            break
        k = min(k, len(fault_idx))
        chunk = -(-len(fault_idx) // k)
        subsets = [fault_idx[j:j + chunk]
                   for j in range(0, len(fault_idx), chunk)]
        reduced = False
        for sub in subsets:
            if attempts >= max_attempts:
                break
            cand = _normalize(_drop_phase_set(current, sub, heals))
            attempts += 1
            if replay(cand if cand else None):
                current = cand
                kept.append("ddmin-drop-phases-" +
                            ",".join(str(i) for i in sub))
                k = max(2, k - 1)
                reduced = True
                break
        if not reduced:
            if k >= len(fault_idx):
                break          # singleton granularity: greedy takes over
            k = min(len(fault_idx), 2 * k)
    return current, attempts


def shrink_plan(plan: Dict[str, Any], replay,
                max_attempts: int = 24, n_nodes=None) -> Dict[str, Any]:
    """Delta-debug to a local minimum: ddmin complement-halving rounds
    over the fault phases first, then the greedy candidate pass — try each reduction, keep any that still fails,
    restart on the reduced plan; stop at fixpoint or when
    ``max_attempts`` replays are spent. Returns
    ``{plan, attempts, kept}``."""
    current = _normalize(plan)
    attempts = 0
    kept: List[str] = []
    current, attempts = _ddmin_phases(current, replay, attempts,
                                      max_attempts, kept, n_nodes=n_nodes)
    progress = True
    while progress and attempts < max_attempts:
        progress = False
        for label, cand in _candidates(current, n_nodes=n_nodes):
            if attempts >= max_attempts:
                break
            cand = _normalize(cand)
            attempts += 1
            if replay(cand if cand else None):
                current = cand
                kept.append(label)
                progress = True
                break       # restart candidate enumeration on the
                #             reduced plan (greedy-first-improvement)
    return {"plan": current, "attempts": attempts, "kept": kept}


def shrink_instance(model, opts: Dict[str, Any], instance_id: int,
                    device=None,
                    max_attempts: int = 24) -> Dict[str, Any]:
    """The full loop for one flagged instance: reconstruct -> verify ->
    delta-debug -> verify the minimum. Fuzz runs reconstruct the
    instance's drawn schedule from the seed; deterministic
    ``--fault-plan`` runs delta-debug the PLAN ITSELF (a hand-built
    reconfiguration scenario is usually over-specified — extra link
    edges, over-long phases — and the minimizer applies verbatim).
    Raises :class:`ShrinkError` when the run carries no fault source
    or the starting plan does not reproduce the failure."""
    from ..harness import make_sim_config

    if not opts.get("fault_fuzz") and not opts.get("fault_plan"):
        raise ShrinkError(
            "not a fault run (neither fault_fuzz nor fault_plan in "
            "the repro opts) — nothing to shrink")
    sim = make_sim_config(model, dict(opts))
    seed = int(opts.get("seed") or 0)
    if opts.get("fault_fuzz"):
        plan0 = _fuzz.reconstruct_plan(sim.faults, sim.net.n_nodes,
                                       seed, instance_id)
    else:
        plan0 = dict(opts["fault_plan"])
    replay = make_replayer(model, opts, instance_id, device=device)
    if not plan0:
        raise ShrinkError(
            f"instance {instance_id}: reconstructed schedule is "
            f"all-healthy — a flagged instance with no faults means "
            f"the failure is fault-independent (triage it instead)")
    if not replay(plan0):
        raise ShrinkError(
            f"instance {instance_id}: the starting deterministic plan "
            f"does NOT reproduce the violation — for a fuzz run this "
            f"means the seed -> schedule replay was not bit-exact "
            f"(a bug, report it); for a plan run the flagged instance "
            f"is noise-dependent beyond the plan")
    n_nodes = int(sim.net.n_nodes)
    p0, v0 = _fuzz.plan_weight(plan0, n_nodes)
    res = shrink_plan(plan0, replay, max_attempts=max_attempts,
                      n_nodes=n_nodes)
    shrunk = res["plan"]
    # the reduced plan gets one final CONFIRMING replay (an unreduced
    # plan is plan0, whose replay above already failed) — keeping the
    # gate's `verified` assertion load-bearing rather than a constant
    verified = (True if not res["kept"]
                else replay(shrunk if shrunk else None))
    p1, v1 = _fuzz.plan_weight(shrunk, n_nodes)
    return {
        "instance": int(instance_id),
        "seed": seed,
        "original-plan": plan0,
        "original-phases": p0, "original-victims": v0,
        "shrunk-plan": shrunk,
        "shrunk-phases": p1, "shrunk-victims": v1,
        "attempts": res["attempts"],
        "kept": res["kept"],
        "verified": verified,
        "reduced": (p1, v1) < (p0, v0),
    }


def shrink_run(run_dir: str, ids: Optional[List[int]] = None,
               max_instances: int = 4, max_attempts: int = 24,
               device=None) -> Dict[str, Any]:
    """``shrink <run-dir>``: shrink each flagged instance's
    schedule and write its minimal plan under
    ``<run-dir>/triage/instance-<id>/``. Returns the summary (also
    written to ``triage/shrink-summary.json``)."""
    from ..checkers.triage import (TRIAGE_DIR, TriageError,
                                   load_run_info, resolve_model)

    try:
        info = load_run_info(run_dir)
    except TriageError as e:
        raise ShrinkError(str(e))
    opts = dict(info["opts"])
    opts["seed"] = info["seed"]
    if not opts.get("fault_fuzz") and not opts.get("fault_plan"):
        raise ShrinkError(
            f"{info['run-dir']} is not a fault run (its heartbeat "
            f"repro opts carry neither a fault_fuzz distribution nor "
            f"a fault_plan); shrink minimizes randomized-schedule "
            f"hits and over-specified deterministic plans")
    targets = [int(i) for i in (ids if ids else info["flagged"])]
    dropped = max(0, len(targets) - int(max_instances))
    targets = targets[:int(max_instances)]
    out_dir = os.path.join(info["run-dir"], TRIAGE_DIR)
    summary: Dict[str, Any] = {
        "run-dir": info["run-dir"], "workload": info["workload"],
        "flagged": info["flagged"], "shrunk": [], "errors": [],
        "dropped": dropped, "out-dir": out_dir,
    }
    if not targets:
        summary["note"] = ("no flagged instances (run is clean or the "
                           "heartbeat saw no violation scan hits)")
        return summary
    model = resolve_model(info)
    for gid in targets:
        inst_dir = os.path.join(out_dir, f"instance-{gid}")
        os.makedirs(inst_dir, exist_ok=True)
        try:
            rec = shrink_instance(model, opts, gid, device=device,
                                  max_attempts=max_attempts)
        except ShrinkError as e:
            summary["errors"].append({"instance": gid,
                                      "error": str(e)})
            continue
        with open(os.path.join(inst_dir, SHRUNK_PLAN_FILE), "w") as f:
            json.dump(rec["shrunk-plan"], f, indent=2)
        rec["shrunk-plan-file"] = os.path.join(inst_dir,
                                               SHRUNK_PLAN_FILE)
        with open(os.path.join(inst_dir, SHRINK_FILE), "w") as f:
            json.dump(rec, f, indent=2)
        summary["shrunk"].append(rec)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "shrink-summary.json"), "w") as f:
        json.dump(summary, f, indent=2, default=repr)
    return summary


def render_shrink_report(summary: Dict[str, Any]) -> str:
    lines = [f"shrink: {summary['workload']} run at "
             f"{summary['run-dir']}"]
    if summary.get("note"):
        lines.append(summary["note"])
    for rec in summary.get("shrunk", ()):
        lines.append(
            f"  instance {rec['instance']}: "
            f"{rec['original-phases']} phase(s)/"
            f"{rec['original-victims']} victim(s) -> "
            f"{rec['shrunk-phases']}/{rec['shrunk-victims']} in "
            f"{rec['attempts']} replay(s); verified "
            f"{rec['verified']} -> {rec.get('shrunk-plan-file', '?')}")
    for err in summary.get("errors", ()):
        lines.append(f"  instance {err['instance']}: ERROR "
                     f"{err['error']}")
    if summary.get("dropped"):
        lines.append(f"  (+{summary['dropped']} flagged instance(s) "
                     f"beyond --max-instances)")
    return "\n".join(lines)
