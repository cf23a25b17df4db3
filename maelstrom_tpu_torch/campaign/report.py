"""Campaign status + the multi-run trend store.

Counterpart of ``maelstrom_tpu/campaign/report.py``, with the same
tables and ``summary.json``, the device-time columns included (each
item's ``perf.phases.device`` roll-up and its heartbeat's ``device-ms``
lane, ``telemetry/profiler.py``) and ``ir-bytes-est``: the static cost
of each item's model config (``analysis/cost_model.py``, one trace of
its tick on ``meta`` tensors per distinct config).

``campaign status`` merges every item's streaming heartbeat into one
live table — which items are queued/running/done, each running item's
tick frontier and cumulative fleet NetStats, and whether its worker is
still breathing (heartbeat mtime) — without touching any device.

``campaign report`` is the durable half: aggregate every completed
item's results.json into ``<campaign>/summary.json`` — one row per
item plus per-workload **trend rows** (verdicts, violating instances,
msgs/s spread) — so a sweep's history reads like the Pulsar
methodology's per-config trend tracking rather than a directory of
disconnected runs.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from . import queue as q

SUMMARY_FILE = "summary.json"


def _heartbeat_live(run_dir: Optional[str]) -> Dict[str, Any]:
    """One item's live view from its heartbeat prefix (empty when the
    run dir or heartbeat does not exist yet)."""
    if not run_dir:
        return {}
    from ..telemetry.stream import (HEARTBEAT_FILE, first_violation_of,
                                    read_heartbeat)
    path = os.path.join(run_dir, HEARTBEAT_FILE)
    if not os.path.exists(path):
        return {}
    try:
        hb = read_heartbeat(path)
    except OSError:
        return {}
    out: Dict[str, Any] = {}
    header = hb.get("header") or {}
    if header.get("ticks"):
        out["ticks-planned"] = header["ticks"]
    if hb.get("chunks"):
        last = hb["chunks"][-1]
        out["ticks-done"] = max(r.get("t0", 0) + r.get("ticks", 0)
                                for r in hb["chunks"])
        if last.get("net"):
            out["net"] = last["net"]
        # the device-time lane: the hot scope of the latest captured
        # chunk (heartbeats without it simply lack the key)
        for rec in reversed(hb["chunks"]):
            dev = rec.get("device-ms")
            if dev:
                from ..telemetry.profiler import hot_scope
                hot = hot_scope(dev)
                if hot:
                    out["device-hot"] = {
                        "scope": hot[0],
                        "ms-per-tick": round(
                            hot[1] / max(rec.get("ticks", 1), 1), 4)}
                break
    v = first_violation_of(hb)
    if v:
        out["first-violation"] = v
    if hb.get("resumes"):
        out["resumes"] = len(hb["resumes"])
    out["ended"] = hb.get("end") is not None
    try:
        out["age-s"] = round(time.time() - os.path.getmtime(path), 1)
    except OSError:
        pass
    return out


def campaign_status(cdir: str) -> Dict[str, Any]:
    """The merged live table: every item + its heartbeat view."""
    meta = q.load_campaign(cdir)
    rows = []
    counts: Dict[str, int] = {}
    for item in q.list_items(cdir):
        status = item.get("status", "?")
        counts[status] = counts.get(status, 0) + 1
        rows.append({
            "id": item.get("id"),
            "workload": item.get("workload"),
            "status": status,
            "attempts": item.get("attempts", 0),
            "failures": item.get("failures", 0),
            "retries": item.get("retries", 0),
            "not-before": item.get("not-before"),
            "seed": (item.get("opts") or {}).get("seed"),
            "valid?": item.get("valid?"),
            "run-dir": item.get("run-dir"),
            "live": _heartbeat_live(item.get("run-dir")),
        })
    return {"campaign": cdir, "name": meta.get("name"),
            "counts": counts, "items": rows}


def render_status(status: Dict[str, Any]) -> str:
    lines = [f"campaign: {status.get('name')}  [{status['campaign']}]",
             "  " + "  ".join(f"{k} {v}" for k, v in
                              sorted(status["counts"].items()))]
    for r in status["items"]:
        live = r.get("live") or {}
        progress = ""
        if live.get("ticks-done"):
            planned = live.get("ticks-planned")
            progress = (f"  t={live['ticks-done']}"
                        + (f"/{planned}" if planned else ""))
            if not live.get("ended") and live.get("age-s") is not None:
                progress += f" ({live['age-s']:.0f}s ago)"
        net = live.get("net") or {}
        if net:
            progress += f"  delivered {net.get('delivered', 0)}"
        hot = live.get("device-hot")
        if hot:
            # the device-ms hot-scope column
            progress += (f"  dev[{hot.get('scope', '?')} "
                         f"{hot.get('ms-per-tick', 0):.2f}/tick]")
        if live.get("resumes"):
            progress += f"  resumes {live['resumes']}"
        verdict = ("" if r.get("valid?") is None
                   else f"  valid? {r['valid?']}")
        retrying = ""
        if r.get("failures"):
            retrying = (f"  failures {r['failures']}/"
                        f"{r.get('retries', 0)}")
            nb = r.get("not-before")
            if nb is not None and float(nb) > time.time():
                retrying += (f" (retry in "
                             f"{float(nb) - time.time():.0f}s)")
        lines.append(
            f"  item {r['id']:>3}  {r['workload']:<18} "
            f"{r['status']:<9} attempts {r['attempts']}"
            f"{retrying}{verdict}{progress}")
    return "\n".join(lines)


def _static_cost(workload: str, opts: Dict[str, Any],
                 cache: Dict[str, Optional[int]]) -> Optional[int]:
    """``ir_bytes_est`` of one item's model config
    (``analysis/cost_model.py``): one trace of its tick per distinct
    config, cached; never allowed to kill the report."""
    key = json.dumps([workload,
                      {k: opts.get(k) for k in
                       ("node_count", "topology", "key_count", "layout",
                        "n_instances", "concurrency")}],
                     sort_keys=True, default=repr)
    if key in cache:
        return cache[key]
    est: Optional[int] = None
    try:
        from ..analysis.cost_model import tick_cost
        from ..harness import make_sim_config
        from .runner import _run_opts, build_model
        model = build_model(workload, opts)
        sim = make_sim_config(model, _run_opts(opts))
        est = int(tick_cost(model, sim).hbm_bytes)
    except Exception:
        pass
    cache[key] = est
    return est


def _device_phases(run_dir: Optional[str]) -> Optional[Dict[str, Any]]:
    """A completed item's device-time roll-up from its results.json
    (``perf.phases.device``); None when the run was not profiled or
    cannot be read."""
    if not run_dir:
        return None
    try:
        with open(os.path.join(run_dir, "results.json")) as fh:
            dev = (json.load(fh).get("perf", {}).get("phases", {})
                   .get("device"))
        return dev if isinstance(dev, dict) else None
    except Exception:
        return None


def campaign_report(cdir: str, static_cost: bool = True,
                    write: bool = True) -> Dict[str, Any]:
    """Aggregate completed items into the trend summary (and write it
    to ``<campaign>/summary.json``). ``static_cost`` adds the
    ``ir-bytes-est`` column."""
    meta = q.load_campaign(cdir)
    items = q.list_items(cdir)
    cost_cache: Dict[str, Optional[int]] = {}
    rows: List[Dict[str, Any]] = []
    for item in items:
        opts = item.get("opts") or {}
        row = {
            "id": item.get("id"),
            "workload": item.get("workload"),
            "seed": opts.get("seed"),
            "status": item.get("status"),
            "attempts": item.get("attempts", 0),
            "failures": item.get("failures", 0),
            "valid?": item.get("valid?"),
            "violating-instances": item.get("violating-instances"),
            "msgs-per-sec": item.get("msgs-per-sec"),
            "wall-s": item.get("wall-s"),
            "resumed": bool(item.get("resumed-from-checkpoint")),
            "run-dir": item.get("run-dir"),
        }
        if item.get("status") == q.FAILED:
            row["error"] = item.get("error")
        if static_cost and item.get("workload"):
            row["ir-bytes-est"] = _static_cost(item["workload"], opts,
                                               cost_cache)
        dev = _device_phases(item.get("run-dir"))
        if dev:
            row["device-ms-per-tick"] = dev.get("ms-per-tick")
            row["device-phases"] = dev.get("per-phase-ms-per-tick")
        rows.append(row)
    # per-workload trend rows: the cross-item aggregation the Pulsar
    # methodology tracks per configuration
    trends: Dict[str, Dict[str, Any]] = {}
    for row in rows:
        wl = row.get("workload") or "?"
        t = trends.setdefault(wl, {
            "runs": 0, "done": 0, "failed": 0, "valid": 0, "invalid": 0,
            "violating-instances": 0, "msgs-per-sec": [],
            "_ir_bytes": [], "_dev_mpt": [], "_dev_phases": []})
        if row.get("ir-bytes-est") is not None:
            t["_ir_bytes"].append(row["ir-bytes-est"])
        if row.get("device-ms-per-tick") is not None:
            t["_dev_mpt"].append(row["device-ms-per-tick"])
        if row.get("device-phases"):
            t["_dev_phases"].append(row["device-phases"])
        t["runs"] += 1
        if row["status"] == q.DONE:
            t["done"] += 1
            if row.get("valid?") is True:
                t["valid"] += 1
            else:
                t["invalid"] += 1
            t["violating-instances"] += int(
                row.get("violating-instances") or 0)
            if row.get("msgs-per-sec"):
                t["msgs-per-sec"].append(row["msgs-per-sec"])
        elif row["status"] == q.FAILED:
            t["failed"] += 1
    for t in trends.values():
        rates = t.pop("msgs-per-sec")
        t["msgs-per-sec-mean"] = (round(sum(rates) / len(rates), 1)
                                  if rates else None)
        t["msgs-per-sec-max"] = max(rates) if rates else None
        # a matrix can vary node_count within one workload: a single
        # number would pass one config's cost off as the workload's, so
        # mixed configs report their spread
        ib = t.pop("_ir_bytes")
        t["ir-bytes-est"] = (None if not ib else
                             ib[0] if len(set(ib)) == 1 else
                             f"{min(ib)}-{max(ib)}")
        # per-phase device-time trend rows: mean ms/tick over the
        # workload's profiled items
        mpt = t.pop("_dev_mpt")
        devp = t.pop("_dev_phases")
        t["device-ms-per-tick-mean"] = (
            round(sum(mpt) / len(mpt), 5) if mpt else None)
        if devp:
            acc: Dict[str, float] = {}
            for d in devp:
                for ph, ms in d.items():
                    acc[ph] = acc.get(ph, 0.0) + float(ms)
            t["device-phases-mean"] = {
                ph: round(ms / len(devp), 5)
                for ph, ms in sorted(acc.items())}
        else:
            t["device-phases-mean"] = None
    done = [r for r in rows if r["status"] == q.DONE]
    summary = {
        "name": meta.get("name"),
        "campaign": os.path.realpath(cdir),
        "generated": time.time(),
        "n-items": len(rows),
        "counts": {s: sum(1 for r in rows if r["status"] == s)
                   for s in (q.PENDING, q.RUNNING, q.DONE, q.FAILED,
                             q.PREEMPTED) if any(
                       r["status"] == s for r in rows)},
        # overall verdict: every item done and valid
        "valid?": (bool(done) and len(done) == len(rows)
                   and all(r.get("valid?") is True for r in done)),
        "items": rows,
        "trends": trends,
    }
    if write:
        q.write_json_atomic(os.path.join(cdir, SUMMARY_FILE), summary)
    return summary


def render_report(summary: Dict[str, Any]) -> str:
    lines = [f"campaign report: {summary.get('name')} — "
             f"{summary['n-items']} items "
             + " ".join(f"{k}={v}" for k, v in
                        sorted(summary["counts"].items()))
             + f", valid? {summary['valid?']}"]
    lines.append(f"{'id':>4} {'workload':<18} {'seed':>6} {'status':<9}"
                 f" {'valid?':<7} {'viol':>5} {'msgs/s':>10} "
                 f"{'ir-bytes':>9} resumed")
    for r in summary["items"]:
        lines.append(
            f"{r['id']:>4} {str(r.get('workload')):<18} "
            f"{str(r.get('seed')):>6} {r['status']:<9} "
            f"{str(r.get('valid?')):<7} "
            f"{str(r.get('violating-instances') or 0):>5} "
            f"{str(r.get('msgs-per-sec') or '-'):>10} "
            f"{str(r.get('ir-bytes-est') or '-'):>9} "
            f"{'yes' if r.get('resumed') else '-'}")
    lines.append("trends (per workload):")
    for wl, t in sorted(summary["trends"].items()):
        lines.append(
            f"  {wl:<18} runs {t['runs']} done {t['done']} "
            f"valid {t['valid']} invalid {t['invalid']} "
            f"failed {t['failed']} viol {t['violating-instances']} "
            f"msgs/s mean {t['msgs-per-sec-mean']} "
            f"max {t['msgs-per-sec-max']} "
            f"ir-bytes {t.get('ir-bytes-est')}")
        devp = t.get("device-phases-mean")
        if devp:
            # the per-phase device-time trend row
            lines.append(
                f"  {'':<18} device ms/tick "
                f"{t.get('device-ms-per-tick-mean')} — " + " ".join(
                    f"{ph} {ms:.4f}"
                    for ph, ms in sorted(devp.items(),
                                         key=lambda kv: -kv[1])))
    return "\n".join(lines)
