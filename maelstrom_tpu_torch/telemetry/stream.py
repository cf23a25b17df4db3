"""Streaming run heartbeat: one JSONL record per consumed chunk.

Counterpart of ``maelstrom_tpu/telemetry/stream.py``. The chunked
executor (``pipeline.py``) hands each chunk's snapshots — the cumulative
``NetStats`` vector, the violation scan computed on the device and the
compacted events' overflow flag — to a :class:`HeartbeatWriter`, which
appends one self-contained JSON line per chunk to
``<run-dir>/heartbeat.jsonl`` and flushes it at once, so a run killed
at any point leaves a valid prefix (at worst one torn last line, which
:func:`read_heartbeat` skips). ``watch`` renders the file; ``triage``
and ``shrink`` replay a run from its run-start record's repro options.

Records (one JSON object per line):

- ``{"type": "run-start", "schema": 1, ...}``: the workload, horizon,
  chunk plan, resolved wire format and the repro ``opts``;
- ``{"type": "chunk", "chunk": k, "t0": t, "ticks": n, "wall-s": w,
  "net": {...}, "first-violation": {...}|null, "violations": [...],
  "events-overflowed": bool}``, plus ``fault`` (the plan's epoch over
  the chunk, ``faults.engine.span_summary``) on fault-plan runs or
  ``fault-fuzz`` (``faults.fuzz.span_counters``) on fuzz runs;
- ``{"type": "run-end", "status": "complete"|"stopped", ...}``: absent
  when the run died.

The scan (``pipeline.violation_scan``) is an int32 ``[K, 3]`` block,
row *i* = ``[n_violating, tick_i, instance_i]`` for the *i*-th earliest
tripper; every row repeats the fleet-wide count in lane 0, rows past
the tripper count pad with instance = -1, and tick is -1 (unknown) when
telemetry was off. A flat ``[3]`` vector decodes as K=1.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np

HEARTBEAT_FILE = "heartbeat.jsonl"
HEARTBEAT_SCHEMA = 1

# NetStats field order under the names of the results' "net" block
NET_LANES = ("sent", "delivered", "dropped-partition", "dropped-loss",
             "dropped-overflow")

SCAN_LANES = ("violating", "first-tick", "first-instance")

def stats_vec_to_net(vec) -> Dict[str, int]:
    """Decode one NetStats snapshot ([5] int32, field order)."""
    v = np.asarray(vec).reshape(-1)
    return {name: int(v[i]) for i, name in enumerate(NET_LANES)}


def _scan_rows(vec) -> np.ndarray:
    """Normalize a violation scan ([3] or [K, 3]) to [K, 3]."""
    return np.asarray(vec).reshape(-1, 3)


def scan_to_violation(vec) -> Optional[Dict[str, int]]:
    """The scan's first row (the earliest tripper); None when nothing
    tripped."""
    v = _scan_rows(vec)[0]
    if int(v[0]) <= 0:
        return None
    return {"instances": int(v[0]), "tick": int(v[1]),
            "instance": int(v[2])}


def scan_to_violations(vec) -> List[Dict[str, int]]:
    """All valid rows of a top-K scan as ``[{"instance": i, "tick": t},
    ...]`` (earliest first; empty when nothing tripped)."""
    rows = _scan_rows(vec)
    if int(rows[0, 0]) <= 0:
        return []
    return [{"instance": int(inst), "tick": int(tick)}
            for _, tick, inst in rows if int(inst) >= 0]


class HeartbeatWriter:
    """Appends heartbeat records to ``<run_dir>/heartbeat.jsonl``.

    Every record is written and flushed atomically-enough for a
    line-oriented reader: a crash mid-run leaves a valid prefix plus at
    most one torn final line. The writer tracks the first violation it
    sees so ``finish`` can summarize without re-reading the file."""

    def __init__(self, run_dir: str, meta: Optional[Dict[str, Any]] = None):
        self.path = os.path.join(run_dir, HEARTBEAT_FILE)
        self._f = open(self.path, "w")
        self._t0 = time.monotonic()
        self.chunks = 0
        self.ticks = 0
        self.first_violation: Optional[Dict[str, int]] = None
        self._write({"type": "run-start",
                     "schema": HEARTBEAT_SCHEMA, **(meta or {})})

    def _write(self, rec: Dict[str, Any]) -> None:
        self._f.write(json.dumps(rec, default=repr) + "\n")
        self._f.flush()

    def record_chunk(self, *, chunk: int, t0: int, ticks: int,
                     net: Optional[Dict[str, int]] = None,
                     violation: Optional[Dict[str, int]] = None,
                     violations: Optional[List[Dict[str, int]]] = None,
                     overflowed: bool = False,
                     extra: Optional[Dict[str, Any]] = None) -> None:
        rec: Dict[str, Any] = {
            "type": "chunk", "chunk": int(chunk), "t0": int(t0),
            "ticks": int(ticks),
            "wall-s": round(time.monotonic() - self._t0, 4),
        }
        if net is not None:
            rec["net"] = net
        rec["first-violation"] = violation
        if violation is not None and violations:
            # the top-K lanes; row 0 repeats first-violation
            rec["violations"] = violations
        rec["events-overflowed"] = bool(overflowed)
        if extra:
            rec.update(extra)
        if violation is not None and self.first_violation is None:
            self.first_violation = dict(violation, chunk=int(chunk))
        self.chunks = max(self.chunks + 1, int(chunk) + 1)
        self.ticks = max(self.ticks, int(t0) + int(ticks))
        self._write(rec)

    def finish(self, status: str = "complete",
               **fields: Any) -> None:
        """Write the run-end record and close. Safe to call twice."""
        if self._f.closed:
            return
        self._write({"type": "run-end", "status": status,
                     "chunks": self.chunks, "ticks": self.ticks,
                     "wall-s": round(time.monotonic() - self._t0, 4),
                     "first-violation": self.first_violation,
                     **fields})
        self._f.close()

    def close(self) -> None:
        """Close WITHOUT a run-end record (crash path: the missing
        run-end is the signal the run died)."""
        if not self._f.closed:
            self._f.close()


# --- reading / watching ----------------------------------------------------


def heartbeat_path(path: str) -> str:
    """Resolve a run dir (or direct file path) to its heartbeat file."""
    if os.path.isdir(path):
        return os.path.join(path, HEARTBEAT_FILE)
    return path


def read_heartbeat(path: str) -> Dict[str, Any]:
    """Parse a heartbeat file (or run dir) into ``{header, chunks, end,
    skipped}``. Tolerates a torn tail — a run killed mid-write leaves a
    valid prefix and this reader uses it. ``resume`` records (the JAX
    package's campaign seams) are read as it reads them."""
    path = heartbeat_path(path)
    header: Optional[Dict[str, Any]] = None
    chunks: List[Dict[str, Any]] = []
    resumes: List[Dict[str, Any]] = []
    end: Optional[Dict[str, Any]] = None
    skipped = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                skipped += 1
                continue
            t = rec.get("type")
            if t == "run-start":
                header = rec
            elif t == "chunk":
                chunks.append(rec)
            elif t == "resume":
                # a seam: the process died and campaign resume picked
                # the run back up from its checkpoint — chunk records
                # continue; any premature end record is superseded
                resumes.append(rec)
                end = None
            elif t == "run-end":
                end = rec
    return {"header": header, "chunks": chunks, "end": end,
            "resumes": resumes, "skipped": skipped}


def first_violation_of(hb: Dict[str, Any]) -> Optional[Dict[str, int]]:
    """Earliest-seen violation block of a parsed heartbeat (run-end
    summary when present, else the first chunk record carrying one)."""
    if hb.get("end") and hb["end"].get("first-violation"):
        return hb["end"]["first-violation"]
    for rec in hb.get("chunks", ()):
        if rec.get("first-violation"):
            return rec["first-violation"]
    return None


def flagged_instances(hb: Dict[str, Any]) -> List[int]:
    """Distinct violating instance ids the heartbeat named, in
    first-seen order — ALL top-K lanes of each chunk's scan (falling
    back to the lone ``first-violation`` row on pre-top-K heartbeats).
    The scan names at most K instances per chunk, so on a partial run
    this is a (correct but possibly incomplete) lower bound —
    results.json, when present, has the full list."""
    seen: List[int] = []
    for rec in hb.get("chunks", ()):
        lanes = rec.get("violations")
        if not lanes:
            v = rec.get("first-violation")
            lanes = [v] if v else []
        for v in lanes:
            if v and v.get("instance", -1) >= 0 \
                    and v["instance"] not in seen:
                seen.append(v["instance"])
    return seen


def render_chunk_line(rec: Dict[str, Any]) -> str:
    net = rec.get("net") or {}
    v = rec.get("first-violation")
    parts = [f"chunk {rec.get('chunk', '?'):>3}",
             f"t={rec.get('t0', '?')}..????"]
    if isinstance(rec.get("t0"), int) and isinstance(rec.get("ticks"),
                                                     int):
        parts[1] = f"t={rec['t0']}..{rec['t0'] + rec['ticks'] - 1}"
    if net:
        parts.append(f"sent {net.get('sent', 0)} "
                     f"delivered {net.get('delivered', 0)}")
    fault = rec.get("fault")
    if fault and not fault.get("healthy"):
        bits = []
        if fault.get("crashed"):
            bits.append("crash " + ",".join(
                str(n) for n in fault["crashed"]))
        if fault.get("degraded-edges"):
            bits.append(f"links {fault['degraded-edges']}")
        if fault.get("skewed-nodes"):
            bits.append(f"skew {fault['skewed-nodes']}")
        mem = fault.get("membership")
        if mem and (mem.get("joined") or mem.get("removed")):
            # joins/removals over the chunk's span: `membership +1/-2`
            bits.append("membership "
                        f"+{len(mem.get('joined') or [])}"
                        f"/-{len(mem.get('removed') or [])}")
        parts.append("fault[" + " ".join(bits) + "]")
    fz = rec.get("fault-fuzz")
    if fz:
        # randomized schedules: instances with a fault window in this
        # chunk, per lane
        bits = [f"{fz.get('schedules-active', 0)} active"]
        for lane in ("crash", "links", "skew", "membership"):
            if fz.get(lane):
                bits.append(f"{lane} {fz[lane]}")
        parts.append("fuzz[" + " ".join(bits) + "]")
    chk = rec.get("check")
    if chk:
        # the device verdict lanes: the fleet's flagged count this chunk,
        # `check[device flagged 3/100k]`
        of = chk.get("of", 0)
        of_s = (f"{of // 1000}k" if of >= 1000 and of % 1000 == 0
                else str(of))
        parts.append(f"check[{chk.get('mode', '?')} flagged "
                     f"{chk.get('flagged', 0)}/{of_s}]")
    parts.append("OVERFLOW" if rec.get("events-overflowed") else "")
    n_lanes = len(rec.get("violations") or ())
    more = f", +{n_lanes - 1} more named" if v and n_lanes > 1 else ""
    parts.append(f"viol {v['instances']} (first: instance "
                 f"{v['instance']} @ tick {v['tick']}{more})"
                 if v else "viol 0")
    if isinstance(rec.get("wall-s"), (int, float)):
        parts.append(f"{rec['wall-s']:.2f}s")
    return "  ".join(p for p in parts if p)


def render_watch_report(hb: Dict[str, Any], path: str = "",
                        mtime_age_s: Optional[float] = None) -> str:
    """The one-shot ``watch`` report of a parsed heartbeat."""
    lines: List[str] = []
    h = hb.get("header") or {}
    desc = h.get("workload", "?")
    lines.append(
        f"run: {desc} — {h.get('instances', '?')} instances x "
        f"{h.get('ticks', '?')} ticks, chunk {h.get('chunk-ticks', '?')}"
        + (f"  [{path}]" if path else ""))
    for rec in hb.get("chunks", ()):
        lines.append(render_chunk_line(rec))
    v = first_violation_of(hb)
    if v:
        tick = v.get("tick", -1)
        lines.append(
            f"first violation: instance {v.get('instance')}"
            + (f" at tick {tick}" if tick is not None and tick >= 0
               else " (tick unknown: telemetry off)")
            + f" — {v.get('instances', '?')} violating instance(s)")
    end = hb.get("end")
    if end:
        lines.append(f"status: {end.get('status', 'complete')} — "
                     f"{end.get('chunks', len(hb.get('chunks', [])))} "
                     f"chunks, {end.get('ticks', '?')} ticks in "
                     f"{end.get('wall-s', '?')}s"
                     + (f", valid? {end['valid?']}"
                        if "valid?" in end else ""))
    else:
        age = ("" if mtime_age_s is None
               else f" (last write {mtime_age_s:.0f}s ago)")
        lines.append(f"status: no run-end record — run still in "
                     f"progress or died{age}")
    if hb.get("resumes"):
        lines.append(f"({len(hb['resumes'])} resume seam(s) — the run "
                     f"was continued from a checkpoint)")
    if hb.get("skipped"):
        lines.append(f"({hb['skipped']} unparseable line(s) skipped — "
                     f"torn tail from an interrupted writer)")
    return "\n".join(lines)
