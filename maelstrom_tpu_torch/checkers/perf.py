"""Performance and stats checkers over a history, and its plots.

Copy of ``maelstrom_tpu/checkers/perf.py``: ``stats_checker`` (jepsen's
checker/stats: ok/fail/info counts overall and per ``:f``, valid iff
every ``:f`` has an ok), ``perf_checker`` (latency quantiles and
throughput), and ``plot_perf`` (``latency-raw.svg``,
``latency-quantiles.svg`` and ``rate.svg``, rendered from the first
recorded instance's history).
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List

from ..gen.history import pairs
from ..utils import svg


def _quantiles(xs: List[float], qs=(0.5, 0.95, 0.99, 1.0)) -> Dict[str, float]:
    if not xs:
        return {}
    xs = sorted(xs)
    out = {}
    for q in qs:
        i = min(len(xs) - 1, int(q * len(xs)))
        out[str(q)] = xs[i]
    return out


_TYPE_COLOR = {"ok": "#33aa33", "fail": "#dd2222", "info": "#ff9900"}


def stats_checker(history) -> dict:
    counts = defaultdict(lambda: defaultdict(int))
    totals = defaultdict(int)
    for r in history:
        if r.get("process") == "nemesis":
            continue
        t = r["type"]
        if t in ("ok", "fail", "info", "invoke"):
            counts[r["f"]][t] += 1
            totals[t] += 1
    by_f = {}
    for f, c in counts.items():
        # crash ops never complete ok by design (crash-client mode);
        # exempt them, like the reference's kafka stats-checker wrapper
        # (jepsen.tests.kafka stats-checker over kafka.clj:296)
        by_f[f] = {"count": c["invoke"], "ok-count": c["ok"],
                   "fail-count": c["fail"], "info-count": c["info"],
                   "valid?": (c["ok"] > 0) or f == "crash"}
    return {"valid?": all(v["valid?"] for v in by_f.values()) if by_f
            else True,
            "count": totals["invoke"], "ok-count": totals["ok"],
            "fail-count": totals["fail"], "info-count": totals["info"],
            "by-f": by_f}


def perf_checker(history) -> dict:
    lat_by_f = defaultdict(list)
    all_lat = []
    t_min, t_max = None, None
    ok_count = 0
    for p in pairs(history):
        inv, comp = p["invoke"], p["complete"]
        if inv.get("process") == "nemesis":
            continue
        t = inv["time"]
        t_min = t if t_min is None else min(t_min, t)
        t_max = t if t_max is None else max(t_max, t)
        if comp is None:
            continue
        lat_ms = (comp["time"] - inv["time"]) / 1e6
        lat_by_f[inv["f"]].append(lat_ms)
        all_lat.append(lat_ms)
        if comp["type"] == "ok":
            ok_count += 1
    duration_s = ((t_max - t_min) / 1e9) if (t_min is not None
                                             and t_max > t_min) else 0.0
    return {
        "valid?": True,
        "latency-ms": _quantiles(all_lat),
        "latency-ms-by-f": {f: _quantiles(v) for f, v in lat_by_f.items()},
        "duration-s": duration_s,
        "ok-throughput-ops-per-s": (ok_count / duration_s
                                    if duration_s > 0 else 0.0),
    }


_TYPE_COLOR = {"ok": "#33aa33", "fail": "#dd2222", "info": "#ff9900"}


def plot_perf(history, store_dir: str):
    """latency-raw.svg (scatter of per-op latency over time, colored by
    outcome, log y) and rate.svg (ops/sec over 1s windows, per :f)."""
    points_by_type = defaultdict(list)
    rate_counts = defaultdict(lambda: defaultdict(int))  # f -> sec -> n
    for p in pairs(history):
        inv, comp = p["invoke"], p["complete"]
        if inv.get("process") == "nemesis" or comp is None:
            continue
        t_s = inv["time"] / 1e9
        lat_ms = max((comp["time"] - inv["time"]) / 1e6, 1e-3)
        points_by_type[comp["type"]].append((t_s, lat_ms))
        rate_counts[inv["f"]][int(t_s)] += 1
    series = [svg.Series(name=t, points=pts, color=_TYPE_COLOR.get(t, "#888"))
              for t, pts in sorted(points_by_type.items())]
    svg.scatter_plot(series, title="latency (ms)", xlabel="time (s)",
                     ylabel="latency (ms)", log_y=True,
                     path=os.path.join(store_dir, "latency-raw.svg"))

    # latency-quantiles.svg: p50/p95/p99/max per 1s window over all
    # completed ops (the reference's latency-quantiles.png); windows
    # with no completed ops break the polyline instead of interpolating
    lat_by_sec = defaultdict(list)
    for pts in points_by_type.values():
        for t_s, lat_ms in pts:
            lat_by_sec[int(t_s)].append(lat_ms)
    window_qs = {sec: _quantiles(xs) for sec, xs in lat_by_sec.items()}
    q_styles = [("0.5", "p50", "#4477aa"), ("0.95", "p95", "#228833"),
                ("0.99", "p99", "#ff9900"), ("1.0", "max", "#dd2222")]
    q_series = []
    secs = sorted(lat_by_sec)
    for q_key, label, color in q_styles:
        pts, prev = [], None
        for sec in secs:
            if prev is not None and sec != prev + 1:
                pts.append(None)
            pts.append((sec + 0.5, window_qs[sec][q_key]))
            prev = sec
        if pts:
            q_series.append(svg.Series(name=label, points=pts,
                                       color=color))
    svg.line_plot(q_series, title="latency quantiles (ms)",
                  xlabel="time (s)", ylabel="latency (ms)", log_y=True,
                  path=os.path.join(store_dir, "latency-quantiles.svg"))
    palette = ["#4477aa", "#ee6677", "#228833", "#ccbb44", "#66ccee",
               "#aa3377"]
    rate_series = []
    for i, (f, buckets) in enumerate(sorted(rate_counts.items())):
        if not buckets:
            continue
        lo, hi = min(buckets), max(buckets)
        pts = [(s + 0.5, buckets.get(s, 0)) for s in range(lo, hi + 1)]
        rate_series.append(svg.Series(name=f, points=pts,
                                      color=palette[i % len(palette)]))
    svg.line_plot(rate_series, title="throughput (ops/s)",
                  xlabel="time (s)", ylabel="ops/s",
                  path=os.path.join(store_dir, "rate.svg"))
