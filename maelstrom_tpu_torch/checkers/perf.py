"""Latency and throughput plots of a history for the store.

Copy of ``plot_perf`` (and its ``_quantiles``) from
``maelstrom_tpu/checkers/perf.py``: ``latency-raw.svg``,
``latency-quantiles.svg`` and ``rate.svg``, rendered from the first
recorded instance's history.
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
