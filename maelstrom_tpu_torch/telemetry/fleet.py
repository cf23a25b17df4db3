"""Host-side fleet aggregation: reduce the flight recorder across the
instance axis into fleet metrics, and write ``fleet-metrics.json`` and
the SVG dashboards.

Copy of ``fleet_summary``, ``write_fleet_metrics``, ``write_fleet_svgs``
and their helpers from ``maelstrom_tpu/telemetry/fleet.py``, reading the
port's recorder lanes. Everything here is numpy and JSON on the
telemetry already copied to the host. Quantiles come from the device's
log-bucket histograms: a quantile is reported as the (inclusive) upper
bound in ticks of the bucket holding that order statistic, with
``checkers.perf._quantiles``'s order-statistic convention.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from .recorder import SERIES_NAMES

FLEET_METRICS_FILE = "fleet-metrics.json"
SCHEMA_VERSION = 1

QUANTILES = (0.5, 0.95, 0.99, 1.0)


def bucket_upper_ticks(hist_buckets: int) -> List[int]:
    """Inclusive upper bound in ticks of each log2 latency bucket
    (bucket k spans [2^k - 1, 2^(k+1) - 2]; the last bucket is
    open-ended but reported at its nominal bound)."""
    return [2 ** (k + 1) - 2 for k in range(hist_buckets)]


def hist_quantile(counts: np.ndarray, q: float) -> Optional[int]:
    """Bucket index of the q-th order statistic of a histogram, using
    perf._quantiles' convention (``i = min(n - 1, int(q * n))``).
    Returns None on an empty histogram."""
    counts = np.asarray(counts, dtype=np.int64)
    n = int(counts.sum())
    if n == 0:
        return None
    i = min(n - 1, int(q * n))
    return int(np.searchsorted(np.cumsum(counts), i, side="right"))


def _rate(num: int, den: int) -> float:
    return (num / den) if den else 0.0


def _imax(a) -> int:
    """max of a possibly-empty int leaf (0 on empty: some run buffers
    can be zero-size; reductions must degrade, not raise)."""
    a = np.asarray(a)
    return int(a.max()) if a.size else 0


def _fmean(a) -> float:
    a = np.asarray(a)
    return float(a.mean()) if a.size else 0.0


def fleet_summary(tel, sim, ms_per_tick: float = 1.0) -> Dict:
    """Reduce one run's Telemetry pytree into the fleet-metrics dict
    (the exact content of ``fleet-metrics.json``)."""
    tcfg = sim.telemetry
    get = lambda x: np.asarray(x)
    per_i = {name: get(getattr(tel, name)) for name in
             ("sent", "delivered", "delivered_servers",
              "dropped_partition", "dropped_loss", "dropped_overflow",
              "invokes", "acks")}
    totals = {name.replace("_", "-"): int(v.sum())
              for name, v in per_i.items()}
    hist = get(tel.rpc_hist)                       # [I, B]
    fleet_hist = hist.sum(axis=0)
    uppers = bucket_upper_ticks(tcfg.hist_buckets)
    quantiles = {}
    for q in QUANTILES:
        b = hist_quantile(fleet_hist, q)
        quantiles[str(q)] = None if b is None else uppers[b]

    first_viol = get(tel.first_violation)
    tripped = first_viol[first_viol >= 0]
    series = get(tel.series)                       # [NW, SERIES_LANES]
    n_windows = series.shape[0]
    stride = tcfg.stride
    window_ticks = [min(stride, max(0, sim.n_ticks - w * stride))
                    for w in range(n_windows)]
    # the final window also absorbs any tail past n_windows * stride
    # (record_tick clips the window index), so credit it those ticks
    if sim.n_ticks > n_windows * stride:
        window_ticks[-1] += sim.n_ticks - n_windows * stride

    inst = {}
    for name in ("delivered", "invokes", "acks"):
        v = per_i[name]
        inst[name] = {"min": int(v.min()), "max": int(v.max()),
                      "mean": float(v.mean())} if v.size else {}
    return {
        "schema": SCHEMA_VERSION,
        "instances": int(sim.n_instances),
        "ticks": int(sim.n_ticks),
        "ms-per-tick": float(ms_per_tick),
        "totals": totals,
        "rates": {
            "delivery": _rate(totals["delivered"], totals["sent"]),
            "drop-partition": _rate(totals["dropped-partition"],
                                    totals["sent"]),
            "drop-loss": _rate(totals["dropped-loss"], totals["sent"]),
            "drop-overflow": _rate(totals["dropped-overflow"],
                                   totals["sent"]),
        },
        # delivered server<->server messages per client invocation — the
        # device-side counterpart of net_stats_checker's msgs-per-op
        # (which counts unique journaled server messages; delivered-only
        # here). 0.0, never null, when there were no invokes.
        "msgs-per-op": _rate(totals["delivered-servers"],
                             totals["invokes"]),
        "acks-per-invoke": _rate(totals["acks"], totals["invokes"]),
        "latency-ticks": quantiles,
        "latency-hist": {
            "bucket-upper-ticks": uppers,
            "fleet-counts": [int(c) for c in fleet_hist],
        },
        "high-water": {
            "inbox-deliveries-per-tick": _imax(tel.inbox_hwm),
            "pool-occupancy": _imax(tel.pool_hwm),
            "pool-slots": int(sim.net.pool_slots),
        },
        "nemesis": {
            "epochs-max": _imax(tel.nemesis_epochs),
            "partition-ticks-mean": _fmean(tel.partition_ticks),
        },
        "invariants": {
            "tripped-instances": int(tripped.size),
            "first-violation-tick-min": (int(tripped.min())
                                         if tripped.size else None),
        },
        "per-instance": inst,
        "series": {
            "stride-ticks": int(stride),
            "window-ticks": window_ticks,
            "lanes": list(SERIES_NAMES),
            "windows": [[int(x) for x in row] for row in series],
        },
    }


# --- artifacts ------------------------------------------------------------

def write_fleet_metrics(metrics: Dict, store_dir: str) -> str:
    path = os.path.join(store_dir, FLEET_METRICS_FILE)
    with open(path, "w") as f:
        json.dump(metrics, f, indent=2)
    return path


def write_fleet_svgs(metrics: Dict, store_dir: str) -> List[str]:
    """Render the rate / drop / latency dashboards from a fleet-metrics
    dict."""
    from ..utils import svg

    ser = metrics["series"]
    stride = ser["stride-ticks"]
    wticks = ser["window-ticks"]
    lanes = {n: i for i, n in enumerate(ser["lanes"])}
    windows = ser["windows"]
    ms_per_tick = metrics.get("ms-per-tick", 1.0)

    def mid_s(w):
        return (w * stride + wticks[w] / 2.0) * ms_per_tick / 1000.0

    def per_sec(lane):
        pts = []
        for w, row in enumerate(windows):
            secs = wticks[w] * ms_per_tick / 1000.0
            if secs <= 0:
                continue
            pts.append((mid_s(w), row[lanes[lane]] / secs))
        return pts

    out = []
    palette = {"delivered": "#4477aa", "sent": "#66ccee",
               "invokes": "#228833", "acks": "#ccbb44",
               "dropped-partition": "#dd2222", "dropped-loss": "#ff9900",
               "dropped-overflow": "#aa3377"}
    rate_series = [svg.Series(name=n, points=per_sec(n),
                              color=palette[n])
                   for n in ("delivered", "sent", "invokes", "acks")]
    p = os.path.join(store_dir, "fleet-rate.svg")
    svg.line_plot(rate_series, title="fleet message/op rates",
                  xlabel="sim time (s)", ylabel="per second", path=p)
    out.append(p)

    drop_series = [svg.Series(name=n, points=per_sec(n),
                              color=palette[n])
                   for n in ("dropped-partition", "dropped-loss",
                             "dropped-overflow")]
    p = os.path.join(store_dir, "fleet-drops.svg")
    svg.line_plot(drop_series, title="fleet drops",
                  xlabel="sim time (s)", ylabel="drops/s", path=p)
    out.append(p)

    h = metrics["latency-hist"]
    pts = [(u, c) for u, c in zip(h["bucket-upper-ticks"],
                                  h["fleet-counts"])]
    p = os.path.join(store_dir, "fleet-latency.svg")
    svg.line_plot([svg.Series(name="ok completions", points=pts,
                              color="#4477aa")],
                  title="ticks-to-ack histogram (log2 buckets)",
                  xlabel="latency bucket upper bound (ticks)",
                  ylabel="completions", path=p)
    out.append(p)
    return out
