"""Set checker: were acknowledged adds eventually visible in reads?

For a grow-only set workload (g-set, broadcast): ``add`` ops insert
elements, ``read`` ops return the full set. An acknowledged add is *lost* if
it is absent from every read that began after the add completed (and at
least one such read exists). An element is *stable* once it appears in every
subsequent read; *stable latency* is the delay from add-completion to the
start of stability. Indeterminate (info) adds may or may not appear; they are
never lost.

Parity: jepsen.checker/set-full as used by g_set.clj:62 and
broadcast.clj:216-228 (lost/stable/stale counts + stable-latency
quantiles).

A copy of ``maelstrom_tpu/checkers/set_full.py``.
"""

from __future__ import annotations

from typing import Dict, List

from .linearizable import pairs


def _quantiles(xs: List[float], qs=(0, 0.5, 0.95, 0.99, 1.0)):
    if not xs:
        return None
    xs = sorted(xs)
    return {str(q): xs[min(len(xs) - 1, int(q * len(xs)))] for q in qs}


def set_full_checker(history, add_f: str = "add", read_f: str = "read"
                     ) -> dict:
    adds_ok = []      # (element, completion-time)
    adds_info = []
    reads = []        # (invoke-time, completion-time, set(values))
    for p in pairs(history):
        inv, comp = p["invoke"], p["complete"]
        if inv.get("process") == "nemesis":
            continue
        if inv["f"] == add_f:
            if comp is None or comp["type"] == "info":
                adds_info.append(inv["value"])
            elif comp["type"] == "ok":
                adds_ok.append((inv["value"], comp["time"]))
        elif inv["f"] == read_f and comp is not None \
                and comp["type"] == "ok" and comp["value"] is not None:
            reads.append((inv["time"], comp["time"], set(comp["value"])))
    reads.sort(key=lambda r: r[0])

    lost, stable, stale = [], [], []
    stable_latencies = []
    never_read = []
    for element, t_add in adds_ok:
        later = [r for r in reads if r[0] >= t_add]
        if not later:
            never_read.append(element)
            continue
        present = [element in r[2] for r in later]
        if not present[-1]:
            # absent from the most recent read: either never seen (plain
            # lost) or seen and then permanently vanished (also lost)
            lost.append(element)
            continue
        # start of the trailing run of reads that all contain the element
        stable_from = len(later) - 1
        while stable_from > 0 and present[stable_from - 1]:
            stable_from -= 1
        stable.append(element)
        stable_latencies.append((later[stable_from][0] - t_add) / 1e6)
        if stable_from > 0:
            stale.append(element)   # was missing from some earlier read
    valid = not lost
    return {
        "valid?": valid if reads else "unknown",
        "attempt-count": len(adds_ok) + len(adds_info),
        "acknowledged-count": len(adds_ok),
        "read-count": len(reads),
        "lost-count": len(lost),
        "lost": sorted(lost, key=repr)[:32],
        "stable-count": len(stable),
        "stale-count": len(stale),
        "never-read-count": len(never_read),
        "stable-latencies-ms": _quantiles(stable_latencies),
    }
