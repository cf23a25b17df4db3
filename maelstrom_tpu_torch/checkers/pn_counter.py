"""PN-counter checker: interval arithmetic over possible counter values.

The true final value must equal the sum of all *definitely applied* adds
plus any subset of *possibly applied* (indeterminate) adds. We track the set
of attainable values as a sorted list of disjoint closed integer ranges
(merging adjacent ranges, like a Guava TreeRangeSet): starting from
``[sum(definite), sum(definite)]``, each indeterminate delta ``d`` maps the
range set ``R`` to ``R ∪ (R + d)``. Every final read must land inside the
resulting set.

Parity: reference src/maelstrom/workload/pn_counter.clj:79-125.

A copy of ``maelstrom_tpu/checkers/pn_counter.py``.
"""

from __future__ import annotations

from typing import List, Tuple

from .linearizable import pairs

# blow-up guard: beyond this many disjoint ranges, collapse to the convex
# hull (sound: may accept a value the precise set would reject, never rejects
# a valid history)
MAX_RANGES = 100_000


def _merge(ranges: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    if not ranges:
        return []
    ranges.sort()
    out = [ranges[0]]
    for lo, hi in ranges[1:]:
        plo, phi = out[-1]
        if lo <= phi + 1:
            out[-1] = (plo, max(phi, hi))
        else:
            out.append((lo, hi))
    return out


def _add_delta(ranges: List[Tuple[int, int]], d: int
               ) -> List[Tuple[int, int]]:
    shifted = [(lo + d, hi + d) for lo, hi in ranges]
    merged = _merge(ranges + shifted)
    if len(merged) > MAX_RANGES:
        return [(merged[0][0], merged[-1][1])]
    return merged


def _contains(ranges: List[Tuple[int, int]], v: int) -> bool:
    import bisect
    i = bisect.bisect_right(ranges, (v, float("inf"))) - 1
    return i >= 0 and ranges[i][0] <= v <= ranges[i][1]


def pn_counter_checker(history) -> dict:
    definite_sum = 0
    indeterminate: List[int] = []
    final_reads = {}        # process -> last ok read tagged final
    fallback_reads = {}     # process -> last ok read (untagged histories)
    for p in pairs(history):
        inv, comp = p["invoke"], p["complete"]
        if inv.get("process") == "nemesis":
            continue
        if inv["f"] == "add":
            if comp is not None and comp["type"] == "ok":
                definite_sum += inv["value"]
            elif comp is None or comp["type"] == "info":
                indeterminate.append(inv["value"])
        elif inv["f"] == "read" and comp is not None \
                and comp["type"] == "ok":
            if inv.get("final"):
                final_reads[inv["process"]] = comp["value"]
            fallback_reads[inv["process"]] = comp["value"]
    # only reads from the final (post-heal, quiesced) phase are judged; a
    # history with no tagged reads falls back to last-read-per-process
    if not final_reads:
        final_reads = fallback_reads
    ranges = [(definite_sum, definite_sum)]
    for d in indeterminate:
        if d:
            ranges = _add_delta(ranges, d)
    errors = {p: v for p, v in final_reads.items()
              if not isinstance(v, int) or not _contains(ranges, v)}
    return {
        "valid?": (not errors) if final_reads else "unknown",
        "errors": errors,
        "final-reads": list(final_reads.values()),
        "acceptable": [list(r) for r in ranges[:64]],
        "acceptable-range-count": len(ranges),
        "definite-sum": definite_sum,
        "indeterminate-count": len(indeterminate),
    }
