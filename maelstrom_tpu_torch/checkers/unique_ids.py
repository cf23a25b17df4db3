"""Unique-ID checker: every acknowledged generate op must return a
globally distinct id. Parity: jepsen.checker/unique-ids, used by
workload/unique_ids.clj:72.

A copy of ``maelstrom_tpu/checkers/unique_ids.py``.
"""

from __future__ import annotations

from collections import Counter


def unique_ids_checker(history, f: str = "generate") -> dict:
    ids = [r["value"] for r in history
           if r["type"] == "ok" and r["f"] == f]
    counts = Counter(map(repr, ids))
    dups = {k: v for k, v in counts.items() if v > 1}
    return {
        "valid?": not dups,
        "attempted-count": sum(1 for r in history
                               if r["type"] == "invoke" and r["f"] == f),
        "acknowledged-count": len(ids),
        "duplicated-count": len(dups),
        "duplicated": dict(list(dups.items())[:32]),
        "range": ([min(ids, key=repr), max(ids, key=repr)] if ids else None),
    }
