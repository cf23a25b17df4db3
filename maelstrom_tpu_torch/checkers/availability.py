"""Availability checker: what fraction of client invocations completed ok?

Copy of ``maelstrom_tpu/checkers/availability.py``. ``mode`` is None
(always valid), "total" (every op must be ok), or a float fraction.
"""

from __future__ import annotations


def availability_checker(history, mode=None) -> dict:
    invokes = ok = 0
    for r in history:
        if r.get("process") == "nemesis":
            continue
        if r["type"] == "invoke":
            invokes += 1
        elif r["type"] == "ok":
            ok += 1
    frac = (ok / invokes) if invokes else None
    if mode is None:
        valid = True
    elif mode == "total":
        valid = invokes == ok
    else:
        valid = frac is not None and frac >= float(mode)
    return {"valid?": valid, "ok-fraction": frac,
            "ok-count": ok, "count": invokes}
