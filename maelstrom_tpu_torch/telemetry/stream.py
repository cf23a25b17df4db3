"""Decoding of the device's violation scan.

Counterpart of the scan helpers of ``maelstrom_tpu/telemetry/stream.py``
(the heartbeat writer is not ported yet). The scan
(``pipeline.violation_scan``) is an int32 ``[K, 3]`` block, row *i* =
``[n_violating, tick_i, instance_i]`` for the *i*-th earliest tripper;
every row repeats the fleet-wide count in lane 0, rows past the tripper
count pad with instance = -1, and tick is -1 (unknown) when telemetry
was off. A flat ``[3]`` vector decodes as K=1.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

SCAN_LANES = ("violating", "first-tick", "first-instance")


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
