"""Operation-history helpers: the condensed text form and invoke /
completion pairing.

Copy of ``write_txt``, ``client_invokes`` and ``pairs`` from ``maelstrom_tpu/gen/history.py``.
A history is an ordered list of Jepsen-shaped records (``index``,
``time`` in ns, ``process``, ``type`` invoke / ok / fail / info, ``f``,
``value``).
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional


def write_txt(records: Iterable[dict], path: str) -> None:
    """Condensed human-readable history (``history-<i>.txt``): columns
    process, type, f, value, error."""
    rows = []
    for r in records:
        val = r.get("value")
        rows.append((str(r.get("process", "")),
                     str(r.get("type", "")),
                     str(r.get("f", "")),
                     "" if val is None else json.dumps(val),
                     str(r.get("error", "") or "")))
    widths = [max((len(row[c]) for row in rows), default=0)
              for c in range(4)]
    with open(path, "w") as f:
        for row in rows:
            line = "  ".join(row[c].ljust(widths[c]) for c in range(4))
            if row[4]:
                line += "  " + row[4]
            f.write(line.rstrip() + "\n")


def client_invokes(history) -> List[dict]:
    return [r for r in history
            if r["type"] == "invoke" and r.get("process") != "nemesis"]


def pairs(history) -> List[Dict[str, Optional[dict]]]:
    """Match invokes with their completions per process. An invoke with no
    completion (still pending at test end) pairs with None."""
    open_ops: Dict = {}
    out = []
    for r in history:
        p = r.get("process")
        if r["type"] == "invoke":
            entry = {"invoke": r, "complete": None}
            open_ops[p] = entry
            out.append(entry)
        elif r["type"] in ("ok", "fail", "info") and p in open_ops:
            open_ops.pop(p)["complete"] = r
    return out
