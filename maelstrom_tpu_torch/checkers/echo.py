"""Echo checker: every ok echo must return the payload it sent.

A copy of ``echo_checker`` in ``maelstrom_tpu/workloads/echo.py``.
Parity: reference src/maelstrom/workload/echo.clj:44-63.
"""

from __future__ import annotations


def echo_checker(history, opts=None) -> dict:
    bad = [r for r in history
           if r["type"] == "ok" and r["f"] == "echo"
           and r.get("echo") != r["value"]]
    return {"valid?": not bad, "errors": bad[:16],
            "ok-count": sum(1 for r in history
                            if r["type"] == "ok" and r["f"] == "echo")}
