"""Network statistics checker: message counts from the journal, split by
all/clients/servers, plus msgs-per-op (server messages per client
invocation) — the headline efficiency number in the broadcast guide —
and the network's drop counters (partition / loss / overflow), keyed
like the TPU runtime's netsim.NetStats so journal stats and device
fleet metrics agree on vocabulary.

Copy of ``maelstrom_tpu/checkers/net_stats.py``.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..gen.history import client_invokes


def net_stats_checker(journal, history,
                      drops: Optional[Dict[str, int]] = None) -> dict:
    """``journal`` is any object with a ``stats()`` split (the host
    Journal or a TpuJournal); ``drops`` is an optional drop-counter dict
    (host ``Net.drop_stats()`` or the device net block). msgs-per-op is
    0.0 — never null — when the history holds no client invokes, so
    downstream arithmetic on the number can't TypeError."""
    stats = journal.stats()
    ops = len(client_invokes(history))
    servers_msgs = stats["servers"]["msg-count"]
    out = {
        "valid?": True,
        "stats": stats,
        "msgs-per-op": (servers_msgs / ops) if ops else 0.0,
    }
    if drops is not None:
        out["drops"] = dict(drops)
    return out
