"""Per-message journal of the device's instances.

Copy of ``maelstrom_tpu/tpu/journal.py``. The tick returns the sent rows
and delivered inboxes of the first ``journal_instances`` instances
(``runtime.TickOutputs``); :class:`TpuJournal` decodes one instance's
traffic into ``events()`` for the Lamport ``messages.svg``
(``net/viz.py``) and ``stats()`` for the net-stats checker.

Send/recv pairing keys on the runtime-stamped trailing NETID lane;
journaling runs always carry it (``make_sim_config`` refuses journaling
without it).
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np

from . import wire
from .utils.ids import is_client


def _node_name(idx: int, n_nodes: int) -> str:
    return f"n{idx}" if idx < n_nodes else f"c{idx - n_nodes}"


class TpuJournal:
    """Decoded message journal of one journaled instance.

    ``sends``: [T, J, M, L]; ``recvs``: [T, J, NT, K, L] (numpy int32).
    """

    def __init__(self, model, cfg, sends: np.ndarray, recvs: np.ndarray,
                 instance: int = 0, ms_per_tick: float = 1.0):
        self.model = model
        self.cfg = cfg
        self.ms_per_tick = ms_per_tick
        self._events: List[dict] = []
        n = cfg.n_nodes
        T = sends.shape[0]
        for t in range(T):
            # recvs first: anything delivered at t was sent at an earlier
            # tick, so its send event is already out
            for row in recvs[t, instance].reshape(-1, recvs.shape[-1]):
                if row[wire.VALID] == 1:
                    self._events.append(self._event("recv", t, row))
            for row in sends[t, instance]:
                if row[wire.VALID] == 1:
                    self._events.append(self._event("send", t, row))

    def _event(self, etype: str, t: int, row: np.ndarray) -> dict:
        n = self.cfg.n_nodes
        body_vals = [int(x) for x in
                     row[wire.BODY:wire.BODY + self.cfg.body_lanes]]
        body = {"type": int(row[wire.TYPE])}
        if row[wire.MSGID] >= 0:
            body["msg_id"] = int(row[wire.MSGID])
        if row[wire.REPLYTO] >= 0:
            body["in_reply_to"] = int(row[wire.REPLYTO])
        # trim trailing zero lanes for a readable label
        while body_vals and body_vals[-1] == 0:
            body_vals.pop()
        if body_vals:
            body["b"] = body_vals
        return {
            "time": int(t * self.ms_per_tick * 1_000_000),
            "type": etype,
            "message": {
                # journaled runs always carry the trailing NETID lane
                # (make_sim_config refuses journaling without it)
                "id": int(row[self.cfg.netid_lane]),
                "src": _node_name(int(row[wire.SRC]), n),
                "dest": _node_name(int(row[wire.DEST]), n),
                "body": body,
            },
        }

    def events(self) -> Iterator[dict]:
        return iter(self._events)

    def stats(self) -> Dict[str, Dict[str, int]]:
        counts = {k: {"send-count": 0, "recv-count": 0, "msg-count": 0}
                  for k in ("all", "clients", "servers")}
        ids = {"all": set(), "clients": set(), "servers": set()}
        for ev in self._events:
            m = ev["message"]
            cls = ("clients" if is_client(m["src"]) or is_client(m["dest"])
                   else "servers")
            key = "send-count" if ev["type"] == "send" else "recv-count"
            counts["all"][key] += 1
            counts[cls][key] += 1
            ids["all"].add(m["id"])
            ids[cls].add(m["id"])
        for k in counts:
            counts[k]["msg-count"] = len(ids[k])
        return counts
