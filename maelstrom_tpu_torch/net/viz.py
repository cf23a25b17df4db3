"""Lamport spacetime diagrams: renders ``messages.svg`` from the network
journal — one vertical line per node, one arrow per delivered message,
labelled with the message body (minus envelope fields); client messages
blue, errors pink, server traffic black. Render is capped (default
10,000 events, one SVG row each — callers with long horizons pass a
tighter ``max_events``, e.g. ``maelstrom triage``) with an explicit
"+N elided" annotation, so the output stays a viewable file rather than
an unbounded SVG.

Copy of ``maelstrom_tpu/net/viz.py``.
"""

from __future__ import annotations

import json
from typing import Dict, List

from ..utils.ids import is_client, sort_ids
from ..utils.svg import _esc

MAX_EVENTS = 10_000
NODE_W = 160          # horizontal space per node
ROW_H = 22            # vertical space per event row
TOP = 60


def _label(body: dict) -> str:
    body = {k: v for k, v in body.items()
            if k not in ("type", "msg_id", "in_reply_to")}
    t = body.pop("__type", None)
    s = json.dumps(body, default=repr) if body else ""
    return s[:48]


def plot_lamport(journal, path: str, max_events: int = MAX_EVENTS):
    events = list(journal.events())
    total = len(events)
    cap = max(1, int(max_events))
    n_elided = max(0, total - cap)
    truncated = n_elided > 0
    events = events[:cap]

    # pair sends with recvs by message id (viz.clj:27-56)
    sends: Dict[int, int] = {}   # msg id -> event row of send
    rows = []                    # (row, type, node, msg, paired_send_row)
    nodes = set()
    for ev in events:
        m = ev["message"]
        nodes.add(m["src"])
        nodes.add(m["dest"])
    nodes = sort_ids(nodes)
    xcol = {n: i for i, n in enumerate(nodes)}

    row = 0
    arrows = []   # (send_row, recv_row, msg)
    dots = []     # (row, node, label_side_msg, etype)
    for ev in events:
        m = ev["message"]
        if ev["type"] == "send":
            sends[m["id"]] = row
            dots.append((row, m["src"], m, "send"))
        else:
            srow = sends.get(m["id"])
            dots.append((row, m["dest"], m, "recv"))
            if srow is not None:
                arrows.append((srow, row, m))
        row += 1

    width = max(len(nodes) * NODE_W + 80, 400)
    height = TOP + row * ROW_H + 60
    parts = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
             f'height="{height}" font-family="sans-serif">']
    parts.append(f'<rect width="{width}" height="{height}" fill="white"/>')

    def x(n):
        return 60 + xcol[n] * NODE_W

    def y(r):
        return TOP + r * ROW_H

    # node lifelines
    for n in nodes:
        parts.append(f'<line x1="{x(n)}" y1="{TOP-20}" x2="{x(n)}" '
                     f'y2="{height-30}" stroke="#ccc"/>')
        parts.append(f'<text x="{x(n)}" y="{TOP-30}" text-anchor="middle" '
                     f'font-size="13">{_esc(n)}</text>')

    parts.append('<defs><marker id="arr" markerWidth="10" markerHeight="8" '
                 'refX="9" refY="4" orient="auto">'
                 '<path d="M0,0 L10,4 L0,8 z" fill="#555"/></marker></defs>')

    for srow, rrow, m in arrows:
        color = ("#dd6688" if m["body"].get("type") == "error"
                 else "#6688dd" if (is_client(m["src"]) or
                                    is_client(m["dest"]))
                 else "#555555")
        x1, y1 = x(m["src"]), y(srow)
        x2, y2 = x(m["dest"]), y(rrow)
        parts.append(f'<line x1="{x1}" y1="{y1}" x2="{x2}" y2="{y2}" '
                     f'stroke="{color}" stroke-width="1" '
                     f'marker-end="url(#arr)"/>')
        mx, my = (x1 + x2) / 2, (y1 + y2) / 2 - 4
        t = m["body"].get("type", "")
        parts.append(f'<text x="{mx}" y="{my}" text-anchor="middle" '
                     f'font-size="9" fill="{color}">{_esc(t)} '
                     f'{_esc(_label(m["body"]))}</text>')

    for r, n, m, etype in dots:
        parts.append(f'<circle cx="{x(n)}" cy="{y(r)}" r="2.5" '
                     f'fill="#333"/>')

    if truncated:
        parts.append(f'<text x="10" y="{height-10}" font-size="12" '
                     f'fill="#aa0000">(truncated to first {len(events)} '
                     f'events, +{n_elided} elided)</text>')
    parts.append("</svg>")
    with open(path, "w") as f:
        f.write("\n".join(parts))
