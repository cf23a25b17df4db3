"""timeline.html: a per-process visual timeline of operations, colored by
outcome, with hover details.

Copy of ``maelstrom_tpu/checkers/timeline.py``."""

from __future__ import annotations

import html
from collections import defaultdict

from ..gen.history import pairs

_COLOR = {"ok": "#a2d9a2", "fail": "#f6a4a4", "info": "#f5d58a"}

ROW_H = 18
PX_PER_S = 120.0


def render_timeline(history, path: str):
    procs = []
    ops_by_proc = defaultdict(list)
    t_max = 1.0
    for p in pairs(history):
        inv, comp = p["invoke"], p["complete"]
        proc = inv.get("process")
        # histories assembled outside the runner (nemesis-only records,
        # hand-written fixtures, external EDN imports) may lack time
        # fields — skip untimed invokes instead of raising KeyError,
        # and draw an untimed completion as instantaneous
        if inv.get("time") is None:
            continue
        if proc not in ops_by_proc:
            procs.append(proc)
        t0 = inv["time"] / 1e9
        t1 = (comp["time"] / 1e9) if comp and comp.get("time") is not None \
            else t0 + 0.01
        outcome = comp["type"] if comp else "info"
        ops_by_proc[proc].append((t0, t1, outcome, inv, comp))
        t_max = max(t_max, t1)

    rows = []
    for i, proc in enumerate(procs):
        # lanes and ops are both absolutely positioned at i * ROW_H so
        # bars always sit inside their own process row
        rows.append(
            f'<div class="lane" style="top:{i * ROW_H}px">'
            f'<span class="proc">{html.escape(str(proc))}</span></div>')
        for (t0, t1, outcome, inv, comp) in ops_by_proc[proc]:
            left = t0 * PX_PER_S
            width = max((t1 - t0) * PX_PER_S, 2)
            title = (f"{inv.get('f')} {inv.get('value')!r} -> "
                     f"{outcome}"
                     + (f" {comp.get('value')!r}" if comp else ""))
            rows.append(
                f'<div class="op" style="top:{i * ROW_H + 2}px;'
                f'left:{left + 80:.1f}px;width:{width:.1f}px;'
                f'background:{_COLOR.get(outcome, "#ccc")}" '
                f'title="{html.escape(title)}"></div>')

    doc = f"""<!doctype html>
<html><head><meta charset="utf-8"><title>timeline</title><style>
body {{ font-family: sans-serif; margin: 0; }}
.wrap {{ position: relative; height: {len(procs) * ROW_H + 40}px;
         width: {t_max * PX_PER_S + 160:.0f}px; }}
.lane {{ position: absolute; left: 0; right: 0; height: {ROW_H}px;
         box-sizing: border-box; border-bottom: 1px solid #eee; }}
.proc {{ font-size: 11px; color: #666; padding-left: 4px; }}
.op {{ position: absolute; height: {ROW_H - 4}px; border-radius: 2px;
       box-sizing: border-box; border: 1px solid rgba(0,0,0,0.2); }}
h1 {{ font-size: 14px; padding: 4px 8px; margin: 0; }}
</style></head><body>
<h1>operation timeline (hover for details)</h1>
<div class="wrap">
{chr(10).join(rows)}
</div></body></html>"""
    with open(path, "w") as f:
        f.write(doc)
