"""Results browser: the ``serve`` command's web UI.

Renders the store directory as browsable test results instead of a raw
listing — test runs grouped per workload, colored by verdict (blue =
valid, orange = unknown, pink = invalid — the color scheme of reference
doc/results.md:66-69), with per-run pages linking results.json,
histories, node logs, and rendered SVG artifacts inline.

A copy of ``maelstrom_tpu/serve.py``: it renders every layout the port
writes (process runs, ``<workload>-torch`` and ``<workload>-native``
runs, campaign directories with ``summary.json``) byte for byte as the
JAX package renders the same tree. Parity: reference ``serve``
(src/maelstrom/core.clj:273, backed by jepsen's web UI per
doc/results.md:7-9).
"""

from __future__ import annotations

import html
import http.server
import json
import os
from typing import Optional
from urllib.parse import unquote

STYLE = """
body { font-family: sans-serif; margin: 2em auto; max-width: 72em; }
a { text-decoration: none; }
table { border-collapse: collapse; }
td, th { padding: .3em .8em; text-align: left; }
tr:nth-child(even) { background: #f6f6f6; }
.valid { background: #cfe0f5; }
.unknown { background: #f5e0c0; }
.invalid { background: #f5c8d0; }
.badge { padding: .1em .5em; border-radius: .4em; font-size: .85em; }
pre { background: #f4f4f4; padding: 1em; overflow-x: auto; }
img { max-width: 100%; border: 1px solid #ddd; }
"""


def _verdict(run_dir: str) -> Optional[object]:
    # campaign dirs carry their verdict in the trend summary
    # (campaign/report.py); plain runs in results.json
    for name in ("results.json", "summary.json"):
        p = os.path.join(run_dir, name)
        if os.path.exists(p):
            try:
                with open(p) as f:
                    return json.load(f).get("valid?")
            except (OSError, json.JSONDecodeError):
                return None
    return None


def _cls(verdict) -> str:
    if verdict is True:
        return "valid"
    if verdict == "unknown":
        return "unknown"
    if verdict is False:
        return "invalid"
    return ""


def _page(title: str, body: str) -> bytes:
    return (f"<!doctype html><html><head><meta charset='utf-8'>"
            f"<title>{html.escape(title)}</title><style>{STYLE}</style>"
            f"</head><body><h1>{html.escape(title)}</h1>{body}"
            f"</body></html>").encode()


def _index(store: str) -> bytes:
    rows = []
    for wl in sorted(os.listdir(store)):
        wl_dir = os.path.join(store, wl)
        if not os.path.isdir(wl_dir):
            continue
        runs = sorted((r for r in os.listdir(wl_dir)
                       if r != "latest"
                       and os.path.isdir(os.path.join(wl_dir, r))),
                      reverse=True)
        for run in runs:
            v = _verdict(os.path.join(wl_dir, run))
            label = ("valid" if v is True else
                     "unknown" if v == "unknown" else
                     "invalid" if v is False else "?")
            rows.append(
                f"<tr class='{_cls(v)}'><td><a href='/{wl}/{run}/'>"
                f"{html.escape(wl)}</a></td>"
                f"<td><a href='/{wl}/{run}/'>{html.escape(run)}</a></td>"
                f"<td><span class='badge'>{label}</span></td></tr>")
    body = ("<table><tr><th>workload</th><th>run</th><th>valid?</th></tr>"
            + "".join(rows) + "</table>") if rows else "<p>No runs yet.</p>"
    return _page("maelstrom-tpu results", body)


def _device_phases_cell(t: dict) -> str:
    """Per-phase device ms/tick trend, hottest first, for one trend row
    (empty when the campaign ran unprofiled)."""
    devp = t.get("device-phases-mean")
    if not devp:
        return "-"
    return " ".join(f"{ph} {ms:.4f}" for ph, ms in
                    sorted(devp.items(), key=lambda kv: -kv[1]))


def _campaign_tables(d: str) -> str:
    """The trend-store view of a campaign dir: per-item rows + the
    per-workload trend aggregation from summary.json (written by
    ``maelstrom campaign report``)."""
    try:
        with open(os.path.join(d, "summary.json")) as f:
            s = json.load(f)
    except (OSError, json.JSONDecodeError):
        return ("<p>(no summary.json yet — run "
                "<code>maelstrom campaign report</code>)</p>")
    parts = ["<h2>Items</h2><table><tr><th>item</th><th>workload</th>"
             "<th>seed</th><th>status</th><th>valid?</th><th>viol</th>"
             "<th>msgs/s</th><th>ir bytes/tick</th><th>dev ms/tick</th>"
             "<th>resumed</th><th>run</th></tr>"]
    for r in s.get("items", ()):
        v = r.get("valid?")
        run_dir = r.get("run-dir") or ""
        # run dirs live in the same store the server roots at; link
        # relatively when they do
        store_root = os.path.realpath(os.path.dirname(
            os.path.dirname(d)))
        rel = (os.path.relpath(os.path.realpath(run_dir), store_root)
               if run_dir else "")
        link = (f"<a href='/{html.escape(rel)}/'>"
                f"{html.escape(os.path.basename(run_dir))}</a>"
                if run_dir and not rel.startswith("..") else "")
        parts.append(
            f"<tr class='{_cls(v)}'><td>{r.get('id')}</td>"
            f"<td>{html.escape(str(r.get('workload')))}</td>"
            f"<td>{r.get('seed')}</td><td>{r.get('status')}</td>"
            f"<td>{v}</td><td>{r.get('violating-instances') or 0}</td>"
            f"<td>{r.get('msgs-per-sec') or '-'}</td>"
            f"<td>{r.get('ir-bytes-est') or '-'}</td>"
            f"<td>{r.get('device-ms-per-tick') or '-'}</td>"
            f"<td>{'yes' if r.get('resumed') else '-'}</td>"
            f"<td>{link}</td></tr>")
    parts.append("</table><h2>Trends (per workload)</h2><table>"
                 "<tr><th>workload</th><th>runs</th><th>done</th>"
                 "<th>valid</th><th>invalid</th><th>failed</th>"
                 "<th>viol</th><th>msgs/s mean</th><th>msgs/s max</th>"
                 "<th>ir bytes/tick</th><th>dev ms/tick</th>"
                 "<th>device phases</th></tr>")
    for wl in sorted(s.get("trends", {})):
        t = s["trends"][wl]
        cls = ("valid" if t["invalid"] == 0 and t["failed"] == 0
               and t["done"] == t["runs"] else
               "invalid" if t["invalid"] or t["failed"] else "")
        parts.append(
            f"<tr class='{cls}'><td>{html.escape(wl)}</td>"
            f"<td>{t['runs']}</td><td>{t['done']}</td>"
            f"<td>{t['valid']}</td><td>{t['invalid']}</td>"
            f"<td>{t['failed']}</td><td>{t['violating-instances']}</td>"
            f"<td>{t['msgs-per-sec-mean']}</td>"
            f"<td>{t['msgs-per-sec-max']}</td>"
            f"<td>{t.get('ir-bytes-est') or '-'}</td>"
            f"<td>{t.get('device-ms-per-tick-mean') or '-'}</td>"
            f"<td>{html.escape(_device_phases_cell(t))}</td></tr>")
    parts.append("</table>")
    return "".join(parts)


def _run_page(store: str, wl: str, run: str) -> bytes:
    d = os.path.join(store, wl, run)
    v = _verdict(d)
    parts = [f"<p>verdict: <span class='badge {_cls(v)}'>{v}</span> "
             f"&middot; <a href='/'>&larr; all runs</a></p>"]
    if os.path.exists(os.path.join(d, "campaign.json")):
        parts.append(_campaign_tables(d))
    files = sorted(os.listdir(d))
    svgs = [f for f in files if f.endswith(".svg")]
    others = [f for f in files if not f.endswith(".svg")]
    if others:
        parts.append("<h2>Artifacts</h2><ul>")
        for f in others:
            parts.append(f"<li><a href='/{wl}/{run}/{f}'>"
                         f"{html.escape(f)}</a></li>")
        parts.append("</ul>")
    rp = os.path.join(d, "results.json")
    if os.path.exists(rp):
        with open(rp) as f:
            try:
                content = json.dumps(json.load(f), indent=2)[:20000]
            except json.JSONDecodeError:
                content = "(unreadable)"
        parts.append(f"<h2>results.json</h2><pre>"
                     f"{html.escape(content)}</pre>")
    for f in svgs:
        parts.append(f"<h2>{html.escape(f)}</h2>"
                     f"<img src='/{wl}/{run}/{f}'>")
    return _page(f"{wl} / {run}", "".join(parts))


class ResultsHandler(http.server.SimpleHTTPRequestHandler):
    """Routes: / -> index; /<wl>/<run>/ -> run page; deeper paths serve
    raw files from the store directory."""

    def do_GET(self):  # noqa: N802 (stdlib naming)
        store = self.directory
        path = unquote(self.path.split("?", 1)[0])
        parts = [p for p in path.split("/") if p]
        if any(p in ("..", ".") or os.sep in p for p in parts):
            self.send_error(404)   # no escaping the store directory
            return
        if not parts:
            return self._send(_index(store))
        if len(parts) == 2:
            d = os.path.join(store, *parts)
            if os.path.isdir(d):
                return self._send(_run_page(store, parts[0], parts[1]))
        return super().do_GET()

    def _send(self, payload: bytes):
        self.send_response(200)
        self.send_header("Content-Type", "text/html; charset=utf-8")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def log_message(self, *args):
        pass
