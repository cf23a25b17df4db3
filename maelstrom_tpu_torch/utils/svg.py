"""Dependency-free SVG plotting for the store artifacts.

Copy of ``maelstrom_tpu/utils/svg.py``: scatter and line plots with
linear or log axes, so the port's store files are byte-equal to the
JAX harness's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple


@dataclass
class Series:
    name: str
    points: List[Tuple[float, float]]
    color: str = "#4477aa"


W, H = 900, 420
ML, MR, MT, MB = 70, 160, 40, 50  # margins


def _esc(s: str) -> str:
    return (str(s).replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;").replace('"', "&quot;"))


def _ticks(lo: float, hi: float, n: int = 6) -> List[float]:
    if hi <= lo:
        hi = lo + 1
    span = hi - lo
    step = 10 ** math.floor(math.log10(span / max(n, 1)))
    for mult in (1, 2, 5, 10):
        if span / (step * mult) <= n:
            step *= mult
            break
    t0 = math.ceil(lo / step) * step
    out = []
    t = t0
    while t <= hi + 1e-9:
        out.append(round(t, 10))
        t += step
    return out


def _log_ticks(lo: float, hi: float) -> List[float]:
    lo = max(lo, 1e-9)
    out = []
    e = math.floor(math.log10(lo))
    while 10 ** e <= hi * 1.001:
        if 10 ** e >= lo * 0.999:
            out.append(10 ** e)
        e += 1
    return out or [lo, hi]


class _Frame:
    def __init__(self, xlo, xhi, ylo, yhi, log_y=False):
        self.xlo, self.xhi = xlo, max(xhi, xlo + 1e-9)
        self.log_y = log_y
        if log_y:
            self.ylo, self.yhi = math.log10(max(ylo, 1e-9)), \
                math.log10(max(yhi, ylo * 10, 1e-8))
        else:
            self.ylo, self.yhi = ylo, max(yhi, ylo + 1e-9)

    def x(self, v):
        return ML + (v - self.xlo) / (self.xhi - self.xlo) * (W - ML - MR)

    def y(self, v):
        if self.log_y:
            v = math.log10(max(v, 1e-9))
        return H - MB - (v - self.ylo) / (self.yhi - self.ylo) * (H - MT - MB)


def _axes(parts, fr: _Frame, title, xlabel, ylabel, log_y):
    parts.append(f'<rect x="0" y="0" width="{W}" height="{H}" fill="white"/>')
    parts.append(f'<text x="{W/2}" y="20" text-anchor="middle" '
                 f'font-size="15" font-family="sans-serif">{_esc(title)}'
                 f'</text>')
    # frame
    parts.append(f'<rect x="{ML}" y="{MT}" width="{W-ML-MR}" '
                 f'height="{H-MT-MB}" fill="none" stroke="#999"/>')
    xticks = _ticks(fr.xlo, fr.xhi)
    if log_y:
        raw = _log_ticks(10 ** fr.ylo, 10 ** fr.yhi)
        yticks = [(t, fr.y(t)) for t in raw]
    else:
        yticks = [(t, fr.y(t)) for t in _ticks(fr.ylo, fr.yhi)]
    for t in xticks:
        x = fr.x(t)
        parts.append(f'<line x1="{x:.1f}" y1="{H-MB}" x2="{x:.1f}" '
                     f'y2="{H-MB+5}" stroke="#333"/>')
        parts.append(f'<text x="{x:.1f}" y="{H-MB+18}" text-anchor="middle" '
                     f'font-size="11" font-family="sans-serif">{t:g}</text>')
    for t, y in yticks:
        parts.append(f'<line x1="{ML-5}" y1="{y:.1f}" x2="{ML}" '
                     f'y2="{y:.1f}" stroke="#333"/>')
        parts.append(f'<line x1="{ML}" y1="{y:.1f}" x2="{W-MR}" '
                     f'y2="{y:.1f}" stroke="#eee"/>')
        parts.append(f'<text x="{ML-8}" y="{y+4:.1f}" text-anchor="end" '
                     f'font-size="11" font-family="sans-serif">{t:g}</text>')
    parts.append(f'<text x="{(W-MR+ML)/2}" y="{H-8}" text-anchor="middle" '
                 f'font-size="12" font-family="sans-serif">{_esc(xlabel)}'
                 f'</text>')
    parts.append(f'<text x="16" y="{(H-MB+MT)/2}" text-anchor="middle" '
                 f'font-size="12" font-family="sans-serif" '
                 f'transform="rotate(-90 16 {(H-MB+MT)/2})">{_esc(ylabel)}'
                 f'</text>')


def _legend(parts, series: List[Series]):
    for i, s in enumerate(series):
        y = MT + 14 + i * 16
        parts.append(f'<rect x="{W-MR+14}" y="{y-9}" width="10" height="10" '
                     f'fill="{s.color}"/>')
        parts.append(f'<text x="{W-MR+30}" y="{y}" font-size="11" '
                     f'font-family="sans-serif">{_esc(s.name)}</text>')


def _bounds(series):
    xs = [p[0] for s in series for p in s.points if p is not None]
    ys = [p[1] for s in series for p in s.points if p is not None]
    if not xs:
        return 0, 1, 0, 1
    return min(xs), max(xs), min(ys), max(ys)


def scatter_plot(series: List[Series], title: str, xlabel: str, ylabel: str,
                 path: str, log_y: bool = False):
    xlo, xhi, ylo, yhi = _bounds(series)
    fr = _Frame(min(xlo, 0), xhi, (ylo if log_y else min(ylo, 0)), yhi,
                log_y=log_y)
    parts = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{W}" '
             f'height="{H}">']
    _axes(parts, fr, title, xlabel, ylabel, log_y)
    for s in series:
        for p in s.points:
            if p is None:  # gap markers are meaningless in a scatter
                continue
            x, y = p
            parts.append(f'<circle cx="{fr.x(x):.1f}" cy="{fr.y(y):.1f}" '
                         f'r="2" fill="{s.color}" fill-opacity="0.6"/>')
    _legend(parts, series)
    parts.append("</svg>")
    with open(path, "w") as f:
        f.write("\n".join(parts))


def line_plot(series: List[Series], title: str, xlabel: str, ylabel: str,
              path: str, log_y: bool = False):
    xlo, xhi, ylo, yhi = _bounds(series)
    fr = _Frame(min(xlo, 0), xhi, (ylo if log_y else min(ylo, 0)), yhi,
                log_y=log_y)
    parts = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{W}" '
             f'height="{H}">']
    _axes(parts, fr, title, xlabel, ylabel, log_y)
    for s in series:
        # a None point breaks the line (a window with no data); each
        # contiguous run renders as its own polyline
        runs, cur = [], []
        for p in s.points:
            if p is None:
                if cur:
                    runs.append(cur)
                cur = []
            else:
                cur.append(p)
        if cur:
            runs.append(cur)
        for run in runs:
            if len(run) == 1:  # a one-point polyline draws nothing
                x, y = run[0]
                parts.append(f'<circle cx="{fr.x(x):.1f}" '
                             f'cy="{fr.y(y):.1f}" r="2" '
                             f'fill="{s.color}"/>')
                continue
            pts = " ".join(f"{fr.x(x):.1f},{fr.y(y):.1f}"
                           for x, y in sorted(run))
            parts.append(f'<polyline points="{pts}" fill="none" '
                         f'stroke="{s.color}" stroke-width="1.5"/>')
    _legend(parts, series)
    parts.append("</svg>")
    with open(path, "w") as f:
        f.write("\n".join(parts))
