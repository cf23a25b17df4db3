"""Per-chunk device time, attributed to the tick's phases.

Counterpart of ``maelstrom_tpu/telemetry/profiler.py``, with its
records, roll-up, report and CLI contract. :class:`DeviceProfiler`
captures chunks of the chunked executors (``--device-profile
auto|on|off``; ``auto``, the default, the first
:data:`~DeviceProfiler.AUTO_FIRST_K` chunks and then every
:data:`~DeviceProfiler.AUTO_EVERY_N`-th), measures each captured
chunk's device wall and splits it over the tick's phases — the
runtime's :func:`phase` ranges ``nemesis``, ``faults``, ``deliver``,
``node_phase``, ``client_step``, ``enqueue``, ``check_summary`` and
``telemetry``, with everything between them under ``other``.

Issuing a chunk is the chunk's work: the host queues every kernel of
every tick, and the card runs them as they come. A capture therefore
first waits for the card to finish the chunk before it, then measures
from the first queued kernel to the chunk's last, idle gaps included:
on a launch-bound tick the device wall is mostly the host's issue time
(``profile_tick.py`` splits busy from idle). Two sources, in order:

``trace``
    CUDA events at every phase boundary of the captured chunk (a
    :func:`phase` records one on entry and one on exit while a capture
    is armed; about 20 a tick, no synchronisation inside the tick).
    The spans between consecutive events on a device sum to that
    device's wall, and each span is charged to the phase it lies in.
    Attempted on a card (``MAELSTROM_DEVICE_TRACE=0`` turns it off,
    ``=1`` forces the attempt elsewhere); a failed attempt latches a
    process-wide fallback, so it is paid at most once.

``timed``
    The whole issue bracketed by CUDA events on the card (the host
    clock on the CPU, where the ops run as they are issued) and split
    over the phases by fixed weights: the share of the non-view
    operators each phase dispatches in one tick of a two-instance copy
    of the fleet on the CPU (:func:`phase_weights`, cached per
    configuration). The per-phase sum equals the measured wall.

Profiling only observes: the capture never touches the carry, and
trajectories are bit-identical with profiling on or off
(``tests/test_torch_profiler.py``). Captured chunks' heartbeat records
gain the ``device-ms`` lane (``watch`` renders ``dev[node 0.41 ...]``),
``results.perf.phases.device`` gets the roll-up, and ``profile
<run-dir>`` renders the per-phase table (:func:`render_profile_report`).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function

# short lane labels for the heartbeat's dev[...] rendering (stream.py)
# and the profile report, keyed by the runtime's phase names
PHASE_LABELS = {
    "nemesis": "nem",
    "deliver": "net",
    "node_phase": "node",
    "client_step": "client",
    "enqueue": "enq",
    "telemetry": "tel",
    "faults": "fault",
    "check_summary": "check",
    "other": "other",
}
OTHER = "other"

# process-wide latch: once a trace attempt fails, every later profiler in
# the process goes straight to the timed source
_TRACE_FAILED = [False]

# per-phase operator weights of the tick, keyed per configuration
_WEIGHT_CACHE: Dict[Any, Dict[str, float]] = {}

# the issuing thread's current phase, and the capture's marks while one
# is armed
_CURRENT = [OTHER]
_MARKS: List[Optional["_Marks"]] = [None]


@contextlib.contextmanager
def phase(name: str):
    """One phase of the tick: a ``torch.profiler`` range (it records
    nothing unless a profiler runs) and, while a capture is armed, a
    mark on entry and on exit."""
    prev = _CURRENT[0]
    _CURRENT[0] = name
    marks = _MARKS[0]
    if marks is not None:
        marks.mark(name)
    try:
        with record_function(name):
            yield
    finally:
        _CURRENT[0] = prev
        if marks is not None:
            marks.mark(prev)


class _Marks:
    """Timestamps at phase boundaries, each charged to the phase that
    follows it: CUDA events on the current stream of each card (the
    trace source), or the host clock (``host_clock``, for a run on the
    CPU where the ops run as they are issued)."""

    def __init__(self, devices: Sequence[torch.device],
                 host_clock: bool = False):
        self.host_clock = host_clock
        cards = sorted({d.index or 0 for d in devices if d.type == "cuda"})
        if not host_clock and not cards:
            raise RuntimeError("no CUDA device to record events on")
        self.cards = cards
        self.stamps: List[Tuple[str, int, Any]] = []

    def mark(self, label: str) -> None:
        if self.host_clock:
            self.stamps.append((label, -1, time.perf_counter()))
            return
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.stamps.append((label, torch.cuda.current_device(), ev))

    def mark_all(self, label: str) -> None:
        """A mark on every card of the capture (its start and end)."""
        if self.host_clock:
            self.mark(label)
            return
        for c in self.cards:
            with torch.cuda.device(c):
                self.mark(label)

    def read(self) -> Tuple[Dict[str, float], float]:
        """``(ms per phase, device wall ms)``: the spans between
        consecutive marks on each device, summed per phase; the wall is
        the longest device's sum."""
        if not self.host_clock:
            for _, _, ev in self.stamps[-len(self.cards):]:
                ev.synchronize()
        per_phase: Dict[str, float] = {}
        per_dev: Dict[int, float] = {}
        last: Dict[int, Tuple[str, Any]] = {}
        for label, dev, stamp in self.stamps:
            if dev in last:
                prev_label, prev = last[dev]
                ms = ((stamp - prev) * 1e3 if self.host_clock
                      else prev.elapsed_time(stamp))
                per_phase[prev_label] = per_phase.get(prev_label, 0.0) + ms
                per_dev[dev] = per_dev.get(dev, 0.0) + ms
            last[dev] = (label, stamp)
        return per_phase, max(per_dev.values(), default=0.0)


def _new_marks(devices: Sequence[torch.device]) -> _Marks:
    return _Marks(devices)


def _trace_wanted(device=None) -> bool:
    """Whether the event-trace source is worth attempting: on a card,
    unless ``MAELSTROM_DEVICE_TRACE=0``; ``MAELSTROM_DEVICE_TRACE=1``
    forces the attempt (which fails, and latches, without a card)."""
    env = os.environ.get("MAELSTROM_DEVICE_TRACE", "")
    if env == "0":
        return False
    if env:
        return True
    return device is not None and torch.device(device).type == "cuda"


def _weights_key(model, sim) -> Optional[Any]:
    try:
        return (type(model).__module__, type(model).__qualname__,
                getattr(model, "name", ""), repr(sim))
    except Exception:
        return None


def phase_op_counts(model, sim) -> Dict[str, int]:
    """Non-view operators each phase dispatches in one tick (tick 0) of
    a copy of the fleet cut to two instances, on the CPU: a throwaway
    carry and tick function of their own, so the run's carry and draws
    are untouched. Operators outside every phase count as ``other``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from ..profile_tick import _VIEW_OPS
    from ..runtime import init_carry, make_tick_fn

    n = min(sim.n_instances, 2)
    small = sim._replace(n_instances=n,
                         record_instances=min(sim.record_instances, n),
                         journal_instances=min(sim.journal_instances, n))
    counts: Dict[str, int] = {}

    class _Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            # the phase ranges' own profiler ops launch nothing
            if func.namespace != "profiler" \
                    and func.overloadpacket.__name__ not in _VIEW_OPS:
                counts[_CURRENT[0]] = counts.get(_CURRENT[0], 0) + 1
            return func(*args, **(kwargs or {}))

    cpu = torch.device("cpu")
    with torch.no_grad():
        carry = init_carry(model, small, 0, cpu)
        tick = make_tick_fn(model, small, device=cpu)
        with _Count():
            tick(carry, 0)
    return counts


def phase_weights(model, sim) -> Dict[str, float]:
    """Each phase's share of the tick's operators
    (:func:`phase_op_counts`): the timed source's split. Falls back to
    an opaque ``{"other": 1.0}`` when the tick cannot be counted (the
    run never depends on the instrumentation)."""
    key = _weights_key(model, sim)
    if key is not None and key in _WEIGHT_CACHE:
        return _WEIGHT_CACHE[key]
    try:
        counts = phase_op_counts(model, sim)
        total = sum(counts.values())
        weights = ({ph: n / total for ph, n in sorted(counts.items())
                    if n > 0} if total > 0 else {OTHER: 1.0})
    except Exception:
        weights = {OTHER: 1.0}
    if key is not None:
        _WEIGHT_CACHE[key] = weights
    return weights


def _on_card(cards: Sequence[int]):
    """The run's card as the current device (its stream takes the
    marks) when the chunk runs on one card; a sharded executor sets each
    shard's own."""
    if len(cards) == 1:
        return torch.cuda.device(cards[0])
    return contextlib.nullcontext()


def _sync(devices: Sequence[torch.device]) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


class DeviceProfiler:
    """Per-chunk device-time capture for the chunked executors.

    ``mode``: ``"on"`` captures every chunk, ``"auto"`` (the default)
    the first :data:`AUTO_FIRST_K` chunks then every
    :data:`AUTO_EVERY_N`-th, so the other chunks keep their overlap of
    issue and copy. (``"off"`` is resolved by the caller: no profiler is
    constructed.) ``device`` is the run's device; an executor whose
    chunk spans several devices passes them to :meth:`capture`.

    The executor calls :meth:`should_capture` with the absolute chunk
    index (a resumed run continues it) and issues the captured chunks
    through :meth:`capture`; every other chunk is issued untouched.
    """

    MODES = ("auto", "on", "off")
    AUTO_FIRST_K = 3
    AUTO_EVERY_N = 8

    def __init__(self, mode: str = "auto", model=None, sim=None,
                 device=None):
        if mode not in self.MODES:
            raise ValueError(f"device-profile mode {mode!r} not in "
                             f"{self.MODES}")
        self.mode = mode
        self._model, self._sim = model, sim
        self.device = None if device is None else torch.device(device)
        self._weights: Optional[Dict[str, float]] = None
        self._try_trace = mode != "off" and _trace_wanted(self.device)
        self.records: List[Dict[str, Any]] = []

    def should_capture(self, idx: int) -> bool:
        if self.mode == "off":
            return False
        if self.mode == "on":
            return True
        return idx < self.AUTO_FIRST_K or idx % self.AUTO_EVERY_N == 0

    def _phase_fractions(self) -> Dict[str, float]:
        if self._weights is None:
            self._weights = (phase_weights(self._model, self._sim)
                             if self._model is not None
                             and self._sim is not None
                             else {OTHER: 1.0})
        return self._weights

    def capture(self, fn, args: Tuple, ticks: int,
                devices: Optional[Sequence] = None
                ) -> Tuple[Any, Dict[str, Any]]:
        """Issue ``fn(*args)`` under measurement; returns ``(outputs,
        record)``. The card first finishes the work queued before (the
        previous chunk and its copies), so the window holds only this
        chunk's. The marks are disarmed on the way out, also when ``fn``
        raises."""
        devs = [torch.device(d) for d in (
            devices if devices is not None
            else [self.device or torch.device("cpu")])]
        cards = sorted({d.index or 0 for d in devs if d.type == "cuda"})
        _sync(devs)
        traced = None
        dt_ms = None
        out = None
        if self._try_trace and not _TRACE_FAILED[0]:
            marks = None
            try:
                marks = _new_marks(devs)
            except Exception:
                _TRACE_FAILED[0] = True
            if marks is not None:
                t0 = time.perf_counter()
                _MARKS[0] = marks
                try:
                    marks.mark_all(OTHER)
                    with _on_card(cards):
                        out = fn(*args)
                    marks.mark_all(OTHER)
                finally:
                    _MARKS[0] = None
                try:
                    traced, dt_ms = marks.read()
                except Exception:
                    _TRACE_FAILED[0] = True
                    _sync(devs)
                    dt_ms = (time.perf_counter() - t0) * 1e3
        if dt_ms is None:
            if cards:
                starts, ends = [], []
                for c in cards:
                    with torch.cuda.device(c):
                        starts.append(torch.cuda.Event(enable_timing=True))
                        starts[-1].record()
                with _on_card(cards):
                    out = fn(*args)
                for c in cards:
                    with torch.cuda.device(c):
                        ends.append(torch.cuda.Event(enable_timing=True))
                        ends[-1].record()
                for ev in ends:
                    ev.synchronize()
                dt_ms = max(a.elapsed_time(b) for a, b in zip(starts, ends))
            else:
                t0 = time.perf_counter()
                out = fn(*args)
                dt_ms = (time.perf_counter() - t0) * 1e3
        if traced is not None:
            source = "trace"
            per_phase = {ph: round(ms, 4)
                         for ph, ms in sorted(traced.items())}
        else:
            source = "timed"
            per_phase = {ph: round(dt_ms * w, 4)
                         for ph, w in self._phase_fractions().items()}
        record = {
            "per-phase-ms": per_phase,
            "ms-per-tick": round(dt_ms / max(ticks, 1), 5),
            "device-s": round(dt_ms / 1e3, 5),
            "ticks": int(ticks),
            "source": source,
        }
        self.records.append(record)
        return out, record

    def summary(self) -> Optional[Dict[str, Any]]:
        """The run-level roll-up for ``results.perf.phases.device``:
        per-phase ms/tick over the captured chunks."""
        if not self.records:
            return None
        ticks = sum(r["ticks"] for r in self.records) or 1
        per_phase: Dict[str, float] = {}
        for r in self.records:
            for ph, ms in r["per-phase-ms"].items():
                per_phase[ph] = per_phase.get(ph, 0.0) + ms
        total_ms = sum(r["device-s"] for r in self.records) * 1000.0
        return {
            "mode": self.mode,
            "source": self.records[-1]["source"],
            "captured-chunks": len(self.records),
            "ms-per-tick": round(total_ms / ticks, 5),
            "per-phase-ms-per-tick": {
                ph: round(ms / ticks, 5)
                for ph, ms in sorted(per_phase.items())},
        }


def hot_scope(per_phase: Dict[str, float]
              ) -> Optional[Tuple[str, float]]:
    """The phase with the most time in a per-phase ms dict (the watch
    column and the profile report's verdict line)."""
    if not per_phase:
        return None
    ph = max(per_phase, key=lambda k: per_phase[k])
    return ph, per_phase[ph]


def load_device_records(run_dir: str) -> Dict[str, Any]:
    """Everything device-time a stored run has: the heartbeat chunk
    records with a ``device-ms`` lane and the results.json
    ``perf.phases.device`` roll-up. Both optional: runs with profiling
    off yield empty fields, never an error."""
    from .stream import read_heartbeat

    chunks: List[Dict[str, Any]] = []
    hb_path = os.path.join(run_dir, "heartbeat.jsonl")
    if os.path.exists(hb_path):
        try:
            for rec in read_heartbeat(hb_path)["chunks"]:
                if rec.get("device-ms"):
                    chunks.append(rec)
        except Exception:
            pass
    summary = None
    res_path = os.path.join(run_dir, "results.json")
    if os.path.exists(res_path):
        try:
            with open(res_path) as fh:
                results = json.load(fh)
            summary = (results.get("perf", {}).get("phases", {})
                       .get("device"))
        except Exception:
            pass
    return {"chunks": chunks, "summary": summary}


def render_profile_report(run_dir: str) -> Optional[str]:
    """The ``profile <run-dir>`` body: per-phase device ms/tick and the
    hot scope. None when the run carries no device time (the CLI exits
    2 and says how to get some)."""
    data = load_device_records(run_dir)
    chunks, summary = data["chunks"], data["summary"]
    if not chunks and not summary:
        return None

    per_phase: Dict[str, float] = {}
    ticks = 0
    source = None
    if chunks:
        for rec in chunks:
            for ph, ms in rec["device-ms"].items():
                per_phase[ph] = per_phase.get(ph, 0.0) + ms
            ticks += int(rec.get("ticks", 0))
            source = rec.get("device-source", source)
        per_tick = {ph: ms / max(ticks, 1)
                    for ph, ms in per_phase.items()}
    else:
        per_tick = dict(summary.get("per-phase-ms-per-tick", {}))
    if summary:
        source = summary.get("source", source)

    total = sum(per_tick.values())
    lines = [f"device time — {run_dir}"]
    bits = []
    if summary:
        bits.append(f"mode {summary.get('mode', '?')}")
    if source:
        bits.append(f"source {source}")
    if chunks:
        bits.append(f"{len(chunks)} captured chunks / {ticks} ticks")
    if bits:
        lines.append("  " + " · ".join(bits))
    lines.append("")
    lines.append(f"  {'phase':<14} {'ms/tick':>9} {'share':>7}")
    for ph, ms in sorted(per_tick.items(), key=lambda kv: -kv[1]):
        share = ms / total if total > 0 else 0.0
        lines.append(f"  {ph:<14} {ms:>9.4f} {share:>6.0%}")
    lines.append(f"  {'total':<14} {total:>9.4f}")
    hot = hot_scope(per_tick)
    if hot:
        share = hot[1] / total if total > 0 else 0.0
        lines.append("")
        lines.append(f"hot scope: {hot[0]} "
                     f"({hot[1]:.4f} ms/tick, {share:.0%})")
    return "\n".join(lines)
