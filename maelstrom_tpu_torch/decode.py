"""Host-side event decode: event buffers -> Jepsen-style op histories.

A copy of the column decode of ``maelstrom_tpu/tpu/decode.py`` (numpy
only), so histories come out byte-identical to the JAX runtime's: one
vectorized pass emits per-instance column slabs ``(tick, process,
etype, vals)`` in history order (tick, then process, then completion
before invocation), and dict records are built lazily at the checker
boundary. :class:`StreamDecoder` decodes the chunked executor's
compacted chunks as they arrive (while the card runs the next chunk)
and hands each chunk's slabs to the checker farm (``checkers/pool.py``).
"""

from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from .runtime import EV_FAIL, EV_INFO, EV_INVOKE, EV_NONE, EV_OK

ETYPE_NAMES = {EV_OK: "ok", EV_FAIL: "fail", EV_INFO: "info"}


class EventSlab(NamedTuple):
    """One instance's decoded events as columns, in history order."""
    ticks: np.ndarray      # [n] int32
    procs: np.ndarray      # [n] int32 (client index == history process)
    etypes: np.ndarray     # [n] int32 (EV_* codes)
    vals: np.ndarray       # [n, ev_vals] int32


def empty_slab(ev_vals: int) -> EventSlab:
    return EventSlab(ticks=np.zeros((0,), np.int32),
                     procs=np.zeros((0,), np.int32),
                     etypes=np.zeros((0,), np.int32),
                     vals=np.zeros((0, ev_vals), np.int32))


def concat_slabs(slabs: Sequence[EventSlab], ev_vals: int) -> EventSlab:
    """One instance's chunk slabs, concatenated: chunks cover disjoint,
    increasing tick spans, so the history order holds."""
    if not slabs:
        return empty_slab(ev_vals)
    if len(slabs) == 1:
        return slabs[0]
    return EventSlab(
        ticks=np.concatenate([s.ticks for s in slabs]),
        procs=np.concatenate([s.procs for s in slabs]),
        etypes=np.concatenate([s.etypes for s in slabs]),
        vals=np.concatenate([s.vals for s in slabs], axis=0))


def _split_by_instance(order, insts, ticks, procs, etypes, vals,
                       n_instances: int) -> Dict[int, EventSlab]:
    insts = insts[order]
    ticks, procs = ticks[order], procs[order]
    etypes, vals = etypes[order], vals[order]
    out: Dict[int, EventSlab] = {}
    if insts.shape[0] == 0:
        return out
    bounds = np.searchsorted(insts, np.arange(n_instances + 1))
    for inst in range(n_instances):
        lo, hi = int(bounds[inst]), int(bounds[inst + 1])
        if lo == hi:
            continue
        out[inst] = EventSlab(ticks=ticks[lo:hi], procs=procs[lo:hi],
                              etypes=etypes[lo:hi], vals=vals[lo:hi])
    return out


def decode_dense(model, events: np.ndarray) -> Dict[int, EventSlab]:
    """One pass over a dense ``[T, R, C, 2, 2 + ev_vals]`` tensor."""
    events = np.asarray(events)
    T, R, C, _, _ = events.shape
    V = model.ev_vals
    nz = np.argwhere(events[..., 0] != EV_NONE)
    if nz.shape[0] == 0:
        return {}
    t, r, c, slot = nz[:, 0], nz[:, 1], nz[:, 2], nz[:, 3]
    rows = events[t, r, c, slot]
    order = np.lexsort((slot, c, t, r))
    return _split_by_instance(order, r, t.astype(np.int32),
                              c.astype(np.int32),
                              rows[:, 0].astype(np.int32),
                              rows[:, 1:1 + V].astype(np.int32, copy=False),
                              R)


def decode_compact(model, n_clients: int, n_instances: int,
                   chunks: Sequence[Tuple[np.ndarray, int]]
                   ) -> Dict[int, EventSlab]:
    """Per-chunk compacted ``(rows, count)`` buffers straight into
    per-instance slabs (the dense tensor is never rebuilt); an
    overflowed chunk contributes its retained rows."""
    used = [np.asarray(rows[:min(int(count), rows.shape[0])])
            for rows, count in chunks if int(count) > 0]
    if not used:
        return {}
    allrows = used[0] if len(used) == 1 else np.concatenate(used, axis=0)
    return decode_compact_rows(model, n_clients, n_instances, allrows)


def decode_compact_rows(model, n_clients: int, n_instances: int,
                        rows: np.ndarray) -> Dict[int, EventSlab]:
    """Column-decode trimmed compact rows ``[(tick, loc, etype,
    vals...)]`` with ``loc = (r * C + c) * 2 + slot``."""
    V = model.ev_vals
    t = rows[:, 0]
    loc = rows[:, 1]
    r, rem = np.divmod(loc, n_clients * 2)
    c, slot = np.divmod(rem, 2)
    order = np.lexsort((slot, c, t, r))
    return _split_by_instance(order, r, t.astype(np.int32),
                              c.astype(np.int32),
                              rows[:, 2].astype(np.int32),
                              rows[:, 3:3 + V].astype(np.int32, copy=False),
                              n_instances)


def materialize_records(model, slab: EventSlab, final_start: int,
                        ms_per_tick: float,
                        index_base: int = 0) -> List[dict]:
    """The Jepsen-style dict records of one slab — shared by the
    in-process path and the checker farm's workers, so both build the
    same bytes. ``index_base`` continues a streamed instance's running
    ``index`` across its chunk slabs."""
    recs: List[dict] = []
    idx = index_base
    for tick, proc, etype, v in zip(slab.ticks.tolist(), slab.procs.tolist(),
                                    slab.etypes.tolist(),
                                    slab.vals.tolist()):
        time_ns = int(tick * ms_per_tick * 1_000_000)
        if etype == EV_INVOKE:
            rec = model.invoke_record(*v)
            rec.update({"process": proc, "type": "invoke", "time": time_ns})
            if tick >= final_start:
                rec["final"] = True
        else:
            rec = model.complete_record(*v, etype)
            rec.update({"process": proc, "type": ETYPE_NAMES[etype],
                        "time": time_ns})
        rec["index"] = idx
        idx += 1
        recs.append(rec)
    return recs


class LazyHistories(Sequence):
    """Per-instance histories, materialized on first access."""

    def __init__(self, model, slabs: Dict[int, EventSlab],
                 n_instances: int, final_start: int, ms_per_tick: float):
        self._model = model
        self._slabs = slabs
        self._n = n_instances
        self._final_start = final_start
        self._ms_per_tick = ms_per_tick
        self._cache: Dict[int, List[dict]] = {}

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(self._n))]
        if i < 0:
            i += self._n
        if not 0 <= i < self._n:
            raise IndexError(i)
        if i not in self._cache:
            slab = self._slabs.get(i)
            self._cache[i] = ([] if slab is None else
                              materialize_records(self._model, slab,
                                                  self._final_start,
                                                  self._ms_per_tick))
        return self._cache[i]

    def slab(self, i: int) -> Optional[EventSlab]:
        return self._slabs.get(i)


class StreamDecoder:
    """Incremental column decode for the chunked executor: :meth:`feed`
    each chunk's compacted rows as they are fetched, then :meth:`finish`
    into a :class:`LazyHistories`. Each chunk's per-instance slabs also
    go to ``on_slabs`` (the checker farm's streaming feed)."""

    def __init__(self, model, n_clients: int, n_instances: int,
                 final_start: int, ms_per_tick: float, on_slabs=None):
        self._model = model
        self._C = n_clients
        self._R = n_instances
        self._final_start = final_start
        self._ms_per_tick = ms_per_tick
        self._on_slabs = on_slabs
        self._per_instance: Dict[int, List[EventSlab]] = {}
        self.decode_s = 0.0

    def _add(self, slabs: Dict[int, EventSlab], t0: float) -> None:
        for inst, slab in slabs.items():
            self._per_instance.setdefault(inst, []).append(slab)
        self.decode_s += time.monotonic() - t0
        if self._on_slabs is not None and slabs:
            self._on_slabs(slabs)

    def feed(self, rows: np.ndarray, count: int, *_span) -> None:
        """One chunk's compacted ``rows`` and their ``count`` (past the
        buffer's length on overflow); ``_span`` is the chunk's ``(t0,
        length)``, unused."""
        t0 = time.monotonic()
        n = min(int(count), rows.shape[0])
        self._add(decode_compact_rows(self._model, self._C, self._R,
                                      np.asarray(rows[:n]))
                  if n else {}, t0)

    def feed_dense(self, events: np.ndarray) -> None:
        """The single-loop executor's dense events, in one piece."""
        t0 = time.monotonic()
        self._add(decode_dense(self._model, events), t0)

    def finish(self) -> LazyHistories:
        t0 = time.monotonic()
        V = self._model.ev_vals
        merged = {inst: concat_slabs(parts, V)
                  for inst, parts in self._per_instance.items()}
        self.decode_s += time.monotonic() - t0
        return LazyHistories(self._model, merged, self._R,
                             self._final_start, self._ms_per_tick)
