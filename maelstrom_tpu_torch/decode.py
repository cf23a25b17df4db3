"""Host-side event decode: event buffers -> Jepsen-style op histories.

A copy of the column decode of ``maelstrom_tpu/tpu/decode.py`` (numpy
only), so histories come out byte-identical to the JAX runtime's: one
vectorized pass emits per-instance column slabs ``(tick, process,
etype, vals)`` in history order (tick, then process, then completion
before invocation), and dict records are built lazily at the checker
boundary.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence

import numpy as np

from .runtime import EV_FAIL, EV_INFO, EV_INVOKE, EV_NONE, EV_OK

ETYPE_NAMES = {EV_OK: "ok", EV_FAIL: "fail", EV_INFO: "info"}


class EventSlab(NamedTuple):
    """One instance's decoded events as columns, in history order."""
    ticks: np.ndarray      # [n] int32
    procs: np.ndarray      # [n] int32 (client index == history process)
    etypes: np.ndarray     # [n] int32 (EV_* codes)
    vals: np.ndarray       # [n, ev_vals] int32


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
                        ms_per_tick: float) -> List[dict]:
    """The Jepsen-style dict records of one slab."""
    recs: List[dict] = []
    idx = 0
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
