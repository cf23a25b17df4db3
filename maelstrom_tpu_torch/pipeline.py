"""Chunked executor for the tick loop, with on-device event compaction.

Counterpart of ``maelstrom_tpu/tpu/pipeline.py``: the horizon runs in
``chunk``-tick pieces; per tick the recorded instances' dense events
``[R, C, 2, 2 + V]`` are folded into a fixed-capacity compacted buffer
of ``(tick, loc, etype, vals...)`` rows on the device, and only that
buffer crosses to the host once per chunk. Chunk *k*'s buffer is
fetched after chunk *k + 1*'s ticks were issued, so the copy overlaps
device work. Overflow (more events than the capacity) is counted, never
silent. Trajectories equal the unchunked loop's: compaction only reads
the tick's events.

The chunk loop is a plain Python loop over ticks; PyTorch issues each
tick's kernels asynchronously on the card.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .runtime import (Carry, EV_NONE, Model, SimConfig, default_instance_ids,
                      init_carry, make_tick_fn)

DEFAULT_SCAN_TOP_K = 8


def plan_chunks(n_ticks: int, chunk: int) -> List[Tuple[int, int]]:
    """Split ``n_ticks`` into ``(t0, length)`` plans, preferring a chunk
    length near ``chunk`` (down to ``chunk // 2``) that divides the
    horizon — the same plan the JAX executor makes."""
    chunk = max(1, min(chunk, n_ticks))
    if n_ticks % chunk:
        for c in range(chunk, max(chunk // 2, 1), -1):
            if n_ticks % c == 0:
                chunk = c
                break
    plans = []
    t = 0
    while t < n_ticks:
        use = min(chunk, n_ticks - t)
        plans.append((t, use))
        t += use
    return plans


def event_capacity(sim: SimConfig, model: Model, chunk: int) -> int:
    """Compacted rows per chunk: 1.5x the expected events (floor 128,
    rounded up to 64), at most the dense row count."""
    R = sim.record_instances
    C = sim.client.n_clients
    dense_rows = chunk * R * C * 2
    expected = 2.0 * chunk * R * C * sim.client.rate
    cap = max(128, int(-(-1.5 * expected // 64)) * 64)
    return max(1, min(cap, dense_rows))


class CompactEvents(NamedTuple):
    """One chunk's compacted events on the device. ``rows`` holds ``cap``
    rows plus one spill row that absorbs masked and overflowing writes;
    ``count`` keeps counting past ``cap`` (the overflow flag)."""
    rows: torch.Tensor     # [cap + 1, 3 + ev_vals] int32
    count: torch.Tensor    # [] int32


def new_buffer(cap: int, V: int, device) -> CompactEvents:
    return CompactEvents(
        rows=torch.zeros((cap + 1, 3 + V), dtype=torch.int32, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device))


def compact_tick(buf: CompactEvents, t: int, events: torch.Tensor,
                 V: int) -> CompactEvents:
    """Fold one tick's dense events ``[R, C, 2, 2 + V]`` into ``buf``:
    a prefix sum over the nonempty mask gives each event its row."""
    cap = buf.rows.shape[0] - 1
    flat = events.reshape(-1, events.shape[-1])
    E = flat.shape[0]
    mask = flat[:, 0] != EV_NONE
    pos = buf.count + torch.cumsum(mask.to(torch.int32), 0) - 1
    idx = torch.where(mask & (pos < cap), pos, torch.full_like(pos, cap))
    loc = torch.arange(E, dtype=torch.int32, device=flat.device)
    new_rows = torch.cat([torch.full((E, 1), t, dtype=torch.int32,
                                     device=flat.device),
                          loc[:, None], flat[:, 0:1], flat[:, 1:1 + V]],
                         dim=1)
    rows = buf.rows.index_copy(0, idx.long(), new_rows)
    return CompactEvents(rows=rows,
                         count=buf.count + mask.sum().to(torch.int32))


def start_fetch(*tensors: torch.Tensor):
    """Queue the host copies of a chunk's device tensors behind the
    chunk's work (pinned memory, asynchronous on the card)."""
    if not tensors[0].is_cuda:
        return tensors, None
    host = []
    for x in tensors:
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x, non_blocking=True)
        host.append(h)
    done = torch.cuda.Event()
    done.record()
    return tuple(host), done


def finish_fetch(fetch) -> Tuple[torch.Tensor, ...]:
    """Wait for a queued copy; the host tensors."""
    host, done = fetch
    if done is not None:
        done.synchronize()
    return host


def expand_compact_events(model: Model, sim: SimConfig,
                          chunks: List[Tuple[np.ndarray, int]],
                          n_ticks: Optional[int] = None) -> np.ndarray:
    """Rebuild the dense ``[T, R, C, 2, 2 + ev_vals]`` events from compact
    chunks (the msg-id lane comes back zero: the decoder never reads it)."""
    T = sim.n_ticks if n_ticks is None else n_ticks
    R, C, V = sim.record_instances, sim.client.n_clients, model.ev_vals
    dense = np.zeros((T, R, C, 2, 2 + V), dtype=np.int32)
    for rows, count in chunks:
        n = min(int(count), rows.shape[0])
        if n == 0:
            continue
        used = rows[:n]
        r, rem = np.divmod(used[:, 1], C * 2)
        c, slot = np.divmod(rem, 2)
        dense[used[:, 0], r, c, slot, 0] = used[:, 2]
        dense[used[:, 0], r, c, slot, 1:1 + V] = used[:, 3:3 + V]
    return dense


def violation_scan(violations: torch.Tensor, telemetry,
                   instance_ids: torch.Tensor, k: int = 1) -> torch.Tensor:
    """``[k, 3]`` int32: row *i* = ``[n_violating, tick_i, instance_i]``
    for the *i*-th earliest violating instance (ties to the lowest id);
    rows past the trippers pad with -1."""
    tripped = violations > 0
    n = tripped.sum().to(torch.int32)
    ids = instance_ids.to(torch.int32)
    big = torch.iinfo(torch.int32).max
    k = max(1, min(int(k), int(ids.shape[0])))
    if telemetry is not None:
        ft = telemetry.first_violation
        key = torch.where(ft >= 0, ft, torch.full_like(ft, big))
    else:
        ft = None
        key = torch.where(tripped, ids, torch.full_like(ids, big))
    order = torch.argsort(key, stable=True)[:k]
    valid = torch.arange(k, device=ids.device) < n
    m1 = torch.full((k,), -1, dtype=torch.int32, device=ids.device)
    ticks = torch.where(valid, ft[order], m1) if ft is not None else m1
    insts = torch.where(valid, ids[order], m1)
    return torch.stack([n.expand(k), ticks.to(torch.int32),
                        insts.to(torch.int32)], dim=1)


class PipelineResult(NamedTuple):
    carry: Carry
    compact: List[Tuple[np.ndarray, int]]   # per chunk (rows, count)
    perf: Dict[str, Any]
    scan: Optional[np.ndarray] = None        # last consumed chunk's
                                             # violation scan [k, 3]


def run_sim_pipelined(model: Model, sim: SimConfig, seed: int, device=None,
                      instance_ids: Optional[torch.Tensor] = None,
                      chunk: int = 100, event_cap: Optional[int] = None,
                      scan_k: int = DEFAULT_SCAN_TOP_K,
                      fail_fast: bool = False) -> PipelineResult:
    """Run the horizon chunk by chunk; returns the final carry, each
    chunk's compacted event rows, executor stats and the violation scan
    of the last consumed chunk.

    At each chunk's end the violation scan ``[scan_k, 3]`` is computed
    on the device and copied with the chunk's events. Chunk *k*'s copy
    is consumed after chunk *k + 1* was issued. ``fail_fast`` stops
    issuing chunks once a consumed scan shows a tripped invariant: the
    chunk already in flight still runs and is consumed, so at most one
    chunk runs past the one that tripped (the JAX executor's
    ``run_chunked`` contract); ``perf`` then has ``stopped-early`` and
    ``ticks-dispatched`` counts the ticks actually run."""
    if instance_ids is None:
        instance_ids = default_instance_ids(sim, device)
    R, V = sim.record_instances, model.ev_vals
    plans = plan_chunks(sim.n_ticks, chunk)
    cap = int(event_cap) if event_cap else event_capacity(
        sim, model, plans[0][1])
    t_init = time.monotonic()
    carry = init_carry(model, sim, seed, device, instance_ids)
    tick = make_tick_fn(model, sim, instance_ids, device)
    init_s = time.monotonic() - t_init

    compact: List[Tuple[np.ndarray, int]] = []
    stats = {"overflowed-chunks": 0, "fetch-s": 0.0, "issue-s": 0.0,
             "chunk-issue-s": []}
    last_scan: List[Optional[np.ndarray]] = [None]

    def consume(fetch):
        t_f = time.monotonic()
        host = finish_fetch(fetch)
        if R > 0:
            rows, count, scan = host
            rows = rows[:-1].numpy()
            n = int(count)
            stats["overflowed-chunks"] += int(n > rows.shape[0])
            compact.append((rows, n))
        else:
            (scan,) = host
        last_scan[0] = scan.numpy()
        stats["fetch-s"] += time.monotonic() - t_f
        return int(last_scan[0][0, 0]) > 0

    pending = None
    chunks = ticks_dispatched = 0
    stopped = False
    with torch.no_grad():
        for t0, length in plans:
            t_i = time.monotonic()
            buf = new_buffer(cap, V, device) if R > 0 else None
            for t in range(t0, t0 + length):
                carry, events = tick(carry, t)
                if buf is not None:
                    buf = compact_tick(buf, t, events, V)
            scan = violation_scan(carry.violations, carry.telemetry,
                                  instance_ids, k=scan_k)
            fetch = start_fetch(*((buf.rows, buf.count, scan)
                                  if buf is not None else (scan,)))
            chunks += 1
            ticks_dispatched = t0 + length
            dt = time.monotonic() - t_i
            stats["chunk-issue-s"].append(round(dt, 4))
            stats["issue-s"] += dt
            # chunk k's copy is read once chunk k+1 is queued behind it
            tripped = consume(pending) if pending is not None else False
            pending = fetch
            if fail_fast and tripped:
                stopped = True
                break
        consume(pending)
    perf = {"chunks": chunks, "chunk-ticks": plans[0][1],
            "event-capacity": cap, "init-s": round(init_s, 4),
            "issue-s": round(stats["issue-s"], 4),
            "chunk-issue-s": stats["chunk-issue-s"],
            "fetch-s": round(stats["fetch-s"], 4),
            "overflowed-chunks": stats["overflowed-chunks"],
            "ticks-dispatched": ticks_dispatched}
    if stopped:
        perf["stopped-early"] = True
    return PipelineResult(carry=carry, compact=compact, perf=perf,
                          scan=last_scan[0])
