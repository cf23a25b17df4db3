"""Chunked executor for the tick loop, with on-device event compaction.

Counterpart of ``maelstrom_tpu/tpu/pipeline.py``: the horizon runs in
``chunk``-tick pieces; per tick the recorded instances' dense events
``[R, C, 2, 2 + V]`` are folded into a fixed-capacity compacted buffer
of ``(tick, loc, etype, vals...)`` rows on the device, and only that
buffer crosses to the host once per chunk, with the journaled
instances' rows, the violation scan and, for the heartbeat, the
fleet's NetStats. Chunk
*k*'s copy is read after chunk *k + 1*'s ticks were issued, so the copy
overlaps device work; the heartbeat's record of chunk *k* is written
then. Overflow (more events than the capacity) is counted, never
silent. Trajectories equal the unchunked loop's: compaction only reads
the tick's events.

Every ``checkpoint_every`` chunks the executor hands a consistent cut —
the carry and the host-side accumulators covering exactly the ticks
issued — to a checkpoint sink (``campaign/checkpoint.py``); ``resume``
continues such a cut, so a killed run finishes equal to an
uninterrupted one.

The chunk loop is a plain Python loop over ticks; PyTorch issues each
tick's kernels asynchronously on the card.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .checkers import device_summary
from .faults import fuzz as faults_fuzz
from .faults.engine import span_summary
from .runtime import (Carry, EV_NONE, Model, SimConfig, default_instance_ids,
                      init_carry, make_tick_fn)
from .telemetry.stream import (scan_to_violation, scan_to_violations,
                               stats_vec_to_net)

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


class ResumeState(NamedTuple):
    """A restored mid-run cut to continue from (built by
    ``campaign/checkpoint.py`` from a checkpoint on disk): the carry at
    tick frontier ``ticks``, the absolute consumed-chunk cursor
    ``chunks``, and the host accumulators ``compact`` and ``journal``
    (``events``: the sharded executor's dense chunks, in global-id
    order) covering ticks ``[0, ticks)``, so the resumed run's outputs
    span the whole horizon. The sharded executor's ``carry`` is its
    wire carry (``parallel/mesh.py``)."""
    carry: Any
    ticks: int
    chunks: int = 0
    compact: Tuple[Tuple[np.ndarray, int], ...] = ()
    journal: Tuple[Tuple[np.ndarray, np.ndarray], ...] = ()
    events: Tuple[np.ndarray, ...] = ()


def resume_plans(n_ticks: int, chunk: int,
                 resume: Optional[ResumeState]) -> List[Tuple[int, int]]:
    """The chunk plan of a (possibly resumed) run: the whole horizon's
    plan less the prefix the resume covers. Checkpoints fall on chunk
    boundaries of the same plan, so the rest is an exact suffix; a
    frontier off every boundary means the chunk plan changed between
    the run and its resume, and is refused."""
    plans = plan_chunks(n_ticks, chunk)
    if resume is None:
        return plans
    if resume.ticks >= n_ticks:
        return []
    rest = [p for p in plans if p[0] >= resume.ticks]
    if not rest or rest[0][0] != resume.ticks:
        raise ValueError(
            f"checkpoint tick frontier {resume.ticks} is not a chunk "
            f"boundary of plan_chunks({n_ticks}, {chunk}) — resume "
            f"with the original --chunk-ticks")
    return rest


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


def compact_payload_bytes(rows: np.ndarray) -> int:
    """Fetched bytes of one compacted chunk, as the JAX executor counts
    them: its ``cap`` rows (the spill row left out) plus the count
    scalar and the stats vector's share."""
    return rows.nbytes + 8


def expand_compact_events(model: Model, sim: SimConfig,
                          chunks: List[Tuple[np.ndarray, int]],
                          n_ticks: Optional[int] = None,
                          instances: Optional[List[int]] = None
                          ) -> np.ndarray:
    """Rebuild the dense ``[T, R, C, 2, 2 + ev_vals]`` events from compact
    chunks (the msg-id lane comes back zero: the decoder never reads it).
    ``instances`` selects recorded instances by record index, in the
    order given: only their rows are expanded, into ``[T,
    len(instances), C, 2, 2 + ev_vals]``."""
    T = sim.n_ticks if n_ticks is None else n_ticks
    R, C, V = sim.record_instances, sim.client.n_clients, model.ev_vals
    remap = None
    if instances is not None:
        remap = np.full((R,), -1, dtype=np.int64)
        for pos, r_idx in enumerate(instances):
            remap[int(r_idx)] = pos
        R = len(instances)
    dense = np.zeros((T, R, C, 2, 2 + V), dtype=np.int32)
    for rows, count in chunks:
        n = min(int(count), rows.shape[0])
        if n == 0:
            continue
        used = rows[:n]
        r, rem = np.divmod(used[:, 1], C * 2)
        if remap is not None:
            r = remap[r]
            used, rem, r = used[r >= 0], rem[r >= 0], r[r >= 0]
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


def scan_source(carry: Carry) -> torch.Tensor:
    """What the chunk scan counts: each instance's violation ticks, plus
    one when a device verdict lane flagged it (the JAX executor's
    source), so a flag counts as a trip."""
    if carry.check_summary is None:
        return carry.violations
    flags = carry.check_summary[:, device_summary.L_FLAGS]
    return carry.violations + (flags != 0).to(torch.int32)


def issue_chunk(tick, carry: Carry, t0: int, length: int, *, cap: int,
                V: int, R: int, J: int, instance_ids: torch.Tensor,
                scan_k: int, with_stats: bool, device=None):
    """One chunk dispatch of the chunked executor: ``length`` ticks of
    ``tick`` from ``t0``, the recorded instances' events folded into a
    fresh ``cap``-row compacted buffer, the journaled instances' rows,
    the fleet's NetStats (``with_stats``) and the violation scan, queued
    on the device. Returns ``(carry', outputs)``, ``outputs`` in the
    order :func:`run_sim_pipelined`'s consumer pops them. The executor,
    the bench and the executable store's recorder
    (``aot_store.record_dispatch``) all run this one function."""
    buf = new_buffer(cap, V, device) if R > 0 else None
    sends, recvs = [], []
    for t in range(t0, t0 + length):
        carry, ys = tick(carry, t)
        if buf is not None:
            buf = compact_tick(buf, t, ys.events, V)
        if J > 0:
            sends.append(ys.journal_sends)
            recvs.append(ys.journal_recvs)
    scan = violation_scan(scan_source(carry), carry.telemetry,
                          instance_ids, k=scan_k)
    out = ((buf.rows, buf.count) if buf is not None else ()) + (
        (torch.stack(sends), torch.stack(recvs)) if J > 0 else ())
    if with_stats:
        out += (torch.stack(list(carry.stats)),)
    return carry, out + (scan,)


class PipelineResult(NamedTuple):
    carry: Carry
    compact: List[Tuple[np.ndarray, int]]   # per chunk (rows, count)
    perf: Dict[str, Any]
    scan: Optional[np.ndarray] = None        # last consumed chunk's
                                             # violation scan [k, 3]
    journal_sends: Optional[np.ndarray] = None   # [T, J, M, L]
    journal_recvs: Optional[np.ndarray] = None   # [T, J, NT, K, L]


def run_sim_pipelined(model: Model, sim: SimConfig, seed: int, device=None,
                      instance_ids: Optional[torch.Tensor] = None,
                      chunk: int = 100, event_cap: Optional[int] = None,
                      scan_k: int = DEFAULT_SCAN_TOP_K,
                      fail_fast: bool = False,
                      heartbeat=None, fuzz_windows=None, event_sink=None,
                      check_mode: Optional[str] = None,
                      checkpoint_cb=None, checkpoint_every: int = 0,
                      resume: Optional[ResumeState] = None,
                      profiler=None,
                      aot_store: Optional[str] = None) -> PipelineResult:
    """Run the horizon chunk by chunk; returns the final carry, each
    chunk's compacted event rows, executor stats, the violation scan
    of the last consumed chunk and the journaled instances' sent rows
    and inboxes over the ticks run (None unless
    ``sim.journal_instances``).

    At each chunk's end the violation scan ``[scan_k, 3]`` is computed
    on the device and copied with the chunk's events and journal, and
    with the fleet's NetStats when a heartbeat reads them. Chunk *k*'s copy is consumed after
    chunk *k + 1* was issued. ``fail_fast`` stops issuing chunks once
    a consumed scan shows a tripped invariant: the chunk already in
    flight still runs and is consumed, so at most one chunk runs past
    the one that tripped (the JAX executor's ``run_chunked`` contract);
    ``perf`` then has ``stopped-early`` and ``ticks-dispatched`` counts
    the ticks actually run. ``heartbeat`` (a
    :class:`.telemetry.stream.HeartbeatWriter`) gets one record per
    consumed chunk; it only reads what the chunk copied, and on a fuzz
    run the fleet's drawn windows ``fuzz_windows``
    (``fuzz.fleet_windows``) for its span counters.

    With the device verdict lanes on (``sim.check_summary``) the scan
    counts flagged instances — invariant trips or summary flags — so
    ``fail_fast`` stops on any device-detected suspicion and, with
    ``check_mode`` given, each heartbeat record gains the ``check`` lane
    ``{mode, flagged, of}``. ``event_sink(rows, count, t0, length)``
    receives each consumed chunk's compacted events (the streaming
    verdict stage, ``checkers/pool.py``: chunk *k* decodes while chunk
    *k + 1* runs).

    ``checkpoint_cb(carry, ticks, host)`` receives, every
    ``checkpoint_every`` chunks (not after the last), the carry at a
    consistent cut with the host accumulators (``{"compact",
    "journal", "chunks"}``): the chunk just issued is consumed first and
    the next one is issued only after the callback returns, so the carry
    the callback reads is the one the accumulators cover. ``resume``
    continues a checkpointed run from its tick frontier; the returned
    compact chunks and journal then cover the whole horizon.

    ``profiler`` (a :class:`.telemetry.profiler.DeviceProfiler`) issues
    the chunks its ``should_capture`` picks, by absolute chunk index,
    under device-time measurement: their heartbeat records gain
    ``device-s``, ``device-ms`` and ``device-source``, and ``perf`` the
    roll-up under ``device``. The other chunks are issued as without
    it; the trajectory is the same either way.

    ``aot_store`` (a directory, or None): the certified store of the
    kernel libraries the dispatch launches (``aot_store.py``). The
    first chunk of each length loads them from the store (a hit: no
    ``nvcc``) or records the dispatch's certificate, builds what the
    store lacks and stores the entry (a miss); the outcome lands under
    ``perf["aot"]`` (``hit``, ``load-s``, ``fingerprint``, ``lengths``,
    and the refusals, builds and seconds behind them). ``perf
    ["first-dispatch-s"]`` is the wall from the executor's start to the
    end of the first chunk's issue, the store's work included. The
    trajectory is the same with the store on, off, warm or cold."""
    if instance_ids is None:
        instance_ids = default_instance_ids(sim, device)
    R, J, V = sim.record_instances, sim.journal_instances, model.ev_vals
    full_plans = plan_chunks(sim.n_ticks, chunk)
    plans = resume_plans(sim.n_ticks, chunk, resume)
    cap = int(event_cap) if event_cap else event_capacity(
        sim, model, full_plans[0][1])
    t_init = t_start = time.monotonic()
    carry = (resume.carry if resume is not None
             else init_carry(model, sim, seed, device, instance_ids))
    tick = make_tick_fn(model, sim, instance_ids, device)
    init_s = time.monotonic() - t_init

    compact: List[Tuple[np.ndarray, int]] = (
        [(np.asarray(r), int(n)) for r, n in resume.compact]
        if resume is not None else [])
    journal: List[Tuple[np.ndarray, np.ndarray]] = (
        [(np.asarray(a), np.asarray(b)) for a, b in resume.journal]
        if resume is not None else [])
    stats = {"overflowed-chunks": sum(1 for r, n in compact
                                      if n > r.shape[0]),
             "fetch-s": 0.0, "issue-s": 0.0, "chunk-issue-s": [],
             "checkpoint-s": []}
    last_scan: List[Optional[np.ndarray]] = [None]

    def consume(fetch, k: int, t0: int, length: int, prof_rec=None):
        t_f = time.monotonic()
        host = list(finish_fetch(fetch))
        ovf = False
        if R > 0:
            rows, count = host.pop(0)[:-1].numpy(), int(host.pop(0))
            ovf = count > rows.shape[0]
            stats["overflowed-chunks"] += int(ovf)
            compact.append((rows, count))
            if event_sink is not None:
                event_sink(rows, count, t0, length)
        if J > 0:
            journal.append((host.pop(0).numpy(), host.pop(0).numpy()))
        last_scan[0] = host.pop().numpy()
        if heartbeat is not None:
            extra = None
            if fuzz_windows is not None:
                extra = {"fault-fuzz": faults_fuzz.span_counters(
                    fuzz_windows, t0, length)}
            elif sim.faults.active:
                extra = {"fault": span_summary(sim.faults, t0, length)}
            if sim.check_summary and check_mode:
                # the scan already counts the flagged instances
                extra = dict(extra or {})
                extra["check"] = {"mode": check_mode,
                                  "flagged": int(last_scan[0][0, 0]),
                                  "of": sim.n_instances}
            if prof_rec is not None:
                # the device-time lane: this chunk's ms per phase
                extra = dict(extra or {})
                extra["device-ms"] = prof_rec["per-phase-ms"]
                extra["device-source"] = prof_rec["source"]
            heartbeat.record_chunk(
                chunk=k, t0=t0, ticks=length,
                net=stats_vec_to_net(host.pop().numpy()),
                violation=scan_to_violation(last_scan[0]),
                violations=scan_to_violations(last_scan[0]),
                overflowed=ovf,
                device_s=(prof_rec["device-s"] if prof_rec is not None
                          else None),
                extra=extra)
        stats["fetch-s"] += time.monotonic() - t_f
        return int(last_scan[0][0, 0]) > 0

    def issue(carry, t0: int, length: int):
        return issue_chunk(tick, carry, t0, length, cap=cap, V=V, R=R,
                           J=J, instance_ids=instance_ids, scan_k=scan_k,
                           with_stats=heartbeat is not None,
                           device=device)

    from .aot_store import finalize_record, wrap_pipelined
    wrapped, aot_rec = wrap_pipelined(
        issue, model=model, sim=sim, instance_ids=instance_ids, cap=cap,
        scan_k=scan_k, stats=heartbeat is not None, device=device,
        store_dir=aot_store)
    if wrapped is not None:
        issue = wrapped
    first_dispatch_s = None

    pending = None
    issued = 0
    chunks = resume.chunks if resume is not None else 0
    ticks_dispatched = resume.ticks if resume is not None else 0
    stopped = False
    with torch.no_grad():
        for i, (t0, length) in enumerate(plans):
            t_i = time.monotonic()
            prof_rec = None
            if profiler is not None and profiler.should_capture(chunks):
                (carry, out), prof_rec = profiler.capture(
                    issue, (carry, t0, length), length,
                    devices=[instance_ids.device])
            else:
                carry, out = issue(carry, t0, length)
            fetch = start_fetch(*out)
            if first_dispatch_s is None:
                first_dispatch_s = time.monotonic() - t_start
            ticks_dispatched = t0 + length
            dt = time.monotonic() - t_i
            stats["chunk-issue-s"].append(round(dt, 4))
            stats["issue-s"] += dt
            # chunk k's copy is read once chunk k+1 is queued behind it
            tripped = (consume(*pending) if pending is not None
                       else False)
            pending = (fetch, chunks, t0, length, prof_rec)
            chunks += 1
            issued += 1
            if checkpoint_cb is not None and checkpoint_every > 0 \
                    and issued % checkpoint_every == 0 \
                    and i + 1 < len(plans):
                # a consistent cut: the chunk just issued is consumed,
                # and the carry is read before the next chunk is issued
                tripped = consume(*pending) or tripped
                pending = None
                t_c = time.monotonic()
                checkpoint_cb(carry, ticks_dispatched,
                              {"compact": list(compact),
                               "journal": list(journal),
                               "chunks": chunks})
                stats["checkpoint-s"].append(
                    round(time.monotonic() - t_c, 4))
            if fail_fast and tripped:
                stopped = True
                break
        if pending is not None:
            consume(*pending)
    perf = {"chunks": issued, "chunk-ticks": full_plans[0][1],
            "event-capacity": cap, "init-s": round(init_s, 4),
            "issue-s": round(stats["issue-s"], 4),
            "chunk-issue-s": stats["chunk-issue-s"],
            "fetch-s": round(stats["fetch-s"], 4),
            "overflowed-chunks": stats["overflowed-chunks"],
            "ticks-dispatched": ticks_dispatched}
    if first_dispatch_s is not None:
        perf["first-dispatch-s"] = round(first_dispatch_s, 4)
    if aot_rec is not None:
        perf["aot"] = finalize_record(aot_rec)
    if stats["checkpoint-s"]:
        perf["checkpoints"] = len(stats["checkpoint-s"])
        perf["checkpoint-s"] = round(sum(stats["checkpoint-s"]), 4)
        perf["checkpoint-save-s"] = stats["checkpoint-s"]
    if resume is not None:
        perf["resumed-from-ticks"] = resume.ticks
    if profiler is not None and profiler.records:
        perf["device"] = profiler.summary()
    if stopped:
        perf["stopped-early"] = True
    j_sends = j_recvs = None
    if J > 0 and journal:
        j_sends = np.concatenate([a for a, _ in journal], axis=0)
        j_recvs = np.concatenate([b for _, b in journal], axis=0)
    return PipelineResult(carry=carry, compact=compact, perf=perf,
                          scan=last_scan[0], journal_sends=j_sends,
                          journal_recvs=j_recvs)
