"""Kafka-style log checker.

Verifies per-key append-only log semantics over send / poll /
commit_offsets / list_committed_offsets histories:

- **duplicate offsets** — two acknowledged sends share (key, offset)
- **inconsistent offsets** — two polls disagree about the value at
  (key, offset)
- **internal nonmonotonic** — offsets within one poll op for a key go
  backwards
- **external nonmonotonic** — a process's successive polls of a key go
  backwards (it re-reads earlier offsets without a reassignment)
- **lost write** — an acknowledged send whose offset is below some
  later-polled offset for its key but which never appears in any poll
- **commit regression** — committed offsets for a key move backwards
- **aborted read** — a poll observed a value whose send DEFINITIVELY
  failed (a ``fail``-typed send or atomic txn): the G1a of the log
  world, and the tell of a broken transaction — a txn that errored
  after making some of its sends durable. Ops tagged ``non-atomic``
  (the sequential per-mop fallback for nodes without a txn RPC) are
  exempt, since partial prefixes are their documented semantics.

Histories may mix single-mop ops (``send`` / ``poll``) with multi-mop
``txn`` ops (``--txn`` mode: completion value = list of completed mops
``["send", k, [offset, v]]`` / ``["poll", {k: [[offset, v], ...]}]``);
txn mops run through the identical per-mop anomaly machinery.

Parity: the anomaly families of jepsen.tests.kafka's checker as used by
reference src/maelstrom/workload/kafka.clj (docstring :1-71); txn mode
mirrors jepsen.tests.kafka's :txn? op shape, which the reference harness
itself leaves disabled (kafka.clj:294).

A copy of ``maelstrom_tpu/checkers/kafka.py``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List


def _hashable(v):
    """Message values are ints in practice, but the protocol allows any
    JSON value; fold unhashables to a stable repr for set membership."""
    try:
        hash(v)
        return v
    except TypeError:
        return repr(v)


def mark_reassigned_after_crashes(history):
    """Crash-clients mode (device/TPU runtime): tag each process's
    first ok poll AFTER a crash completion as ``reassigned``.

    The native engine writes the flag onto its own records at reopen
    time; device clients are stateless rows, so the flag is derived
    host-side from the history order instead — sound because a client
    runs one op at a time, so any poll completed after its crash
    completed was necessarily served from the broker's already-reset
    cursor. Returns a new history (records are copied before
    mutation)."""
    crashed = set()
    out = []
    for r in history:
        f = r.get("f")
        proc = r.get("process")
        if f == "crash" and r.get("type") not in (None, "invoke"):
            crashed.add(proc)
        elif (f == "poll" and r.get("type") == "ok"
              and proc in crashed):
            r = dict(r, reassigned=True)
            crashed.discard(proc)
        out.append(r)
    return out


def kafka_checker(history) -> dict:
    from .linearizable import pairs
    anomalies: Dict[str, List[Any]] = defaultdict(list)

    acked = defaultdict(dict)       # key -> offset -> value
    polled = defaultdict(dict)      # key -> offset -> value
    failed_sends = defaultdict(set)  # key -> values of definite-fail sends
    max_polled = defaultdict(lambda: -1)
    last_poll_pos = defaultdict(lambda: -1)   # (process, key) -> offset
    commits = defaultdict(lambda: -1)         # (process, key) -> offset
    # key -> (max reported offset, completion index of that report)
    server_commits = defaultdict(lambda: (-1, -1))

    def handle_send(k, v, off):
        if off in acked[k] and acked[k][off] != v:
            anomalies["duplicate-offset"].append(
                {"key": k, "offset": off, "values": [acked[k][off], v]})
        acked[k][off] = v

    def handle_poll(value, process, reassigned):
        # value: {key: [[offset, value], ...]}
        for k, msgs in (value or {}).items():
            prev = -1
            for off, v in msgs:
                if off <= prev:
                    anomalies["internal-nonmonotonic"].append(
                        {"key": k, "offsets": [prev, off]})
                prev = off
                if off in polled[k] and polled[k][off] != v:
                    anomalies["inconsistent-offset"].append(
                        {"key": k, "offset": off,
                         "values": [polled[k][off], v]})
                polled[k][off] = v
                max_polled[k] = max(max_polled[k], off)
            if msgs:
                pk = (process, k)
                if msgs[0][0] <= last_poll_pos[pk] and not reassigned:
                    anomalies["external-nonmonotonic"].append(
                        {"key": k, "process": process,
                         "offsets": [last_poll_pos[pk], msgs[0][0]]})
                last_poll_pos[pk] = msgs[-1][0]

    for p in pairs(history):
        inv, comp = p["invoke"], p["complete"]
        if inv.get("process") == "nemesis":
            continue
        f = inv["f"]
        if comp is not None and comp["type"] == "fail":
            # definite failure: none of its sends may ever be observed
            # (non-atomic sequential fallbacks are exempt — their
            # documented semantics allow a durable prefix)
            non_atomic = inv.get("non-atomic") or comp.get("non-atomic")
            if f == "send":
                failed_sends[inv["value"][0]].add(_hashable(
                    inv["value"][1]))
            elif f == "txn" and not non_atomic:
                for mop in (inv["value"] or []):
                    if mop[0] == "send":
                        failed_sends[mop[1]].add(_hashable(mop[2]))
        if comp is None or comp["type"] != "ok":
            continue
        # a reassigned consumer (fresh client resuming from committed
        # offsets after a crash) may legally jump backwards; the flag
        # can ride either record
        reassigned = inv.get("reassigned") or comp.get("reassigned")
        if f == "send":
            handle_send(comp["value"][0], comp["value"][1],
                        comp["value"][2])
        elif f == "poll":
            handle_poll(comp["value"], inv["process"], reassigned)
        elif f == "txn":
            # multi-mop transaction: completion value is the list of
            # completed mops, ["send", k, [off, v]] / ["poll", msgs].
            # Each mop feeds the same per-mop anomaly machinery; within
            # one txn only the first poll may ride the reassignment.
            for mop in (comp["value"] or []):
                if mop[0] == "send":
                    k, (off, v) = mop[1], mop[2]
                    handle_send(k, v, off)
                elif mop[0] == "poll":
                    handle_poll(mop[1], inv["process"], reassigned)
                    reassigned = False
        elif f == "commit_offsets":
            # the client fills the committed offsets on the completion
            # record (the invoke value is a placeholder). A lagging
            # *other* client may legitimately commit lower offsets, so
            # monotonicity is judged per process...
            for k, off in (comp["value"] or {}).items():
                pk = (inv["process"], k)
                if off < commits[pk]:
                    anomalies["commit-regression"].append(
                        {"key": k, "process": inv["process"],
                         "offsets": [commits[pk], off]})
                commits[pk] = max(commits[pk], off)
        elif f == "list_committed_offsets":
            # ...and globally on what the SERVER reports back — but only
            # between non-overlapping ops: a query that overlapped an
            # earlier one in real time may legally have read first
            for k, off in (comp["value"] or {}).items():
                prev_off, prev_end = server_commits[k]
                if off < prev_off and inv["index"] > prev_end:
                    anomalies["commit-regression"].append(
                        {"key": k, "server-reported": True,
                         "offsets": [prev_off, off]})
                if off > prev_off:
                    server_commits[k] = (off, comp["index"])

    # lost writes: acked offset below the key's max polled offset but
    # never observed by any poll
    for k, offs in acked.items():
        for off, v in offs.items():
            if off < max_polled[k] and off not in polled[k]:
                anomalies["lost-write"].append(
                    {"key": k, "offset": off, "value": v})

    # aborted reads: polled values whose send definitively failed
    for k, offs in polled.items():
        for off, v in offs.items():
            if _hashable(v) in failed_sends[k]:
                anomalies["aborted-read"].append(
                    {"key": k, "offset": off, "value": v})

    return {
        "valid?": not anomalies,
        "anomaly-types": sorted(anomalies),
        "anomalies": {k: v[:8] for k, v in anomalies.items()},
        "send-count": sum(len(v) for v in acked.values()),
        "poll-count": sum(len(v) for v in polled.values()),
    }
