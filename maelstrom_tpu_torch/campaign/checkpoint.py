"""Atomic carry checkpoints: kill a chunked run, resume it bit-exactly.

Counterpart of ``maelstrom_tpu/campaign/checkpoint.py``, in the same
file format. Every K chunks the chunked executor (``pipeline.py``)
hands this module a consistent cut, and it persists everything a
continuation needs:

- the **carry**, copied to the host before the next chunk is issued,
  its leaves in the JAX package's leaf order (``convert.carry_leaves``:
  NamedTuple fields in order, dict lanes by sorted key, ``None``
  skipped) and dtypes (int32 and bool, the master key as uint32). The
  key is a carry leaf that never advances (every draw folds in
  ``(purpose, tick, instance)``), so carrying the carry is carrying
  the RNG state;
- the **host accumulators**: the compacted event rows and journal
  blocks (the sharded executor's dense event chunks) of every chunk
  consumed so far, so the resumed run's histories cover the whole
  horizon;
- the tick frontier and the chunk cursor, so the resumed plan is the
  exact suffix of the original one.

Durability: one ``state.npz`` written as ``state.npz.tmp-<pid>`` and
then ``os.replace``d into place, so a kill at any point leaves either
the previous checkpoint or the new one, never a torn file. The two
packages write the same keys (``carry/NNN``, ``compact_rows/NNNN``,
``compact_counts``, ``journal_send/NNNN``, ``journal_recv/NNNN``,
``events/NNNN``, ``__meta__``) under the same schema-1 header, so a
checkpoint of either resumes in the other.

A ``"sharded"`` checkpoint holds the sharded executor's global wire
carry (``parallel/mesh.py``) with per-leaf shard metadata in
``meta["shard"]``; :func:`restore_carry` reshards it onto another shard
count (:func:`reshard_carry`), so a run written at S shards resumes at
S'.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import convert
from ..parallel.mesh import (SHARD_LEAF_INSTANCE, SHARD_LEAF_KEY,
                             SHARD_LEAF_SUM)

CHECKPOINT_DIR = "checkpoint"
CHECKPOINT_FILE = "state.npz"
CHECKPOINT_SCHEMA = 1

# executor kinds a checkpoint can belong to; resume refuses a mismatch
KIND_PIPELINED = "pipelined"
KIND_SHARDED = "sharded"


class CheckpointError(ValueError):
    """A checkpoint that cannot be saved, loaded or restored."""


def checkpoint_path(run_dir: str) -> str:
    return os.path.join(run_dir, CHECKPOINT_DIR, CHECKPOINT_FILE)


def _leaves(state: Any) -> List[np.ndarray]:
    """The carry's leaves in the JAX leaf order: a carry of tensors is
    copied to the host first (synchronously: the caller issues the next
    chunk only after this returns)."""
    if isinstance(state.pool, torch.Tensor):
        state = convert.carry_to_numpy(state)
    return [np.asarray(a) for _, a in convert.carry_leaves(state)]


def save_checkpoint(run_dir: str, *, kind: str, state: Any, ticks: int,
                    chunks: int,
                    compact: Tuple[Tuple[np.ndarray, int], ...] = (),
                    journal: Tuple[Tuple[np.ndarray, np.ndarray],
                                   ...] = (),
                    events: Tuple[np.ndarray, ...] = (),
                    meta: Optional[Dict[str, Any]] = None) -> str:
    """Write one atomic checkpoint under ``<run_dir>/checkpoint/``.

    ``state`` is the port's carry (tensors on any device) or a carry
    with numpy leaves (the sharded executor's global wire). ``events``
    are the sharded executor's dense event chunks. Returns the
    checkpoint path."""
    path = checkpoint_path(run_dir)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    leaves = _leaves(state)
    for i, leaf in enumerate(leaves):
        arrays[f"carry/{i:03d}"] = leaf
    for i, (rows, count) in enumerate(compact):
        arrays[f"compact_rows/{i:04d}"] = np.asarray(rows)
    arrays["compact_counts"] = np.asarray(
        [int(c) for _, c in compact], np.int64)
    for i, (sends, recvs) in enumerate(journal):
        arrays[f"journal_send/{i:04d}"] = np.asarray(sends)
        arrays[f"journal_recv/{i:04d}"] = np.asarray(recvs)
    for i, ev in enumerate(events):
        arrays[f"events/{i:04d}"] = np.asarray(ev)
    header = {
        "schema": CHECKPOINT_SCHEMA, "kind": kind,
        "ticks": int(ticks), "chunks": int(chunks),
        "n-carry-leaves": len(leaves), "n-compact": len(compact),
        "n-journal": len(journal), "n-events": len(events),
        "meta": meta or {},
    }
    arrays["__meta__"] = np.frombuffer(
        json.dumps(header).encode(), dtype=np.uint8)
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)   # the atomicity pivot: old XOR new
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_checkpoint(run_dir: str) -> Optional[Dict[str, Any]]:
    """Load a run dir's checkpoint; ``None`` when none was written.
    Stale ``*.tmp-*`` siblings (a writer killed mid-write) are ignored:
    the rename pivot means ``state.npz`` is always a complete file."""
    path = checkpoint_path(run_dir)
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            header = json.loads(bytes(z["__meta__"]).decode())
            if header.get("schema") != CHECKPOINT_SCHEMA:
                raise CheckpointError(
                    f"{path}: unsupported checkpoint schema "
                    f"{header.get('schema')!r}")
            carry = [z[f"carry/{i:03d}"]
                     for i in range(header["n-carry-leaves"])]
            counts = z["compact_counts"]
            compact = [(z[f"compact_rows/{i:04d}"], int(counts[i]))
                       for i in range(header["n-compact"])]
            journal = [(z[f"journal_send/{i:04d}"],
                        z[f"journal_recv/{i:04d}"])
                       for i in range(header["n-journal"])]
            events = [z[f"events/{i:04d}"]
                      for i in range(header["n-events"])]
    except CheckpointError:
        raise
    except Exception as e:
        raise CheckpointError(f"unreadable checkpoint {path}: {e!r}")
    return {"kind": header["kind"], "ticks": header["ticks"],
            "chunks": header["chunks"], "carry": carry,
            "compact": compact, "journal": journal, "events": events,
            "meta": header.get("meta", {}), "path": path}


def reshard_carry(leaves: List[np.ndarray], shard: Dict[str, Any],
                  n_shards: int) -> Tuple[List[np.ndarray], Dict[str, Any]]:
    """Re-chunk a sharded wire carry written at S shards onto
    ``n_shards`` shards, leaf by leaf, by the per-leaf kinds the sharded
    executor recorded (``parallel/mesh.wire_leaf_kinds``):

    - ``"instance"`` leaves hold the global instance axis round-robin
      interleaved shard-major: a pure permutation of the leading axis
      (de-interleave at S, re-interleave at S'), no instance's state
      changes, so the global-id RNG keeps every trajectory;
    - ``"sum"`` leaves are per-shard partial sums (NetStats, the fleet
      telemetry series): old slots fold into the new ones round-robin;
      int32 addition wraps and commutes, so the fleet totals are kept;
    - ``"key"`` is the replicated master key: checked equal across the
      old shards, then tiled to the new count.

    Returns ``(new_leaves, new_shard_meta)``."""
    S = int(shard.get("n-shards", 0))
    I = int(shard.get("instances-per-shard", 0))
    kinds = list(shard.get("leaf-kinds", ()))
    n_shards = int(n_shards)
    total = S * I
    if S <= 0 or I <= 0 or not kinds:
        raise CheckpointError(
            "checkpoint lacks per-leaf shard metadata (written before "
            "reshardable checkpoints) — cannot reshard")
    if n_shards <= 0 or total % n_shards:
        raise CheckpointError(
            f"cannot reshard {total} global instances "
            f"({S} shards x {I}) onto {n_shards} shards — the global "
            f"instance count must divide evenly")
    if len(kinds) != len(leaves):
        raise CheckpointError(
            f"shard metadata covers {len(kinds)} leaves but the "
            f"checkpoint has {len(leaves)}")
    out: List[np.ndarray] = []
    for i, (leaf, kind) in enumerate(zip(leaves, kinds)):
        leaf = np.asarray(leaf)
        rest = leaf.shape[1:]
        if kind == SHARD_LEAF_INSTANCE:
            if leaf.shape[0] != total:
                raise CheckpointError(
                    f"carry leaf {i} ({kind}): leading axis "
                    f"{leaf.shape[0]} != {total} global instances")
            g = leaf.reshape((S, I) + rest).swapaxes(0, 1).reshape(
                leaf.shape)                      # global-id order
            i2 = total // n_shards
            out.append(g.reshape((i2, n_shards) + rest)
                       .swapaxes(0, 1).reshape(leaf.shape).copy())
        elif kind == SHARD_LEAF_SUM:
            if leaf.shape[0] != S:
                raise CheckpointError(
                    f"carry leaf {i} ({kind}): leading axis "
                    f"{leaf.shape[0]} != {S} shard slots")
            new = np.zeros((n_shards,) + rest, leaf.dtype)
            for s in range(S):
                new[s % n_shards] = new[s % n_shards] + leaf[s]
            out.append(new)
        elif kind == SHARD_LEAF_KEY:
            if leaf.shape[0] != S:
                raise CheckpointError(
                    f"carry leaf {i} ({kind}): leading axis "
                    f"{leaf.shape[0]} != {S} shard slots")
            if any(not np.array_equal(leaf[0], leaf[s])
                   for s in range(1, S)):
                raise CheckpointError(
                    "master RNG key differs across shards — the "
                    "checkpoint predates the global-instance-id "
                    "sharded RNG and cannot be resharded")
            out.append(np.broadcast_to(
                leaf[:1], (n_shards,) + rest).copy())
        else:
            raise CheckpointError(
                f"carry leaf {i}: unknown shard kind {kind!r}")
    meta = dict(shard)
    meta["n-shards"] = n_shards
    meta["instances-per-shard"] = total // n_shards
    return out, meta


def _template_shards(t_leaves, kinds) -> Optional[int]:
    """The resume mesh's shard count read off a wire template: the
    leading axis of any per-shard ("sum" or "key") leaf."""
    for t, kind in zip(t_leaves, kinds):
        if kind in (SHARD_LEAF_SUM, SHARD_LEAF_KEY) and len(t.shape):
            return int(t.shape[0])
    return None


def restore_carry(template: Any, leaves: List[np.ndarray],
                  shard: Optional[Dict[str, Any]] = None,
                  device=None) -> Any:
    """Rebuild the port's carry from checkpointed leaves, in the
    structure of ``template`` (a freshly initialized carry of the same
    model and options, tensors or numpy leaves; for a sharded run,
    ``parallel.mesh.wire_template``), on ``device``.

    A leaf count, shape or dtype that differs from the template's means
    the run is being resumed under another configuration: refused, never
    reinterpreted; a change of exactly the pool's lane width is named as
    one (the NETID lane: narrow against netid or journaling runs). One
    exception: a sharded checkpoint (``shard`` = its ``meta["shard"]``)
    whose mismatch is a pure shard-count change is resharded onto the
    template's shard count (:func:`reshard_carry`).
    """
    if isinstance(template.pool, torch.Tensor):
        template = convert.carry_to_numpy(template)
    t_leaves = [a for _, a in convert.carry_leaves(template)]
    if shard is not None and len(t_leaves) == len(leaves):
        ck_shards = int(shard.get("n-shards", 0))
        ck_per = int(shard.get("instances-per-shard", 0))
        kinds = list(shard.get("leaf-kinds", ()))
        new_shards = (_template_shards(t_leaves, kinds)
                      if len(kinds) == len(t_leaves) else None)
        if (new_shards is not None and ck_shards > 0
                and new_shards != ck_shards):
            total = ck_shards * ck_per
            t_total = next(
                (int(t.shape[0]) for t, k in zip(t_leaves, kinds)
                 if k == SHARD_LEAF_INSTANCE and len(t.shape)), total)
            if t_total != total:
                raise CheckpointError(
                    f"carry saved at {ck_shards} shards, mesh has "
                    f"{new_shards} — resharding via reshard_carry "
                    f"needs the same global fleet, but the checkpoint "
                    f"holds {total} instances ({ck_shards} x {ck_per}) "
                    f"and the resume config expects {t_total}")
            leaves, shard = reshard_carry(leaves, shard, new_shards)
    if len(t_leaves) != len(leaves):
        raise CheckpointError(
            f"checkpoint has {len(leaves)} carry leaves but the "
            f"rebuilt config produces {len(t_leaves)} — the resume "
            f"config does not match the checkpointed run")
    mismatches = [
        i for i, (t, v) in enumerate(zip(t_leaves, leaves))
        if tuple(t.shape) != tuple(v.shape) or t.dtype != v.dtype]
    if mismatches:
        i = mismatches[0]
        t, v = t_leaves[i], leaves[i]
        ts, vs = tuple(t.shape), tuple(v.shape)
        hint = ""
        # a wire-format width change (the optional trailing NETID lane)
        # mismatches exactly the pool leaf, the carry's first, on one
        # axis by one lane; wider drift (instances, slots, nodes)
        # mismatches other leaves too and keeps the plain message
        if (mismatches == [0] and len(ts) == len(vs) and
                t.dtype == v.dtype and
                sum(a != b for a, b in zip(ts, vs)) == 1 and
                abs(sum(ts) - sum(vs)) == 1):
            hint = (" — a message-row LANE-WIDTH change: the "
                    "checkpoint was taken under a different wire "
                    "format (narrow vs netid/journaling); resume "
                    "with the run's recorded wire format "
                    "(heartbeat run-start `wire-format`, the "
                    "netid/journal_instances opts)")
        elif shard is not None and int(shard.get("n-shards", 0)) > 0:
            hint = (f" — carry saved at "
                    f"{int(shard['n-shards'])} shards "
                    f"({int(shard.get('instances-per-shard', 0))} "
                    f"instances/shard); a pure mesh-size change "
                    f"reshards via reshard_carry, anything else is "
                    f"config drift")
        raise CheckpointError(
            f"carry leaf {i}: checkpoint {vs}/{v.dtype} vs "
            f"rebuilt {ts}/{t.dtype} — the resume config does "
            f"not match the checkpointed run" + hint)
    node_state = template.node_state
    row_type = type(node_state) if hasattr(node_state, "_fields") else None
    return convert.carry_from_numpy(
        convert.carry_with_leaves(template, leaves), row_type, device)


def make_checkpoint_cb(run_dir: str, *, kind: str,
                       meta: Optional[Dict[str, Any]] = None):
    """The executor-facing sink: a ``cb(carry, ticks, host)`` closure for
    ``run_sim_pipelined``'s and ``run_sim_sharded_chunked``'s
    ``checkpoint_cb``, ``host`` being the executor's accumulators
    (``compact``, ``journal``, ``events``, ``chunks``, and the sharded
    executor's per-leaf reshard metadata under ``shard``, kept in the
    header's ``meta``)."""
    def cb(state, ticks, host: Dict[str, Any]) -> None:
        m = dict(meta or {})
        if host.get("shard"):
            m["shard"] = host["shard"]
        save_checkpoint(
            run_dir, kind=kind, state=state, ticks=ticks,
            chunks=int(host.get("chunks", 0)),
            compact=tuple(host.get("compact", ())),
            journal=tuple(host.get("journal", ())),
            events=tuple(host.get("events", ())),
            meta=m or None)
    return cb
