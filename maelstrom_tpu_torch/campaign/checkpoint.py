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
  blocks of every chunk consumed so far, so the resumed run's histories
  cover the whole horizon;
- the tick frontier and the chunk cursor, so the resumed plan is the
  exact suffix of the original one.

Durability: one ``state.npz`` written as ``state.npz.tmp-<pid>`` and
then ``os.replace``d into place, so a kill at any point leaves either
the previous checkpoint or the new one, never a torn file. The two
packages write the same keys (``carry/NNN``, ``compact_rows/NNNN``,
``compact_counts``, ``journal_send/NNNN``, ``journal_recv/NNNN``,
``__meta__``) under the same schema-1 header, so a single-device
checkpoint of either resumes in the other.

The port runs on one device: a ``"sharded"`` checkpoint (the JAX
package's mesh executor) and :func:`reshard_carry` raise
:class:`CheckpointError`, naming the multi-GPU port they wait for.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import convert

CHECKPOINT_DIR = "checkpoint"
CHECKPOINT_FILE = "state.npz"
CHECKPOINT_SCHEMA = 1

# executor kinds a checkpoint can belong to; resume refuses a mismatch
KIND_PIPELINED = "pipelined"
KIND_SHARDED = "sharded"

SHARDED_REFUSAL = (
    "sharded checkpoints (the JAX package's mesh executor, and "
    "reshard_carry onto another shard count) wait for the multi-GPU "
    "port of maelstrom_tpu_torch; resume this run with python -m "
    "maelstrom_tpu campaign resume")


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
                    meta: Optional[Dict[str, Any]] = None) -> str:
    """Write one atomic checkpoint under ``<run_dir>/checkpoint/``.

    ``state`` is the port's carry (tensors on any device) or a carry
    with numpy leaves. Returns the checkpoint path. (The JAX sharded
    executor's dense event chunks, ``events/NNNN``, have no counterpart
    here: ``n-events`` is 0.)"""
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
    header = {
        "schema": CHECKPOINT_SCHEMA, "kind": kind,
        "ticks": int(ticks), "chunks": int(chunks),
        "n-carry-leaves": len(leaves), "n-compact": len(compact),
        "n-journal": len(journal), "n-events": 0,
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
                  n_shards: int):
    """Re-chunking a sharded carry onto another shard count: refused,
    the multi-GPU port is not there yet."""
    raise CheckpointError(SHARDED_REFUSAL)


def restore_carry(template: Any, leaves: List[np.ndarray],
                  shard: Optional[Dict[str, Any]] = None,
                  device=None) -> Any:
    """Rebuild the port's carry from checkpointed leaves, in the
    structure of ``template`` (a freshly initialized carry of the same
    model and options, tensors or numpy leaves), on ``device``.

    A leaf count, shape or dtype that differs from the template's means
    the run is being resumed under another configuration: refused, never
    reinterpreted; a change of exactly the pool's lane width is named as
    one (the NETID lane: narrow against netid or journaling runs). A
    checkpoint with shard metadata is refused (:data:`SHARDED_REFUSAL`).
    """
    if shard is not None:
        raise CheckpointError(SHARDED_REFUSAL)
    if isinstance(template.pool, torch.Tensor):
        template = convert.carry_to_numpy(template)
    t_leaves = [a for _, a in convert.carry_leaves(template)]
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
    ``run_sim_pipelined``'s ``checkpoint_cb``, ``host`` being the
    executor's accumulators (``compact``, ``journal``, ``chunks``)."""
    def cb(state, ticks, host: Dict[str, Any]) -> None:
        save_checkpoint(
            run_dir, kind=kind, state=state, ticks=ticks,
            chunks=int(host.get("chunks", 0)),
            compact=tuple(host.get("compact", ())),
            journal=tuple(host.get("journal", ())),
            meta=dict(meta) if meta else None)
    return cb
