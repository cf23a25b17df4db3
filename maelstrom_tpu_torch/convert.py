"""State carried across: a JAX-runtime carry <-> the port's :class:`Carry`.

The JAX package's ``Carry`` (lead layout) with its leaves turned into
numpy arrays — keys as uint32 — maps field by field onto the port's
carry on any device, and back. Fields are matched by name (NamedTuple
``_fields``), so this module needs nothing of the JAX package: the
simulation state is the whole carry (a model's static params, such as a
topology's adjacency matrix, are rebuilt from its options), and a JAX
carry at tick ``t`` handed over here continues as the port's tick
``t + 1``. Node state and the slab come in three shapes: a bare array
(the legacy models: a scalar per node for echo and unique-ids, two
bitmask words for the gossip sets, an ``[N, 2]`` table for the
counters), a row tuple (Raft and the txn models' ``RaftRow``, whose kv
is ``[N, n_keys, 1 + list_cap]`` for list-append; kafka's ``KafkaRow``,
also its slab), and a dict of lanes (the Raft and txn slab).
"""

from __future__ import annotations

from typing import Any, Iterator, Tuple

import numpy as np
import torch

from .faults.fuzz import FaultSchedule
from .netsim import NetStats
from .runtime import Carry, ClientState
from .telemetry.recorder import Telemetry
from .tree import tree_map


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.astype(np.int64)).to(device)
    if a.dtype == np.bool_:
        return torch.from_numpy(a.copy()).to(device)
    return torch.from_numpy(a.astype(np.int32)).to(device)


def _tuple(cls, src, device):
    return cls(*(_to_tensor(getattr(src, f), device) for f in cls._fields))


def _state(src, row_type, device):
    """Node state or a slab: a row tuple (matched to ``row_type`` by
    field name), a dict of lanes, a bare array, or None."""
    if src is None:
        return None
    if hasattr(src, "_fields"):
        return _tuple(row_type, src, device)
    if isinstance(src, dict):
        return {k: _to_tensor(v, device) for k, v in src.items()}
    return _to_tensor(src, device)


def carry_from_numpy(src: Any, row_type=None, device=None) -> Carry:
    """Build the port's carry from a carry-like object with numpy (or
    array-like) leaves: ``pool``, ``node_state`` (a bare array, as the
    legacy models keep it, or a tuple with the fields of ``row_type``),
    ``client_state``, ``stats``, ``violations``, ``key``, and the
    optional ``telemetry``, ``snapshots`` (the slab: an array, or a dict
    of durable lanes), ``fault_sched`` and ``check_summary`` (None when
    absent)."""
    tel = getattr(src, "telemetry", None)
    sched = getattr(src, "fault_sched", None)
    summ = getattr(src, "check_summary", None)
    return Carry(
        pool=_to_tensor(src.pool, device),
        node_state=_state(src.node_state, row_type, device),
        client_state=_tuple(ClientState, src.client_state, device),
        stats=_tuple(NetStats, src.stats, device),
        violations=_to_tensor(src.violations, device),
        key=_to_tensor(src.key, device),
        telemetry=None if tel is None else _tuple(Telemetry, tel, device),
        snapshots=_state(getattr(src, "snapshots", None), row_type, device),
        fault_sched=(None if sched is None
                     else _tuple(FaultSchedule, sched, device)),
        check_summary=None if summ is None else _to_tensor(summ, device),
    )


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def carry_to_numpy(carry: Carry) -> Carry:
    """The port's carry with numpy leaves (int32/bool; the key as uint32,
    as the JAX carry holds it)."""
    return tree_map(_np, carry)._replace(
        key=_np(carry.key).astype(np.uint32))


def carry_leaves(carry: Any, prefix: str = "carry"
                 ) -> Iterator[Tuple[str, np.ndarray]]:
    """``(name, array)`` for every leaf of a carry with numpy leaves
    (NamedTuples by field, dicts by key, ``None`` skipped). A JAX carry
    with numpy leaves walks the same way, so two carries compare leaf
    by leaf."""
    if isinstance(carry, tuple) and hasattr(carry, "_fields"):
        for f in carry._fields:
            yield from carry_leaves(getattr(carry, f), f"{prefix}.{f}")
    elif isinstance(carry, dict):
        for k in sorted(carry):
            yield from carry_leaves(carry[k], f"{prefix}.{k}")
    elif carry is not None:
        yield prefix, np.asarray(carry)
