"""State carried across: a JAX-runtime carry <-> the port's :class:`Carry`.

The JAX package's ``Carry`` (lead layout) with its leaves turned into
numpy arrays — keys as uint32 — maps field by field onto the port's
carry on any device, and back. Fields are matched by name (NamedTuple
``_fields``), so this module needs nothing of the JAX package: the
simulation state is the whole carry (lin-kv Raft has no static model
parameters), and a JAX carry at tick ``t`` handed over here continues as the
port's tick ``t + 1``.
"""

from __future__ import annotations

from typing import Any, Iterator, Tuple

import numpy as np
import torch

from .faults.fuzz import FaultSchedule
from .netsim import NetStats
from .runtime import Carry, ClientState
from .telemetry.recorder import Telemetry


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.astype(np.int64)).to(device)
    if a.dtype == np.bool_:
        return torch.from_numpy(a.copy()).to(device)
    return torch.from_numpy(a.astype(np.int32)).to(device)


def _tuple(cls, src, device):
    return cls(*(_to_tensor(getattr(src, f), device) for f in cls._fields))


def carry_from_numpy(src: Any, row_type, device=None) -> Carry:
    """Build the port's carry from a carry-like object with numpy (or
    array-like) leaves: ``pool``, ``node_state`` (fields of
    ``row_type``), ``client_state``, ``stats``, ``violations``, ``key``,
    and the optional ``telemetry``, ``snapshots`` (a dict of durable
    lanes) and ``fault_sched`` (None when absent)."""
    tel = getattr(src, "telemetry", None)
    snaps = getattr(src, "snapshots", None)
    sched = getattr(src, "fault_sched", None)
    return Carry(
        pool=_to_tensor(src.pool, device),
        node_state=_tuple(row_type, src.node_state, device),
        client_state=_tuple(ClientState, src.client_state, device),
        stats=_tuple(NetStats, src.stats, device),
        violations=_to_tensor(src.violations, device),
        key=_to_tensor(src.key, device),
        telemetry=None if tel is None else _tuple(Telemetry, tel, device),
        snapshots=None if snaps is None else {
            k: _to_tensor(v, device) for k, v in snaps.items()},
        fault_sched=(None if sched is None
                     else _tuple(FaultSchedule, sched, device)),
    )


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def carry_to_numpy(carry: Carry) -> Carry:
    """The port's carry with numpy leaves (int32/bool; the key as uint32,
    as the JAX carry holds it)."""
    nt = lambda t: type(t)(*(_np(x) for x in t))
    return Carry(
        pool=_np(carry.pool),
        node_state=nt(carry.node_state),
        client_state=nt(carry.client_state),
        stats=nt(carry.stats),
        violations=_np(carry.violations),
        key=_np(carry.key).astype(np.uint32),
        telemetry=None if carry.telemetry is None else nt(carry.telemetry),
        snapshots=None if carry.snapshots is None else {
            k: _np(v) for k, v in carry.snapshots.items()},
        fault_sched=(None if carry.fault_sched is None
                     else nt(carry.fault_sched)),
    )


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
