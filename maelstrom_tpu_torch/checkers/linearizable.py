"""Linearizability checker for register histories (read / write / cas).

A copy of ``maelstrom_tpu/checkers/linearizable.py``'s pure-Python
Wing & Gong / Lowe search (memoized DFS over linearization points,
quiescent-cut segmentation, an explicit work budget that yields
``"unknown"``), checked per key. As in the JAX package, each key goes
to the native core first (``native.py``, built from
``cpp/checker/wgl.cpp``) with ten times the state budget, and to the
Python search only when the core cannot take the case.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Set, Tuple

INF = float("inf")

# Sentinel for "budget exhausted / can't tell".
UNKNOWN = "unknown"


@dataclass
class _Op:
    idx: int          # dense index for bitmask (within its segment)
    f: str            # read / write / cas
    args: Any         # read: None; write: v; cas: (frm, to)
    ret: Any          # read: observed value; others: None
    inv: float        # invocation time
    end: float        # completion time (INF for info ops)
    required: bool    # must be linearized (ok) vs optional (info)


def _apply(state, op: _Op) -> Tuple[bool, Any]:
    """Sequential register semantics. Returns (legal, new_state)."""
    if op.f == "read":
        if op.required:
            return (op.ret == state), state
        return True, state  # info read: any return possible
    if op.f == "write":
        return True, op.args
    if op.f == "cas":
        frm, to = op.args
        if state == frm:
            return True, to
        # cas that returned ok must have matched; an info cas may simply
        # have failed server-side -> also allow "no effect" via skip branch
        return False, state
    raise ValueError(f"unknown register op {op.f}")


def _final_states(ops: List[_Op], init_states: Set[Any],
                  budget: List[int]) -> Optional[Set[Any]]:
    """WGL search over one segment from each possible initial state.

    Returns the set of register states reachable at the end of a
    complete linearization (all required ops placed; pending info ops
    optionally placed) — empty set means the segment is NOT
    linearizable from any given initial state. ``None`` means the
    search budget ran out (indeterminate). ``budget`` is a one-element
    mutable cell of remaining visited-state credits shared across
    segments of a key.
    """
    required_mask = 0
    for o in ops:
        if o.required:
            required_mask |= 1 << o.idx

    def min_end(linearized: int) -> float:
        m = INF
        for o in ops:
            if not (linearized >> o.idx) & 1 and o.end < m:
                m = o.end
        return m

    out: Set[Any] = set()
    seen = set()
    # iterative DFS over (linearized_mask, state)
    for init in init_states:
        stack = [(0, init)]
        while stack:
            linearized, state = stack.pop()
            key = (linearized, state)
            if key in seen:
                continue
            seen.add(key)
            # budget counts WORK (successor scans ~ n per state), not
            # just states, so a wide segment can't run for hours before
            # yielding unknown
            budget[0] -= max(1, len(ops))
            if budget[0] <= 0:
                return None
            if (linearized & required_mask) == required_mask:
                # complete linearization: pending info ops may or may
                # not have taken effect, but writes/cas among them can
                # still change the final state. Record this state; the
                # DFS will also explore placing remaining info ops.
                out.add(state)
            bound = min_end(linearized)
            for o in ops:
                if (linearized >> o.idx) & 1:
                    continue
                if o.inv > bound:
                    continue  # real-time order violated
                legal, new_state = _apply(state, o)
                if legal:
                    stack.append((linearized | (1 << o.idx), new_state))
    return out


def _segments(ops: List[_Op]) -> List[List[_Op]]:
    """Split ops at quiescent cuts: boundaries T where every op invoked
    before T completed before T (pending/info ops bar all later cuts)."""
    ops = sorted(ops, key=lambda o: o.inv)
    segs: List[List[_Op]] = []
    cur: List[_Op] = []
    frontier = -INF  # max completion time of ops in current segment
    for o in ops:
        if cur and frontier < o.inv:
            segs.append(cur)
            cur = []
        cur.append(o)
        frontier = max(frontier, o.end)
    if cur:
        segs.append(cur)
    # reindex per segment for compact bitmasks
    for seg in segs:
        for i, o in enumerate(seg):
            o.idx = i
    return segs


def check_register_history(ops: List[_Op], init_state=None,
                           budget_states: int = 2_000_000):
    """Segmented WGL search. True / False / UNKNOWN (budget exhausted)."""
    budget = [budget_states]
    states: Set[Any] = {init_state}
    for seg in _segments(ops):
        nxt = _final_states(seg, states, budget)
        if nxt is None:
            return UNKNOWN
        if not nxt:
            return False
        states = nxt
    return True


def pairs(history) -> List[Dict[str, Optional[dict]]]:
    """Match invokes with their completions per process. An invoke with no
    completion (still pending at test end) pairs with None."""
    open_ops: Dict = {}
    out = []
    for r in history:
        p = r.get("process")
        if r["type"] == "invoke":
            entry = {"invoke": r, "complete": None}
            open_ops[p] = entry
            out.append(entry)
        elif r["type"] in ("ok", "fail", "info") and p in open_ops:
            open_ops.pop(p)["complete"] = r
    return out


def _collect_ops(history, key) -> List[_Op]:
    """Build per-key op list from invoke/complete pairs."""
    ops: List[_Op] = []
    for p in pairs(history):
        inv, comp = p["invoke"], p["complete"]
        if inv.get("process") == "nemesis":
            continue
        v = inv["value"]
        if not (isinstance(v, (list, tuple)) and len(v) == 2):
            continue
        k, arg = v
        if k != key:
            continue
        f = inv["f"]
        ctype = comp["type"] if comp is not None else "info"
        if ctype == "fail":
            continue  # definitely didn't happen
        required = ctype == "ok"
        end = comp["time"] if required else INF
        if f == "read":
            ret = comp["value"][1] if (required and
                                       isinstance(comp["value"],
                                                  (list, tuple))) else None
            ops.append(_Op(0, "read", None, ret, inv["time"], end, required))
        elif f == "write":
            ops.append(_Op(0, "write", arg, None, inv["time"], end,
                           required))
        elif f == "cas":
            ops.append(_Op(0, "cas", tuple(arg), None, inv["time"], end,
                           required))
    for i, o in enumerate(ops):
        o.idx = i
    return ops


def linearizable_kv_checker(history, max_ops_per_key: int = 10_000,
                            budget_states: int = 2_000_000) -> dict:
    """Check a multi-key register history key by key.

    Verdict: ``False`` if any key is non-linearizable; ``"unknown"`` if
    none is but some key was indeterminate (over the op cap or out of
    search budget); ``True`` only when every key fully checked clean.
    """
    keys = set()
    for r in history:
        if r["type"] == "invoke" and isinstance(r.get("value"),
                                                (list, tuple)) \
                and len(r["value"]) == 2:
            keys.add(r["value"][0])
    from .native import check_register_history_native
    bad_keys = []
    unknown_keys = []
    for key in sorted(keys, key=repr):
        ops = _collect_ops(history, key)
        if len(ops) > max_ops_per_key:
            unknown_keys.append(key)
            continue
        # the core's work unit costs ~1/10 of the Python search's: 10x
        # the budget for the same time (None: a case it cannot take)
        verdict = check_register_history_native(ops, budget_states * 10)
        if verdict is None:
            verdict = check_register_history(ops,
                                             budget_states=budget_states)
        if verdict is False:
            bad_keys.append(key)
        elif verdict == UNKNOWN:
            unknown_keys.append(key)
    valid: Any
    if bad_keys:
        valid = False
    elif unknown_keys:
        valid = UNKNOWN
    else:
        valid = True
    return {
        "valid?": valid,
        "key-count": len(keys),
        "bad-keys": bad_keys,
        "unknown-keys": unknown_keys,
    }
