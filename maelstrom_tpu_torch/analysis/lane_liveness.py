"""Lane-liveness dataflow analyzer: ``lint --lanes``.

Counterpart of ``maelstrom_tpu/analysis/lane_liveness.py``, with its
rules, messages, manifest and safety direction, over the port's aten
graph of the tick (``cost_model.TickGraph``) instead of a jaxpr. A
backward dataflow slice from the tick's observable outputs (history
events, telemetry, stats, violations, the key, and the carry fixed
point) back through ``select``/``slice``/``gather``/``scatter``/
``index``/``where``/``cat``/``stack``/``select_scatter``/
``slice_scatter``, resolving lane indices through the ``wire.py``
header constants (which reach the graph as the operators' int
arguments) and the constants baked into it (index tensors folded by
running their operators on the CPU).

Per model it computes:

- the **live message-lane set**: which of the 8 header + ``body_lanes``
  (+ optional trailing NETID) lanes are ever read on any reachable
  path;
- the **live carry-leaf map**: per-leaf live/dead/carried
  classification with byte attribution;
- **dead stores**: lanes written by the node/client/enqueue phases but
  never read before being overwritten or dropped.

Where it differs from the JAX pass, and why:

- **Pure operators.** Eager code writes in place (``x[..., VALID] =
  v``): a write through a view changes its base. The pass reads the
  tick recorded under ``torch.func.functionalize``, where each such
  write is a pure ``select_scatter`` / ``slice_scatter`` / ``copy`` of
  the base, as every equation of a jaxpr is pure.
- **Implicit broadcasting.** A jaxpr carries explicit
  ``broadcast_in_dim``; aten's elementwise operators broadcast their
  operands. An operand's axes are aligned to the output's from the
  right, and an axis of size 1 against a lane axis is a broadcast (the
  operand is read whole).
- **Tick variants.** The eager graph depends on the host int ``t``
  (``cost_model.tick_variants``). Each variant is analyzed; a lane is
  live if it is live in any, a carry leaf and a store are dead only if
  dead in every one.
- **No loops.** Eager loops unroll, so the JAX pass's scan and while
  rules have nothing to apply to.
- **LNE610** checks the native C++ engine's per-family widths
  (``cpp/engine/sim.cpp``) against the port's width table
  (``native/wire.py``), its model registry and the built library, which
  the port always builds (``native/engine.py``): the JAX pass skips the
  library where it cannot build it.

Rules (LNE6xx):

=======  =======================  ========  ===============================
rule     name                     severity  what it flags
=======  =======================  ========  ===============================
LNE600   lane-manifest-updated    info      ``--update-manifest`` rewrote
                                            the manifest
LNE601   dead-body-lane           warning   a declared body lane is never
                                            read on any reachable path
LNE602   dead-carry-leaf          warning   a carry leaf feeds no
                                            observable output (not even
                                            through the carry fixed point)
LNE603   dead-store               warning   a body lane is written but
                                            never read before being
                                            overwritten or dropped
LNE604   lane-overread            error     a resolved lane index reaches
                                            outside the model's declared
                                            lane universe
LNE605   lane-unresolvable        warning   a lane index could not be
                                            resolved statically — the
                                            analysis fell back to
                                            conservative all-live for the
                                            model
LNE606   lane-manifest-drift      error     the live lane set differs from
                                            the checked-in manifest entry
                                            (warning + a re-record hint
                                            when the manifest was recorded
                                            under another torch version)
LNE607   lane-manifest-missing    error     a registered model has no
                                            manifest entry
LNE608   lane-manifest-stale      warning   a manifest entry matches no
                                            registered model
LNE609   lane-analysis-failure    error     ``get_model`` or the lane
                                            analysis itself raised
LNE610   native-width-divergence  error     the native engine's templated
                                            per-family constants, the
                                            Python width table
                                            (``native/wire.py``), the
                                            model registry's lane math,
                                            or the built library disagree
=======  =======================  ========  ===============================

Safety direction: the live set OVERAPPROXIMATES — every transfer rule
either models an operator exactly or demands all lanes of its inputs,
and any unresolvable lane index widens the whole model to all-live
(LNE605). A lane the manifest calls dead is therefore provably unread
under the audit config (``tests/test_torch_lanes.py`` pins the
end-to-end version: narrowing a fixture's ``body_lanes`` to its live
set leaves the trajectory bit-identical).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import (AbstractSet, Any, Dict, List, Optional, Sequence, Set,
                    Tuple)

import numpy as np
import torch

from . import cost_model
from .cost_model import Ref, TickGraph, TNode
from .findings import Finding, SEV_ERROR, SEV_INFO, SEV_WARNING

PASS_NAME = "lanes"

DEFAULT_LANE_MANIFEST = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "lane_manifest.json")

# demand lattice: NONE (absent) < mask (frozenset of lane ids) < FULL
FULL = "full"
CONFLICT = "conflict"

# operators whose output is an elementwise function of their operands,
# each broadcast to the output's shape (aligned from the right)
_ELEMENTWISE = frozenset({
    "add", "sub", "mul", "div", "remainder", "floor_divide", "rsub",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "__lshift__", "__rshift__", "bitwise_left_shift",
    "bitwise_right_shift", "eq", "ne", "lt", "le", "gt", "ge", "where",
    "clamp", "clamp_min", "clamp_max", "maximum", "minimum", "abs", "neg",
    "pow", "nextafter", "isnan", "logical_and", "logical_or",
    "logical_not", "logical_xor", "sign", "_to_copy", "clone", "alias",
    "detach", "lift_fresh_copy", "lift_fresh", "fmod", "sqrt", "exp",
    "log", "floor", "ceil", "round", "trunc",
})

# operators that make a tensor from their arguments' shapes only: their
# tensor operands' values are never read
_CREATION_LIKE = frozenset({"zeros_like", "ones_like", "full_like",
                            "empty_like"})
_CREATION = frozenset({"zeros", "ones", "full", "arange", "eye", "empty",
                       "scalar_tensor", "empty_strided", "new_zeros",
                       "new_ones", "new_full", "new_empty"})

_REDUCES = frozenset({"sum", "any", "all", "amax", "amin", "max", "min",
                      "argmax", "argmin", "prod", "mean"})


def _join(a, b):
    """Demand-lattice join."""
    if a is None:
        return b
    if b is None:
        return a
    if a == FULL or b == FULL:
        return FULL
    return a | b


def _norm_dim(d: int, rank: int) -> int:
    return d + rank if d < 0 else d


@dataclass
class LaneReport:
    """Liveness result for ONE model."""
    label: str
    lanes: int                       # full lane universe of the audit
                                     # config's wire format (8 header +
                                     # body + optional NETID)
    body_lanes: int
    live_lanes: Set[int] = field(default_factory=set)
    reads: Dict[int, Set[str]] = field(default_factory=dict)
    writes: Dict[int, Set[str]] = field(default_factory=dict)
    dead_stores: List[Tuple[int, str]] = field(default_factory=list)
    overreads: List[Tuple[int, str]] = field(default_factory=list)
    carry_leaves: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    conservative: bool = False       # LNE605 fallback fired
    notes: List[str] = field(default_factory=list)
    ir_bytes_est: int = 0
    dead_bytes_est: int = 0

    @property
    def live_body_lanes(self) -> List[int]:
        from .. import wire
        return sorted(lane - wire.BODY for lane in self.live_lanes
                      if lane >= wire.BODY)

    @property
    def dead_body_lanes(self) -> List[int]:
        return sorted(set(range(self.body_lanes))
                      - set(self.live_body_lanes))

    @property
    def live_header_lanes(self) -> List[int]:
        from .. import wire
        return sorted(lane for lane in self.live_lanes if lane < wire.BODY)

    @property
    def dead_carry_leaves(self) -> List[str]:
        return sorted(p for p, e in self.carry_leaves.items()
                      if e["status"] == "dead")

    def to_entry(self) -> Dict[str, Any]:
        """The checked-in manifest representation: ``live_body_lanes``
        is the narrow-layout target, ``dead_bytes_per_tick_est`` the
        headroom, ``projected_narrow_ir_bytes_est`` the cost model's
        estimate of the tick after the narrowing."""
        return {
            "lanes": self.lanes,
            "body_lanes": self.body_lanes,
            "live_header_lanes": self.live_header_lanes,
            "live_body_lanes": self.live_body_lanes,
            "dead_body_lanes": self.dead_body_lanes,
            "dead_carry_leaves": self.dead_carry_leaves,
            "dead_stores": sorted({f"{lane}:{phase}"
                                   for lane, phase in self.dead_stores}),
            "resolution": ("conservative" if self.conservative
                           else "exact"),
            "ir_bytes_est": self.ir_bytes_est,
            "dead_bytes_per_tick_est": self.dead_bytes_est,
            "projected_narrow_ir_bytes_est":
                self.ir_bytes_est - self.dead_bytes_est,
        }


def _links(g: TickGraph, n: TNode) -> List[Tuple[int, int, Dict[int, int]]]:
    """``(operand, output, {operand axis: output axis})`` triples along
    which an operator keeps lane coordinates exactly (the tagger's
    edges)."""
    shape = lambda v: g.values[v].shape  # noqa: E731
    name, a = n.name, n.args
    outs = n.outs
    if not outs:
        return []
    o = outs[0]
    os_ = shape(o)
    refs = [x.vid for x in a if isinstance(x, Ref)]
    out: List[Tuple[int, int, Dict[int, int]]] = []

    def aligned(v, o_shape, o_vid):
        vs = shape(v)
        off = len(o_shape) - len(vs)
        return (v, o_vid, {i: i + off for i in range(len(vs))
                           if off >= 0 and vs[i] == o_shape[i + off]})

    if name in _ELEMENTWISE or name in _CREATION_LIKE or name == "copy":
        for v in refs:
            out.append(aligned(v, os_, o))
    elif name == "expand":
        out.append(aligned(refs[0], os_, o))
    elif name in ("view", "_unsafe_view", "reshape"):
        if len(n.args) > 1 and isinstance(n.args[1], torch.dtype):
            # view.dtype: a same-width reinterpretation keeps the axes
            if g.values[refs[0]].dtype.itemsize == g.values[o].dtype.itemsize:
                out.append((refs[0], o, {i: i for i in range(len(os_))}))
        else:
            out.append((refs[0], o, _reshape_axis_map(shape(refs[0]), os_)))
    elif name == "unsqueeze":
        r = len(shape(refs[0]))
        d = _norm_dim(a[1], r + 1)
        out.append((refs[0], o, {i: (i if i < d else i + 1)
                                 for i in range(r)}))
    elif name == "squeeze":
        ins = shape(refs[0])
        dims = a[1] if len(a) > 1 else [i for i, s in enumerate(ins)
                                        if s == 1]
        dims = [dims] if isinstance(dims, int) else list(dims)
        dims = {_norm_dim(d, len(ins)) for d in dims if ins[
            _norm_dim(d, len(ins))] == 1}
        amap, b = {}, 0
        for i in range(len(ins)):
            if i not in dims:
                amap[i] = b
                b += 1
        out.append((refs[0], o, amap))
    elif name == "permute":
        perm = [_norm_dim(p, len(os_)) for p in a[1]]
        out.append((refs[0], o, {p: i for i, p in enumerate(perm)}))
    elif name in ("transpose", "t"):
        r = len(shape(refs[0]))
        d0, d1 = ((_norm_dim(a[1], r), _norm_dim(a[2], r)) if name ==
                  "transpose" else (0, 1))
        amap = {i: i for i in range(r)}
        amap[d0], amap[d1] = d1, d0
        out.append((refs[0], o, amap))
    elif name == "select":
        r = len(shape(refs[0]))
        d = _norm_dim(a[1], r)
        out.append((refs[0], o, {i: (i if i < d else i - 1)
                                 for i in range(r) if i != d}))
    elif name == "unbind":
        r = len(shape(refs[0]))
        d = _norm_dim(a[1] if len(a) > 1 else 0, r)
        for ov in outs:
            out.append((refs[0], ov, {i: (i if i < d else i - 1)
                                      for i in range(r) if i != d}))
    elif name in ("slice", "constant_pad_nd"):
        ins = shape(refs[0])
        out.append((refs[0], o, {i: i for i in range(len(ins))
                                 if ins[i] == os_[i]}))
    elif name == "cat":
        tensors = a[0]
        d = _norm_dim(a[1] if len(a) > 1 else 0, len(os_))
        for x in tensors:
            if isinstance(x, Ref):
                out.append((x.vid, o, {i: i for i in range(len(os_))
                                       if i != d}))
    elif name == "stack":
        tensors = a[0]
        d = _norm_dim(a[1] if len(a) > 1 else 0, len(os_))
        for x in tensors:
            if isinstance(x, Ref):
                r = len(shape(x.vid))
                out.append((x.vid, o, {i: (i if i < d else i + 1)
                                       for i in range(r)}))
    elif name in _REDUCES:
        ins = shape(refs[0])
        dims = _reduce_dims(n, len(ins))
        keep = _keepdim(n)
        for ov in outs:
            amap, b = {}, 0
            for i in range(len(ins)):
                if i in dims:
                    if keep:
                        b += 1
                    continue
                amap[i] = b
                b += 1
            out.append((refs[0], ov, amap))
    elif name == "sort":
        ins = shape(refs[0])
        d = _norm_dim(n.kwargs.get("dim", a[1] if len(a) > 1
                                   and isinstance(a[1], int) else -1),
                      len(ins))
        for ov in outs:
            out.append((refs[0], ov, {i: i for i in range(len(ins))
                                      if i != d}))
    elif name == "gather":
        ins = shape(refs[0])
        d = _norm_dim(a[1], len(ins))
        idx = shape(a[2].vid)
        out.append((refs[0], o, {i: i for i in range(len(ins))
                                 if i != d and idx[i] == ins[i]}))
    elif name in ("scatter", "scatter_add", "scatter_reduce"):
        ins = shape(refs[0])
        d = _norm_dim(a[1], len(ins))
        out.append((refs[0], o, {i: i for i in range(len(ins))}))
        if len(a) > 3 and isinstance(a[3], Ref):
            src = shape(a[3].vid)
            out.append((a[3].vid, o, {i: i for i in range(len(src))
                                      if i != d and src[i] == ins[i]}))
    elif name == "select_scatter":
        ins = shape(refs[0])
        d = _norm_dim(a[2], len(ins))
        out.append((refs[0], o, {i: i for i in range(len(ins))}))
        out.append((a[1].vid, o, {i: (i if i < d else i + 1)
                                  for i in range(len(ins) - 1)}))
    elif name == "slice_scatter":
        ins = shape(refs[0])
        src = shape(a[1].vid)
        out.append((refs[0], o, {i: i for i in range(len(ins))}))
        out.append((a[1].vid, o, {i: i for i in range(len(ins))
                                  if src[i] == ins[i]}))
    elif name == "index":
        ins = shape(refs[0])
        idxs = list(a[1])
        k = 0
        while k < len(idxs) and idxs[k] is not None:
            k += 1
        if k > 0 and all(x is None for x in idxs[k:]):
            lead = len(os_) - (len(ins) - k)
            out.append((refs[0], o, {i: lead + i - k
                                     for i in range(k, len(ins))
                                     if ins[i] == os_[lead + i - k]}))
    elif name == "repeat":
        ins = shape(refs[0])
        reps = list(a[1])
        off = len(reps) - len(ins)
        out.append((refs[0], o, {i: i + off for i in range(len(ins))
                                 if reps[i + off] == 1}))
    return out


def _reduce_dims(n: TNode, rank: int) -> Set[int]:
    a = n.args
    dims = None
    if len(a) > 1 and not isinstance(a[1], (bool, torch.dtype)):
        dims = a[1]
    dims = n.kwargs.get("dim", dims)
    if dims is None or (isinstance(dims, (list, tuple)) and not dims):
        return set(range(rank))
    dims = [dims] if isinstance(dims, int) else list(dims)
    return {_norm_dim(d, rank) for d in dims}


def _keepdim(n: TNode) -> bool:
    a = n.args
    if "keepdim" in n.kwargs:
        return bool(n.kwargs["keepdim"])
    return len(a) > 2 and isinstance(a[2], bool) and a[2]


def _reshape_axis_map(in_shape, out_shape) -> Dict[int, int]:
    """Axes preserved by a reshape: same dim size AND same trailing
    element count (the unique axis identity a reshape can keep)."""
    def trailing(shape):
        out, p = [], 1
        for d in reversed(shape):
            out.append(p)
            p *= d
        return list(reversed(out))
    t_in, t_out = trailing(in_shape), trailing(out_shape)
    amap = {}
    for a, (da, ta) in enumerate(zip(in_shape, t_in)):
        for b, (db, tb) in enumerate(zip(out_shape, t_out)):
            if da == db and ta == tb:
                amap[a] = b
                break
    return amap


class _Analyzer:
    """One backward lane-liveness pass over one recorded tick.

    Three cooperating fixpoints, as in JAX: constant folding (forward,
    once) of the small integer tensors that index lanes; lane-axis
    tagging (both ways, to a fixpoint) from the carry's pool leaf
    through the operators that keep coordinates; demand propagation
    (backward, to a fixpoint) with the carry's feedback edges."""

    def __init__(self, g: TickGraph, n_lanes: int,
                 lane_inputs: Dict[int, int]):
        self.g = g
        self.L = n_lanes
        self.tags: Dict[int, Any] = {}
        self.demand: Dict[int, Any] = {}
        self.consts: Dict[int, np.ndarray] = {}
        self.reads: Dict[int, Set[str]] = {}
        self.writes: Dict[int, Set[str]] = {}
        self.dead_stores: List[Tuple[int, str]] = []
        self.overreads: List[Tuple[int, str]] = []
        self.notes: List[str] = []
        self.conservative = False
        self._changed = False
        self._record = False
        self.links = [_links(g, n) for n in g.nodes]
        for vid, axis in lane_inputs.items():
            self._set_tag(vid, axis)
        for v in g.values:
            if v.kind == "const" and v.value is not None:
                self._remember(v.vid, v.value)

    # --- constant folding ---------------------------------------------------

    def _remember(self, vid, arr):
        arr = np.asarray(arr)
        if arr.size <= cost_model.CONST_VALUE_MAX_ELEMS \
                and arr.dtype.kind in "iub":
            self.consts[vid] = arr

    def fold_consts(self):
        """Run each operator whose tensor operands are all known on the
        CPU (small outputs only): the index tensors the tick builds from
        ``arange``, ``full`` and arithmetic become concrete."""
        from torch.utils._pytree import tree_map
        cpu = torch.device("cpu")
        for n in self.g.nodes:
            if any(v not in self.consts for v in n.ins):
                continue
            if not n.outs or any(
                    int(np.prod(self.g.values[v].shape))
                    > cost_model.CONST_VALUE_MAX_ELEMS for v in n.outs):
                continue

            def real(x):
                if isinstance(x, Ref):
                    return torch.from_numpy(np.array(self.consts[x.vid]))
                if isinstance(x, torch.device):
                    return cpu
                return x
            try:
                args, kwargs = tree_map(real, (n.args, n.kwargs))
                res = n.op(*args, **kwargs)
            except Exception:
                continue
            res = res if isinstance(res, (tuple, list)) else (res,)
            for vid, r in zip(n.outs, [r for r in res
                                       if isinstance(r, torch.Tensor)]):
                self._remember(vid, r.numpy())

    def _cval(self, x) -> Optional[np.ndarray]:
        if isinstance(x, Ref):
            return self.consts.get(x.vid)
        if isinstance(x, (int, bool)):
            return np.asarray(x)
        return None

    # --- lane-axis tagging --------------------------------------------------

    def _set_tag(self, vid, axis):
        if axis is None:
            return
        cur = self.tags.get(vid)
        if cur is None:
            self.tags[vid] = axis
            self._changed = True
        elif cur != axis and cur != CONFLICT:
            self.tags[vid] = CONFLICT
            self._changed = True

    def _tag(self, vid):
        t = self.tags.get(vid)
        return t if t != CONFLICT else None

    def _lane_axis(self, vid):
        """The value's lane axis, when it spans the whole universe."""
        t = self._tag(vid)
        if t is None:
            return None
        return t if self.g.values[vid].shape[t] == self.L else None

    def infer_tags(self, max_iters: int = 30):
        for _ in range(max_iters):
            self._changed = False
            for links in self.links:
                for src, dst, amap in links:
                    ts = self._tag(src)
                    if ts is not None and ts in amap:
                        self._set_tag(dst, amap[ts])
                    td = self._tag(dst)
                    if td is not None:
                        inv = {b: a for a, b in amap.items()}
                        if td in inv:
                            self._set_tag(src, inv[td])
            if not self._changed:
                return
        self.note("lane-axis tagging did not converge "
                  f"in {max_iters} sweeps — results widened")
        self.conservative = True

    # --- backward demand ----------------------------------------------------

    def note(self, msg: str):
        if msg not in self.notes:
            self.notes.append(msg)

    def _add(self, vid, d):
        if d is None or vid is None:
            return
        cur = self.demand.get(vid)
        new = _join(cur, d)
        if new != cur:
            self.demand[vid] = new
            self._changed = True

    def _phase(self, n: TNode) -> str:
        return (n.phase if n.phase in cost_model.PHASES
                else cost_model.OTHER_PHASE)

    def _record_read(self, lanes, n: TNode):
        if not self._record:
            return
        ph = self._phase(n)
        for lane in lanes:
            if lane >= self.L or lane < 0:
                self.overreads.append((lane, ph))
                lane = max(0, min(lane, self.L - 1))
            self.reads.setdefault(lane, set()).add(ph)

    def _record_write(self, lanes, n: TNode, dead: bool):
        if not self._record:
            return
        ph = self._phase(n)
        for lane in lanes:
            if lane >= self.L or lane < 0:
                self.overreads.append((lane, ph))
                continue
            self.writes.setdefault(lane, set()).add(ph)
            if dead:
                self.dead_stores.append((lane, ph))

    def _fallback_full(self, n: TNode, why: str):
        """LNE605: an unresolvable lane access — all lanes conservatively
        live, noted once per site kind."""
        self.conservative = True
        self.note(why)
        for v in n.ins:
            self._add(v, FULL)

    def run_demand(self, out_demands: List[Any],
                   carry_pairs: Sequence[Tuple[int, int]],
                   max_iters: int = 60):
        """Backward fixpoint. ``out_demands`` aligns with the graph's
        outputs; ``carry_pairs`` are (output index, input index) edges:
        demand on a carry input leaf joins into the matching output leaf
        (the next tick needs it)."""
        g = self.g
        for v, d in zip(g.outputs, out_demands):
            self._add(v, d)
        for _ in range(max_iters):
            self._changed = False
            for out_i, in_i in carry_pairs:
                self._add(g.outputs[out_i], self.demand.get(g.inputs[in_i]))
            for n in reversed(g.nodes):
                self._demand_node(n)
            if not self._changed:
                break
        else:
            self.note(f"demand propagation did not converge in "
                      f"{max_iters} sweeps — results widened")
            self.conservative = True
        # one recording sweep at the fixpoint
        self._record = True
        for n in reversed(g.nodes):
            self._demand_node(n)
        self._record = False

    def _through_links(self, n: TNode, skip=()):
        """Demand through the coordinate-keeping edges: an operand gets
        the output's lane mask when both ends carry the lane axis where
        the edge maps it, else all of it."""
        for src, dst, amap in self.links[n.idx]:
            if src in skip:
                continue
            d = self.demand.get(dst)
            if d is None:
                continue
            if isinstance(d, frozenset):
                ts, td = self._tag(src), self._tag(dst)
                if ts is None or td is None or amap.get(ts) != td:
                    d = FULL
            self._add(src, d)

    def _demand_node(self, n: TNode):
        outs = [self.demand.get(v) for v in n.outs]
        if not any(d is not None for d in outs):
            return
        name = n.name
        linked = {src for src, _, _ in self.links[n.idx]}
        if name in _CREATION or name in _CREATION_LIKE:
            return
        if name == "select":
            self._demand_select(n)
        elif name == "slice":
            self._demand_slice(n)
        elif name == "gather":
            self._demand_gather(n)
        elif name == "index":
            self._demand_index(n)
        elif name in ("scatter", "scatter_add", "scatter_reduce"):
            self._demand_scatter(n, rmw=name != "scatter"
                                 or "reduce" in n.kwargs)
        elif name == "select_scatter":
            self._demand_select_scatter(n)
        elif name == "slice_scatter":
            self._demand_slice_scatter(n)
        elif name == "copy":
            # the destination only lends its shape
            self._through_links(n, skip=(n.args[0].vid,))
        elif name in _REDUCES or name in ("sort", "unbind"):
            self._through_links(n)
        elif self.links[n.idx] or name in _ELEMENTWISE:
            self._through_links(n)
            for v in n.ins:
                if v not in linked:
                    self._add(v, FULL)
        else:
            if any(self._tag(v) is not None for v in n.ins):
                # an unmodeled operator consuming a lane array: every
                # lane must be assumed read
                self._fallback_full(
                    n, f"unmodeled operator '{name}' consumes a "
                       f"lane-tagged array — conservative all-live")
                self._record_read(range(self.L), n)
                return
            for v in n.ins:
                self._add(v, FULL)

    # -- lane-precise transfer functions --

    def _demand_select(self, n: TNode):
        x = n.args[0].vid
        t = self._tag(x)
        r = len(self.g.values[x].shape)
        d = _norm_dim(n.args[1], r)
        if t is None or t != d:
            self._through_links(n)
            return
        lane = int(n.args[2])
        lane = lane + self.g.values[x].shape[d] if lane < 0 else lane
        self._add(x, frozenset({lane}))
        self._record_read([lane], n)

    def _demand_slice(self, n: TNode):
        x = n.args[0].vid
        t = self._tag(x)
        shp = self.g.values[x].shape
        a = n.args
        d = _norm_dim(a[1] if len(a) > 1 else 0, len(shp))
        d0 = self.demand.get(n.outs[0])
        if t is None or t != d:
            self._through_links(n)
            return
        size = shp[d]
        start = a[2] if len(a) > 2 and a[2] is not None else 0
        end = a[3] if len(a) > 3 and a[3] is not None else size
        step = a[4] if len(a) > 4 else 1
        start = max(0, min(start + size if start < 0 else start, size))
        end = max(0, min(end + size if end < 0 else end, size))
        if (start, end, step) == (0, size, 1):
            self._add(x, d0)
            return
        window = frozenset(range(start, end, step))
        self._add(x, window)
        self._record_read(sorted(window), n)

    def _demand_gather(self, n: TNode):
        x, dim, idx = n.args[0].vid, n.args[1], n.args[2]
        t = self._tag(x)
        shp = self.g.values[x].shape
        d = _norm_dim(dim, len(shp))
        self._add(idx.vid, FULL)
        if t is None or t != d:
            self._through_links(n, skip=(idx.vid,))
            return
        vals = self._cval(idx)
        if vals is None:
            self._fallback_full(
                n, "gather along the lane axis with an unresolvable "
                   "index — conservative all-live")
            self._record_read(range(self.L), n)
            return
        lanes = {int(v) for v in np.unique(vals)}
        self._add(x, frozenset(v for v in lanes if 0 <= v < shp[d]))
        self._record_read(sorted(lanes), n)

    def _demand_index(self, n: TNode):
        x = n.args[0].vid
        t = self._tag(x)
        idxs = list(n.args[1])
        for i in idxs:
            if isinstance(i, Ref):
                self._add(i.vid, FULL)
        if t is None or t >= len(idxs) or idxs[t] is None:
            self._through_links(n)
            return
        vals = self._cval(idxs[t])
        if vals is None:
            self._fallback_full(
                n, "index along the lane axis with an unresolvable "
                   "index — conservative all-live")
            self._record_read(range(self.L), n)
            return
        size = self.g.values[x].shape[t]
        lanes = {int(v) + (size if v < 0 else 0) for v in np.unique(vals)}
        self._add(x, frozenset(v for v in lanes if 0 <= v < size))
        self._record_read(sorted(lanes), n)

    def _write(self, n: TNode, base: int, src: Optional[int],
               written: Set[int], kill: bool, rmw: bool = False):
        """A write of lanes ``written`` of ``base`` (the output is the
        new base): the source is live only if a written lane is
        demanded; a full-cover overwrite kills those lanes' demand on
        the old base."""
        d0 = self.demand.get(n.outs[0])
        in_range = frozenset(w for w in written if 0 <= w < self.L)
        demanded = d0 if d0 == FULL else frozenset(d0) & in_range
        dead = demanded != FULL and not demanded
        self._record_write(sorted(written), n, dead=dead and not rmw)
        if src is not None:
            self._add(src, None if dead and not rmw else FULL)
        if kill and not rmw and isinstance(d0, frozenset):
            self._add(base, d0 - in_range)
        else:
            self._add(base, d0)

    def _demand_select_scatter(self, n: TNode):
        base, src = n.args[0].vid, n.args[1].vid
        t = self._tag(base)
        shp = self.g.values[base].shape
        d = _norm_dim(n.args[2], len(shp))
        if t is None or t != d:
            self._through_links(n)
            return
        lane = int(n.args[3])
        lane = lane + shp[d] if lane < 0 else lane
        self._write(n, base, src, {lane}, kill=True)

    def _demand_slice_scatter(self, n: TNode):
        a = n.args
        base, src = a[0].vid, a[1].vid
        t = self._tag(base)
        shp = self.g.values[base].shape
        d = _norm_dim(a[2] if len(a) > 2 else 0, len(shp))
        if t is None or t != d:
            self._through_links(n)
            return
        size = shp[d]
        start = a[3] if len(a) > 3 and a[3] is not None else 0
        end = a[4] if len(a) > 4 and a[4] is not None else size
        step = a[5] if len(a) > 5 else 1
        start = max(0, min(start + size if start < 0 else start, size))
        end = max(0, min(end + size if end < 0 else end, size))
        self._write(n, base, src, set(range(start, end, step)), kill=True)

    def _demand_scatter(self, n: TNode, rmw: bool):
        a = n.args
        base, idx = a[0].vid, a[2]
        src = a[3].vid if len(a) > 3 and isinstance(a[3], Ref) else None
        t = self._tag(base)
        shp = self.g.values[base].shape
        d = _norm_dim(a[1], len(shp))
        self._add(idx.vid, FULL)
        if t is None or t != d:
            self._through_links(n, skip=(idx.vid,))
            return
        vals = self._cval(idx)
        if vals is None:
            self.note("scatter along the lane axis with unresolvable "
                      "indices — no dead-store credit taken")
            if src is not None:
                self._add(src, FULL)
            self._add(base, self.demand.get(n.outs[0]))
            return
        written = {int(v) for v in np.unique(vals)}
        # the write kills its lanes only when every row of the index
        # names the same lanes and the index spans the other axes
        ishape = self.g.values[idx.vid].shape
        rows = np.moveaxis(np.broadcast_to(vals, ishape), d, -1)
        rows = rows.reshape(-1, rows.shape[-1])
        same = all(set(r.tolist()) == written for r in rows)
        cover = all(ishape[i] == shp[i] for i in range(len(shp)) if i != d)
        self._write(n, base, src, written, kill=same and cover, rmw=rmw)


# --- per-model analysis ----------------------------------------------------


# carry fields that are observables in their own right: fetched and
# reported by the harness after every run, so their demand is
# unconditional (everything else earns its liveness through the carry
# fixed point)
_OBSERVED_CARRY_FIELDS = ("stats", "violations", "telemetry", "key")


def _field(path: str) -> str:
    return path.split(".")[1].split("[")[0] if "." in path else path


def _pool_lane_axis(layout: str, pool_shape: Tuple[int, ...],
                    n_lanes: int) -> int:
    """The pool leaf's lane axis: the last of the lead pool ``[I, S,
    L]``, axis 1 of the minor pool ``[S, L, I]``."""
    axis = 1 if layout == "minor" else len(pool_shape) - 1
    if pool_shape[axis] != n_lanes:
        raise ValueError(
            f"pool leaf {pool_shape} does not carry {n_lanes} lanes at "
            f"axis {axis} (layout={layout!r})")
    return axis


def _new_tagger(g: TickGraph, n_lanes: int, layout: str) -> _Analyzer:
    pool = g.inputs[g.input_paths.index(".pool")]
    axis = _pool_lane_axis(layout, tuple(g.values[pool].shape), n_lanes)
    ana = _Analyzer(g, n_lanes, {pool: axis})
    ana.fold_consts()
    ana.infer_tags()
    return ana


def tagger_of(g: TickGraph, n_lanes: int, layout: str) -> _Analyzer:
    """The graph's folded constants and lane tags (the first two
    fixpoints), computed once per graph (a graph is of one layout): the
    ranges pass reads them too."""
    cached = getattr(g, "_tagger", None)
    if cached is None or cached.L != n_lanes:
        cached = _new_tagger(g, n_lanes, layout)
        g._tagger = cached
    return cached


def analyze_graph(g: TickGraph, n_lanes: int, layout: str) -> _Analyzer:
    """Run the three fixpoints over one functional tick graph (the first
    two on a fresh tagger: the demand fixpoint writes to it)."""
    ana = _new_tagger(g, n_lanes, layout)
    n_carry = len(g.inputs)
    out_demands: List[Any] = [None] * len(g.outputs)
    for i, p in enumerate(g.output_paths):
        if i >= g.n_carry_out or _field(p) in _OBSERVED_CARRY_FIELDS:
            out_demands[i] = FULL
    if g.output_paths[:g.n_carry_out] != g.input_paths:
        raise ValueError("the tick's output carry does not have the input "
                         "carry's leaves")
    ana.run_demand(out_demands, [(i, i) for i in range(n_carry)])
    return ana


def analyze_model(model, node_count: int, layout: str = "lead",
                  label: Optional[str] = None, sim=None,
                  trace_cache=None, cost=None) -> LaneReport:
    """Run the lane-liveness slice for one model over every tick
    variant. ``sim`` overrides the shared audit config (the bench passes
    its own, so the metric line prices the configuration it measures);
    ``trace_cache`` holds the graphs of one sim (the audit sims' in the
    lint, the bench's own in the bench); ``cost`` (the same graphs'
    ``cost_model.cost_of_variants``) skips the duplicate walk for the
    byte figures. A given ``sim`` brings its own layout."""
    if sim is None:
        sim = cost_model.audit_sim(model, node_count, layout)
    layout = sim.layout
    label = label or f"{getattr(model, 'name', type(model).__name__)}" \
                     f"/{layout}"
    n_lanes = sim.net.lanes
    graphs = cost_model.trace_variants(model, sim, cache=trace_cache)
    anas = {name: analyze_graph(g, n_lanes, layout)
            for name, g in graphs.items()}
    live: Set[int] = set()
    conservative = False
    notes: List[str] = []
    reads: Dict[int, Set[str]] = {}
    writes: Dict[int, Set[str]] = {}
    overreads: Set[Tuple[int, str]] = set()
    dead_stores: Optional[Set[Tuple[int, str]]] = None
    dead_leaves: Optional[Set[str]] = None
    for name, ana in anas.items():
        g = graphs[name]
        pool = g.inputs[g.input_paths.index(".pool")]
        pool_demand = ana.demand.get(pool)
        live |= set(ana.reads)
        if pool_demand == FULL:
            ana.conservative = True
            ana.note("the message pool's demand widened to all lanes")
        elif isinstance(pool_demand, frozenset):
            live |= set(pool_demand)
        conservative |= ana.conservative
        notes += [m for m in ana.notes if m not in notes]
        for k, v in ana.reads.items():
            reads.setdefault(k, set()).update(v)
        for k, v in ana.writes.items():
            writes.setdefault(k, set()).update(v)
        overreads |= set(ana.overreads)
        ds = set(ana.dead_stores)
        dead_stores = ds if dead_stores is None else dead_stores & ds
        dl = {p for p, v in zip(g.input_paths, g.inputs)
              if ana.demand.get(v) is None}
        dead_leaves = dl if dead_leaves is None else dead_leaves & dl
    if conservative:
        live = set(range(n_lanes))
    report = LaneReport(label=label, lanes=n_lanes,
                        body_lanes=model.body_lanes, live_lanes=live,
                        reads=reads, writes=writes,
                        dead_stores=sorted(dead_stores or ()),
                        overreads=sorted(overreads),
                        conservative=conservative, notes=notes)

    # per-leaf classification + byte attribution (the first variant's
    # graph: every variant has the same carry)
    g0 = next(iter(graphs.values()))
    for i, (p, v) in enumerate(zip(g0.input_paths, g0.inputs)):
        nbytes = g0.values[v].nbytes
        written = g0.outputs[i] != v
        status = "dead" if p in dead_leaves else (
            "live" if written else "carried")
        report.carry_leaves[p] = {"status": status, "bytes": nbytes}

    # dead-byte attribution: every lane-axis output of an operator that
    # launches pays for its dead lanes — the accounting ir_bytes_est
    # uses, so the two subtract meaningfully
    if cost is None:
        cost = cost_model.cost_of_variants(graphs)
    report.ir_bytes_est = cost.hbm_bytes
    dead_frac = len(set(range(n_lanes)) - live) / n_lanes
    dead_bytes = 0.0
    if dead_frac:
        ana = anas.get(cost.variant) or next(iter(anas.values()))
        g = ana.g
        dead_bytes = sum(g.values[v].nbytes for n in g.ops()
                         for v in n.outs
                         if ana._lane_axis(v) is not None) * dead_frac
    dead_bytes += sum(e["bytes"] for e in report.carry_leaves.values()
                      if e["status"] == "dead")
    report.dead_bytes_est = int(dead_bytes)
    return report


# --- findings --------------------------------------------------------------


def _model_path(model) -> str:
    return type(model).__module__.replace(".", os.sep) + ".py"


def _finding(rule, name, severity, path, symbol, message) -> Finding:
    return Finding(rule=rule, name=name, severity=severity,
                   pass_name=PASS_NAME, path=path, line=0,
                   symbol=symbol, message=message)


def findings_of_report(model, report: LaneReport) -> List[Finding]:
    """LNE601-LNE605 from one model's liveness result."""
    path = _model_path(model)
    cls = type(model).__name__
    out: List[Finding] = []

    def flag(rule, name, message, severity):
        out.append(_finding(rule, name, severity, path, cls,
                            f"[{report.label}] {message}"))

    for lane, phase in sorted(set(report.overreads)):
        flag("LNE604", "lane-overread",
             f"a resolved lane index reaches lane {lane}, outside the "
             f"declared universe of {report.lanes} lanes "
             f"(8 header + body_lanes={report.body_lanes}) — on the card "
             f"the access reads past the row, into the next row or out "
             f"of bounds ({phase} phase)", SEV_ERROR)
    if report.conservative:
        flag("LNE605", "lane-unresolvable",
             "a lane index could not be resolved statically — the "
             "model is conservatively ALL-LIVE (no dead-lane credit); "
             + "; ".join(report.notes[:3]), SEV_WARNING)
        return out
    if report.dead_body_lanes:
        flag("LNE601", "dead-body-lane",
             f"body lane(s) {report.dead_body_lanes} of "
             f"{report.body_lanes} are never read on any reachable "
             f"path — ~{report.dead_bytes_est} B/tick of dead lane "
             f"traffic; narrowing body_lanes to the live set "
             f"{report.live_body_lanes} is trajectory-preserving",
             SEV_WARNING)
    for leaf in report.dead_carry_leaves:
        flag("LNE602", "dead-carry-leaf",
             f"carry leaf {leaf} "
             f"({report.carry_leaves[leaf]['bytes']} B) feeds no "
             f"observable output — not even through the carry fixed "
             f"point; it is pure device-memory ballast", SEV_WARNING)
    from .. import wire
    body_dead = sorted({(lane, phase) for lane, phase in report.dead_stores
                        if lane >= wire.BODY})
    if body_dead:
        detail = ", ".join(f"lane {lane} ({phase})"
                           for lane, phase in body_dead[:6])
        flag("LNE603", "dead-store",
             f"body lane store(s) never read before being overwritten "
             f"or dropped: {detail} — wasted writes the narrow layout "
             f"would delete", SEV_WARNING)
    return out


# --- manifest io + drift gate ----------------------------------------------


def load_lane_manifest(path: Optional[str] = None) -> Dict[str, Any]:
    path = path or DEFAULT_LANE_MANIFEST
    if not os.path.exists(path):
        return {"version": 1, "entries": {}}
    with open(path) as f:
        data = json.load(f)
    data.setdefault("entries", {})
    return data


def save_lane_manifest(entries: Dict[str, Dict[str, Any]],
                       path: Optional[str] = None) -> str:
    path = path or DEFAULT_LANE_MANIFEST
    payload = {
        "version": 1,
        "_comment": (
            "Per-model live-lane manifest for `python -m "
            "maelstrom_tpu_torch lint --lanes`. Keys: <workload>/n=<nodes>"
            "/<layout>; live_body_lanes = body lanes provably read on "
            "some reachable path of the tick (any tick variant) under "
            "the audit config (the safe narrow-layout target), "
            "dead_bytes_per_tick_est = estimated bytes/tick written for "
            "dead lanes + dead carry leaves, projected_narrow_ir_bytes_"
            "est = ir_bytes_est minus that headroom. Regenerate after an "
            "INTENTIONAL lane-vocabulary change with `lint --lanes "
            "--update-manifest`; live-set drift fails the gate "
            "(LNE606)."),
        "torch-version": cost_model.toolchain(),
        "entries": {k: entries[k] for k in sorted(entries)},
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")
    return path


def compare_manifest(live: Dict[str, LaneReport],
                     manifest: Dict[str, Any],
                     paths: Dict[str, Tuple[str, str]],
                     full_universe: bool = True,
                     errored: AbstractSet[str] = frozenset(),
                     ) -> List[Finding]:
    """Diff live lane reports against the checked-in manifest. The gate
    compares the LANE SETS (the safety-relevant fact); byte estimates
    are informational. ``errored`` keys failed to analyze this run
    (they already carry an LNE609 error) — their entries are not
    stale."""
    entries = manifest.get("entries", {})
    note = cost_model.toolchain_note(manifest.get("torch-version"),
                                     "lane manifest", "--update-manifest")
    findings: List[Finding] = []
    for key in sorted(live):
        rep = live[key]
        path, symbol = paths[key]
        base = entries.get(key)
        if base is None:
            findings.append(_finding(
                "LNE607", "lane-manifest-missing", SEV_ERROR, path,
                symbol,
                f"[{key}] no lane-manifest entry — record one with "
                f"`python -m maelstrom_tpu_torch lint --lanes "
                f"--update-manifest`"))
            continue
        drifts = []
        for field_name, got in (
                ("live_body_lanes", rep.live_body_lanes),
                ("live_header_lanes", rep.live_header_lanes),
                ("resolution", "conservative" if rep.conservative
                 else "exact")):
            want = base.get(field_name)
            if want is not None and want != got:
                drifts.append(f"{field_name}: live {got} vs manifest "
                              f"{want}")
        if drifts:
            findings.append(_finding(
                "LNE606", "lane-manifest-drift",
                SEV_WARNING if note else SEV_ERROR, path, symbol,
                f"[{key}] live lane set drifted from the checked-in "
                f"manifest: {'; '.join(drifts)} — a lane went "
                f"live/dead; if intentional, re-record with "
                f"--update-manifest and justify it"
                + (f" ({note})" if note else "")))
    if full_universe:
        for key in sorted(set(entries) - set(live) - set(errored)):
            findings.append(_finding(
                "LNE608", "lane-manifest-stale", SEV_WARNING,
                "maelstrom_tpu_torch/analysis/lane_manifest.json", "",
                f"[{key}] manifest entry matches no registered "
                f"model — remove or re-record it"))
    return findings


# --- LNE610: native width-class conformance --------------------------------


_NATIVE_WIRE_PATH = "maelstrom_tpu_torch/native/wire.py"


def native_width_findings(cpp_src: Optional[str] = None,
                          table: Optional[Dict[str, int]] = None,
                          include_fixture: bool = True) -> List[Finding]:
    """LNE610: cross-check the native engine's templated per-family
    width constants (parsed from ``cpp/engine/sim.cpp``), the Python
    width table (``native/wire.py``), the registry's per-family lane
    math and the built library. The fixture table
    (:data:`..native.wire.FIXTURE_DIVERGENT_WIDTHS`) is audited
    alongside on full runs, so the rule is seen to fire (its
    expected-status baseline entry)."""
    from ..native import wire as nwire
    from ..native.engine import native_msg_lanes

    findings: List[Finding] = []
    try:
        registry = nwire.registry_width_facts()
    except Exception as e:
        registry = None
        findings.append(_finding(
            "LNE610", "native-width-divergence", SEV_ERROR,
            _NATIVE_WIRE_PATH, "registry_width_facts",
            f"registry width facts unavailable: {e!r}"))
    # the library is built here if it is not yet: a build failure raises
    compiled = {wl: native_msg_lanes(wl) for wl in nwire.NATIVE_BODY_LANES}
    for symbol, message in nwire.check_native_widths(
            cpp_src=cpp_src, table=table,
            registry_entry_lanes=registry, compiled_lanes=compiled):
        findings.append(_finding(
            "LNE610", "native-width-divergence", SEV_ERROR,
            "cpp/engine/sim.cpp", symbol, message))
    if include_fixture and table is None:
        fixture_table = dict(nwire.NATIVE_BODY_LANES,
                             **nwire.FIXTURE_DIVERGENT_WIDTHS)
        for symbol, message in nwire.check_native_widths(
                cpp_src=cpp_src, table=fixture_table):
            findings.append(_finding(
                "LNE610", "native-width-divergence", SEV_ERROR,
                _NATIVE_WIRE_PATH, "FIXTURE_DIVERGENT_WIDTHS",
                f"[fixture] {message}"))
    return findings


# --- orchestration ---------------------------------------------------------


def run_lane_lint(repo_root: str = ".",
                  manifest_path: Optional[str] = None,
                  update_manifest: bool = False,
                  workloads: Optional[List[Tuple[str, int]]] = None,
                  layouts: Sequence[str] = cost_model.AUDIT_LAYOUTS,
                  include_fixtures: bool = True,
                  trace_cache=None,
                  reports: Optional[Dict[str, LaneReport]] = None
                  ) -> List[Finding]:
    """The lanes pass: analyze every registered model (or a restricted
    list), emit LNE6xx findings, and gate against (or re-record) the
    manifest. ``reports`` holds analyses already in hand by entry key
    (the lint's static workers); those are not done again."""
    from ..models import get_model

    full = workloads is None
    specs = cost_model.cost_specs() if full else list(workloads)
    findings: List[Finding] = []
    live: Dict[str, LaneReport] = {}
    paths: Dict[str, Tuple[str, str]] = {}
    errored: Set[str] = set()

    for wl, n in specs:
        try:
            model = get_model(wl, n, "grid")
        except Exception as e:
            findings.append(_finding(
                "LNE609", "lane-analysis-failure", SEV_ERROR,
                "maelstrom_tpu_torch/models/__init__.py", "get_model",
                f"get_model({wl!r}, {n}) raised: {e!r}"))
            errored.update(cost_model.entry_key(wl, n, lay)
                           for lay in layouts)
            continue
        for layout in layouts:
            key = cost_model.entry_key(wl, n, layout)
            rep = (reports or {}).get(key)
            try:
                if rep is None:
                    rep = analyze_model(
                        model, n, layout, label=key,
                        trace_cache=trace_cache,
                        cost=(trace_cache or {}).get(key + "::cost"))
            except Exception as e:
                findings.append(_finding(
                    "LNE609", "lane-analysis-failure", SEV_ERROR,
                    _model_path(model), type(model).__name__,
                    f"[{key}] lane analysis raised "
                    f"{type(e).__name__}: {e}"))
                errored.add(key)
                continue
            findings.extend(findings_of_report(model, rep))
            live[key] = rep
            paths[key] = (_model_path(model), type(model).__name__)

    if full and include_fixtures:
        from ..models.ir_hazards import LANE_FIXTURE_MODELS
        for kind, cls in sorted(LANE_FIXTURE_MODELS.items()):
            model = cls()
            try:
                rep = analyze_model(model, 2, "lead",
                                    label=f"fixture-{kind}")
            except Exception as e:
                findings.append(_finding(
                    "LNE609", "lane-analysis-failure", SEV_ERROR,
                    _model_path(model), type(model).__name__,
                    f"[fixture-{kind}] lane analysis raised "
                    f"{type(e).__name__}: {e}"))
                continue
            findings.extend(findings_of_report(model, rep))

    if full:
        findings.extend(native_width_findings())

    if update_manifest:
        path = save_lane_manifest(
            {k: r.to_entry() for k, r in live.items()}, manifest_path)
        findings.append(_finding(
            "LNE600", "lane-manifest-updated", SEV_INFO,
            os.path.relpath(path, os.path.abspath(repo_root))
            if os.path.isabs(path) else path, "",
            f"recorded {len(live)} lane-manifest entr"
            f"{'y' if len(live) == 1 else 'ies'}"))
    else:
        manifest = load_lane_manifest(manifest_path)
        findings.extend(compare_manifest(live, manifest, paths,
                                         full_universe=full,
                                         errored=errored))
    return findings


# --- bench/profiler surface ------------------------------------------------


def lane_stats(model, sim, cost=None, cache=None) -> Dict[str, int]:
    """One-call liveness stats for the bench line and ``profile_tick``:
    live lane count, dead lane count, and the dead-byte estimate next
    to ``ir_bytes_est``. ``cache`` holds ``sim``'s graphs (the ones
    ``cost_model.tick_cost`` traced for ``cost``)."""
    rep = analyze_model(model, sim.net.n_nodes, sim.layout, sim=sim,
                        trace_cache=cache, cost=cost)
    return {"lanes_live": len(rep.live_lanes),
            "lanes_dead": rep.lanes - len(rep.live_lanes),
            "lanes_dead_bytes": rep.dead_bytes_est}
