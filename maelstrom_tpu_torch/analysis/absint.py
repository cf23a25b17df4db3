"""Interval abstract interpreter over the tick's aten graph: ``lint --ranges``.

Counterpart of ``maelstrom_tpu/analysis/absint.py``, with its rules,
severities, messages, manifest and algorithm, over the port's recorded
tick (``cost_model.TickGraph``) instead of a jaxpr. A forward interval
walk of the tick with per-leaf / per-*lane* int32 ranges: the message
pool's lane axis is resolved through the lanes pass's tagger
(``lane_liveness._Analyzer``), so the DTICK deadline lane, the TYPE
enum lane and the payload lanes each carry their own range.

Per model the analyzer:

- seeds every carry leaf from an abstract walk of ``init_carry``'s aten
  graph on ``meta`` (``cost_model.record_init``);
- iterates the tick transfer to a fixed point, each leaf element either
  stable or a counter with a measured per-tick growth ``g``, widens the
  counters **affinely in the horizon** ``T`` (``hi(T) = hi_fp + g * T``)
  and re-applies the tick at the horizon state to check the growth
  bound there (a leaf that fails widens to dtype-full: ABS704);
- walks the tick once more at the horizon state, recording every int32
  operator whose exact result escapes int32 (ABS701), every index range
  provably outside its axis (ABS703) and every overwrite scatter whose
  index rows can alias (ABS702);
- finds the largest power-of-two horizon with a clean walk (the
  **proven** ``max_safe_horizon_log2``) and the minimal overflowing
  ``T``: JAX bisects for each; both are the one boundary between clean
  and dirty horizons, which the port predicts from the probe's
  overflowing leaves and their verified rates and confirms with two
  fixed points (a search over the excess takes over when it misses).

Rules (ABS7xx), as in JAX:

=======  ========================  ========  ==============================
rule     name                      severity  what it flags
=======  ========================  ========  ==============================
ABS700   range-manifest-updated    info      ``--update-ranges`` rewrote
                                             the manifest
ABS701   int32-overflow            error     an int32 value (an operator
                                             of the tick, or a carry
                                             counter extrapolated to the
                                             horizon) provably escapes
                                             int32 within the horizon,
                                             with the minimal T
ABS702   scatter-write-race        error     an overwrite scatter whose
                                             index rows can alias within
                                             one tick: on the card the
                                             duplicate writes land in an
                                             unspecified order
ABS703   oob-index                 error     an index range provably
                                             outside its axis: before the
                                             ``.clamp`` that reproduces
                                             XLA's clamping (the access
                                             silently reads the wrong
                                             element), or unclamped (it
                                             raises on the CPU and is a
                                             device assert on the card)
ABS704   range-unresolvable        warning   a carry leaf's growth could
                                             not be bounded, or an
                                             operator is not modeled
ABS705   range-manifest-drift      error     the proven ranges differ from
                                             the checked-in manifest entry
                                             (warning + a re-record hint
                                             when it was recorded under
                                             another torch version)
ABS706   range-manifest-missing    error     a registered model has no
                                             manifest entry
ABS707   range-manifest-stale      warning   a manifest entry matches no
                                             registered model
ABS708   range-analysis-failure    error     ``get_model`` or the analysis
                                             itself raised
=======  ========================  ========  ==============================

Where it differs from the JAX pass, and why:

- **The tick number.** A jaxpr's ``t`` is a traced int32 in ``[0, T)``;
  the port's is a host int. The recorder hands the tick a
  ``cost_model.TickInt`` and keeps, per operator, the scalar arguments
  computed from it (``TNode.sym``: ``t - heartbeat``, ``t + 1``, ``t //
  stride``); this pass evaluates each over ``t`` in ``[0, T)``. The
  constants the lanes pass folds at the recorded ``t`` are dropped
  where they depend on such an argument.
- **Host branches on t.** One jaxpr carries them as ``cond``\\ s, which
  the JAX pass joins. The port has one graph per outcome
  (``cost_model.tick_variants``): the abstract tick is the join of the
  variants, at every ``T``.
- **In-place writes.** Functionalization records a write through a
  view as the operator plus the ``select_scatter`` / ``slice_scatter``
  that puts it back; the cost counts leave those out, this pass reads
  them as the value flow of the write (a weak update, as JAX's scatter
  and ``dynamic_update_slice`` transfers).
- **The RNG.** JAX's threefry is one opaque primitive. The port
  emulates uint32 in int64 operators issued from ``rng.py`` and
  ``xla_math.py``; the recorder marks each call of those modules' functions
  (``TNode.region``) and the pass prices the call as one function:
  random words are ``[0, 2^32)``, a uniform draw ``[minval, maxval]``,
  ``randint`` ``[minval, maxval)``, ``xla_math.log`` the log of its
  argument's range, ``fma_f32`` ``a * b + c``. Nothing inside is walked,
  so the int64 emulation and the int64 -> int32 hand-over of random
  bits never count as overflows. Outside a region, an int64 -> int32
  conversion that escapes int32 is an ABS701 site (the carry wraps);
  int64 index arithmetic (``.long()``) is not.
- **Operator semantics.** ``torch.remainder`` is a floor modulo
  (``lax.rem`` truncates), each ``div`` rounding mode has its own
  transfer, and aten broadcasts its operands from the right (the lanes
  pass's links say which operand's lanes line up with the output's).
- **ABS702 on CUDA.** ``scatter`` (``src``/``value``), ``index_put``
  without accumulate and with integer indices, and ``index_copy``
  overwrite; a boolean-mask ``index_put`` and ``masked_scatter`` write
  each element once; integer add / amax / amin reductions commute, a
  float accumulate does not on the card. The proof obligations are
  JAX's: one row per batch, constant index rows without duplicates,
  then the pigeonhole; otherwise the scatter is reported.
- **ABS703.** Torch does not clamp: the port reproduces XLA's clamping
  with an explicit ``.clamp``, so the silent hazard is an index whose
  range before that clamp lies outside the axis.
- **Workers.** The lint analyzes the models in the spawned workers
  that record their ticks (``runner.STATIC_WORKERS``); the pass is
  handed their reports and analyzes the rest itself.
- **The scatter census.** ``netsim_scatters`` counts the scatter
  operators of the deliver and enqueue phases: the port's plain
  delivery has one ``scatter_add_`` (the taken-slot count, integer and
  commutative) where JAX's composed-gather delivery has none, and its
  enqueue writes the deadline lane through a view (a write-back, not a
  scatter) where JAX's has one single-row scatter.

Soundness caveats are JAX's: a clean verdict is a proof up to the
affine-widening assumption (the growth measured at the fixed point is
taken as maximal and re-checked once at the horizon state).
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from . import cost_model
from .cost_model import Ref, TickGraph, TNode
from .findings import Finding, SEV_ERROR, SEV_INFO, SEV_WARNING

PASS_NAME = "ranges"

DEFAULT_RANGE_MANIFEST = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "range_manifest.json")

INT32_MIN = -(1 << 31)
INT32_MAX = (1 << 31) - 1
M32 = (1 << 32) - 1

# the largest power-of-two horizon the default analysis probes (one
# clean walk at 2^PROBE_LOG2 proves every smaller horizon)
PROBE_LOG2 = 24

# the production horizon make_sim_config enforces (the delivery
# priority encoding): headroom bits are quoted at this horizon
PRODUCTION_LOG2 = 20

# scatter-family operators the tick calls (the write-backs of in-place
# writes are not scatters: they write one static slice)
_SCATTERS = frozenset({"scatter", "scatter_add", "scatter_reduce",
                       "index_put", "index_copy", "masked_scatter",
                       "index_add", "index_reduce"})

# reductions that commute on integers (a float accumulate does not, on
# the card: the order of the additions changes the rounding)
_COMMUTATIVE_REDUCES = frozenset({"sum", "add", "amax", "amin", "max",
                                  "min", "prod", "multiply"})

Itv = Tuple[float, float]       # (lo, hi); Python ints for int dtypes


def _itv_join(a: Optional[Itv], b: Optional[Itv]) -> Optional[Itv]:
    if a is None:
        return b
    if b is None:
        return a
    return (min(a[0], b[0]), max(a[1], b[1]))


def _itv_join_many(itvs: Sequence[Optional[Itv]]) -> Optional[Itv]:
    out: Optional[Itv] = None
    for i in itvs:
        if i is None:
            return None
        out = _itv_join(out, i)
    return out


_DTYPE_ITV: Dict[torch.dtype, Optional[Itv]] = {}


def _dtype_itv(dtype: torch.dtype) -> Optional[Itv]:
    """The full range of a dtype: the TOP element for tracked kinds,
    None (untracked) for floats."""
    if dtype not in _DTYPE_ITV:
        if dtype == torch.bool:
            _DTYPE_ITV[dtype] = (0, 1)
        elif not dtype.is_floating_point and not dtype.is_complex:
            info = torch.iinfo(dtype)
            _DTYPE_ITV[dtype] = (int(info.min), int(info.max))
        else:
            _DTYPE_ITV[dtype] = None
    return _DTYPE_ITV[dtype]


def _is_int(dtype: torch.dtype) -> bool:
    return dtype != torch.bool and not dtype.is_floating_point \
        and not dtype.is_complex


@dataclass
class Val:
    """Abstract value of one tensor: a whole-tensor interval, plus an
    optional per-lane interval vector when the tensor carries the wire
    format's lane axis (lane coordinate -> interval)."""
    itv: Optional[Itv]
    lanes: Optional[Tuple[Optional[Itv], ...]] = None

    def whole(self) -> Optional[Itv]:
        if self.lanes is not None:
            out: Optional[Itv] = None
            for li in self.lanes:
                out = _itv_join(out, li)
            return out if out is not None else self.itv
        return self.itv


def _val_join(a: Val, b: Val) -> Val:
    if a.lanes is not None and b.lanes is not None \
            and len(a.lanes) == len(b.lanes):
        return Val(None, tuple(_itv_join(x, y)
                               for x, y in zip(a.lanes, b.lanes)))
    return Val(_itv_join(a.whole(), b.whole()))


def _val_eq(a: Val, b: Val) -> bool:
    return a.whole() == b.whole() and a.lanes == b.lanes


def _const_val(arr, lane_axis: Optional[int], n_lanes: int) -> Val:
    """Exact Val of a concrete array (a folded constant)."""
    a = np.asarray(arr)
    if a.dtype.kind == "f":
        if a.size == 0 or not np.isfinite(a).all():
            return Val(None) if a.size else Val((0, 0))
        return Val((float(a.min()), float(a.max())))
    if a.dtype.kind not in "iub":
        return Val(None)
    if a.size == 0:
        return Val((0, 0))
    if lane_axis is not None and a.ndim > lane_axis \
            and a.shape[lane_axis] == n_lanes:
        moved = np.moveaxis(a, lane_axis, 0).reshape(n_lanes, -1)
        return Val(None, tuple((int(r.min()), int(r.max()))
                               for r in moved))
    return Val((int(a.min()), int(a.max())))


def expr_itv(expr, t: Itv) -> Optional[Itv]:
    """The range of a ``TickInt`` expression over ``t`` in ``t``."""
    if isinstance(expr, int):
        return (expr, expr)
    if expr == ("t",):
        return t
    op, a, b = expr
    x, y = expr_itv(a, t), expr_itv(b, t)
    if x is None or y is None:
        return None
    if op == "+":
        return (x[0] + y[0], x[1] + y[1])
    if op == "-":
        return (x[0] - y[1], x[1] - y[0])
    if op == "*":
        cs = (x[0] * y[0], x[0] * y[1], x[1] * y[0], x[1] * y[1])
        return (min(cs), max(cs))
    if op == "//" and y[0] == y[1] and y[0] > 0:
        return (x[0] // y[0], x[1] // y[0])
    if op == "%" and y[0] == y[1] and y[0] > 0:
        c = y[0]
        if x[0] // c == x[1] // c:
            return (x[0] % c, x[1] % c)
        return (0, c - 1)
    return None


def _tdiv(x, y):
    """Division rounding toward zero."""
    if isinstance(x, int) and isinstance(y, int):
        q = abs(x) // abs(y)
        return q if (x < 0) == (y < 0) else -q
    return math.trunc(x / y)


def _norm_dim(d: int, rank: int) -> int:
    return d + rank if d < 0 else d


def _arg(n: TNode, i: int, name: str, default=None):
    """Positional ``i`` or keyword ``name`` of an operator."""
    if len(n.args) > i:
        return n.args[i]
    return n.kwargs.get(name, default)


# the regions priced as one function: rng.* and xla_math.* calls
_RNG_WORDS = frozenset({"rng.threefry2x32", "rng.fold_in", "rng.split",
                        "rng.random_bits", "rng.bits_of_split",
                        "rng.prng_key", "rng._as_word"})


class _Interp:
    """One forward interval walk over one recorded tick (or the init
    graph, with no tagger).

    ``tagger`` is the lanes pass's ``_Analyzer`` of the graph, already
    folded and tagged: it gives each value's lane axis and the constants
    folded on the CPU (those depending on a ``TickInt`` argument are
    dropped: they hold the recorded ``t``'s value)."""

    def __init__(self, g: TickGraph, tagger, n_lanes: int):
        self.g = g
        self.tagger = tagger
        self.L = n_lanes
        self.t: Itv = (0, 0)
        self.notes: List[str] = []
        self.record = False
        self.overflow_sites: List[Dict[str, Any]] = []
        self.oob_sites: List[Dict[str, Any]] = []
        self.race_sites: List[Dict[str, Any]] = []
        self.scatter_census: Dict[str, int] = {}
        self.excess: float = -float("inf")
        consts = {v.vid: v.value for v in g.values
                  if v.kind == "const" and v.value is not None}
        if tagger is not None:
            tainted: Set[int] = set()
            for n in g.nodes:
                if n.sym or any(v in tainted for v in n.ins):
                    tainted.update(n.outs)
            consts.update({v: a for v, a in tagger.consts.items()
                           if v not in tainted})
        self.consts: Dict[int, np.ndarray] = consts
        # a region's outputs: the values it makes that something outside
        # it reads (or the graph returns)
        made: Dict[int, int] = {}
        for n in g.nodes:
            if n.region is not None:
                for v in n.outs:
                    made[v] = n.region
        self.region_outs: Dict[int, List[int]] = {}
        self.region_ins: Dict[int, List[int]] = {}
        for n in g.nodes:
            for v in n.ins:
                r = made.get(v)
                if r is not None and r != n.region:
                    outs = self.region_outs.setdefault(r, [])
                    if v not in outs:
                        outs.append(v)
            if n.region is not None:
                ins = self.region_ins.setdefault(n.region, [])
                for v in n.ins:
                    if made.get(v) != n.region and v not in ins:
                        ins.append(v)
        for v in g.outputs:
            r = made.get(v)
            if r is not None and v not in self.region_outs.setdefault(r, []):
                self.region_outs[r].append(v)
        # per operator, the operands whose lane axis lines up with the
        # output's (the tagger's coordinate-keeping links)
        self._aligned: Dict[int, Set[int]] = {}
        if tagger is not None:
            for n in g.nodes:
                ok = set()
                for src, dst, amap in tagger.links[n.idx]:
                    ts, td = tagger._tag(src), tagger._tag(dst)
                    if ts is not None and td is not None \
                            and amap.get(ts) == td:
                        ok.add(src)
                self._aligned[n.idx] = ok
        self._cvals: Dict[int, Val] = {}
        self._axes: Dict[int, Optional[int]] = {}
        # per operator: its last input Vals (and t, where it reads t) and
        # its outputs then (a walk outside the recording one reuses them
        # when unchanged)
        self._memo: Dict[int, Tuple[Any, List[Val]]] = {}
        self._plans = self._make_plans()

    # -- plumbing --

    def note(self, msg: str):
        if msg not in self.notes:
            self.notes.append(msg)

    def _lane_axis(self, vid) -> Optional[int]:
        if self.tagger is None or vid is None:
            return None
        got = self._axes.get(vid, -1)
        if got == -1:
            got = self._axes[vid] = self.tagger._lane_axis(vid)
        return got

    def _dtype(self, vid) -> torch.dtype:
        return self.g.values[vid].dtype

    def _shape(self, vid) -> Tuple[int, ...]:
        return self.g.values[vid].shape

    def _get(self, env, vid) -> Val:
        got = env.get(vid)
        if got is not None:
            return got
        got = self._cvals.get(vid)
        if got is not None:
            return got
        cv = self.consts.get(vid)
        got = _const_val(cv, self._lane_axis(vid), self.L) \
            if cv is not None else self._top(vid)
        self._cvals[vid] = got
        return got

    def _top(self, vid) -> Val:
        return Val(_dtype_itv(self._dtype(vid)))

    def _phase(self, n: TNode) -> str:
        return (n.phase if n.phase in cost_model.PHASES
                else cost_model.OTHER_PHASE)

    def _scalar(self, n: TNode, key, a) -> Val:
        """A non-tensor argument's Val: a ``TickInt`` expression over the
        abstract ``t``, or the number itself."""
        if n.sym and key in n.sym:
            return Val(expr_itv(n.sym[key], self.t))
        if isinstance(a, bool):
            return Val((int(a), int(a)))
        if isinstance(a, int):
            return Val((a, a))
        if isinstance(a, float):
            return Val((a, a)) if math.isfinite(a) else Val(None)
        return Val(None)

    def _opnd(self, env, n: TNode, i: int, name: str = "", default=None):
        """Operand ``i`` (or keyword ``name``) as ``(vid or None, Val)``."""
        if len(n.args) > i:
            key, a = i, n.args[i]
        elif name in n.kwargs:
            key, a = name, n.kwargs[name]
        else:
            key, a = None, default
        if isinstance(a, Ref):
            return a.vid, self._get(env, a.vid)
        if a is None:
            return None, Val(None)
        return None, self._scalar(n, key, a)

    def _mk(self, out, itv: Optional[Itv],
            lanes: Optional[Tuple] = None) -> Val:
        """Clamp a computed Val to the output's dtype range and attach
        lanes only when the output is lane-tagged."""
        top = _dtype_itv(self._dtype(out))
        if top is None:
            if lanes is not None:
                itv = _itv_join(itv, _itv_join_many(lanes))
            return Val(itv)

        t_lo, t_hi = top

        def cl(i):
            if i is None:
                return top
            lo, hi = i
            if t_lo <= lo and hi <= t_hi:
                return i
            return (max(t_lo, min(lo, t_hi)), max(t_lo, min(hi, t_hi)))
        if lanes is not None and self._lane_axis(out) is not None \
                and len(lanes) == self.L:
            return Val(None, tuple(cl(i) for i in lanes))
        if lanes is not None:
            joined: Optional[Itv] = None
            for li in lanes:
                joined = _itv_join(joined, li)
            itv = _itv_join(itv, joined)
        return Val(cl(itv))

    def _runtime(self, n: TNode) -> bool:
        return bool(n.sym) or any(v not in self.consts for v in n.ins)

    def _check_ovf(self, n: TNode, lo, hi, in_itvs) -> Itv:
        """Record an ABS701 site when an int32 result escapes int32,
        when every operand was itself strictly inside int32 (a saturated
        operand was reported upstream) and one operand is runtime state
        (an all-constant wrap is not horizon-reachable)."""
        if self.record and n.outs and self._dtype(n.outs[0]) == torch.int32:
            clean_ins = all(i is not None and i[0] > INT32_MIN
                            and i[1] < INT32_MAX for i in in_itvs)
            if clean_ins and self._runtime(n):
                # how far the nearest site is from overflowing: guides
                # the search for the minimal overflowing T
                self.excess = max(self.excess, hi - INT32_MAX,
                                  INT32_MIN - lo)
                if lo < INT32_MIN or hi > INT32_MAX:
                    self.overflow_sites.append({
                        "kind": "eqn", "prim": n.name,
                        "phase": self._phase(n),
                        "lo": int(lo), "hi": int(hi)})
        return (lo, hi)

    def _lanes_of(self, n: TNode, vid, v: Val):
        """``v``'s lanes when they line up with the output's lanes."""
        if vid is None or v.lanes is None or len(v.lanes) != self.L:
            return None
        if vid not in self._aligned.get(n.idx, ()):
            return None
        return v.lanes

    def _aligned_lanes(self, n: TNode, opnds) -> Optional[List[Tuple]]:
        """Per-lane operand rows when the operator can run lane-wise:
        the output carries lanes and some operand's lanes line up."""
        if not n.outs or self._lane_axis(n.outs[0]) is None:
            return None
        cols, any_lanes = [], False
        for vid, v in opnds:
            ln = self._lanes_of(n, vid, v)
            if ln is not None:
                any_lanes = True
                cols.append(ln)
            else:
                cols.append((v.whole(),) * self.L)
        if not any_lanes:
            return None
        return [tuple(c[i] for c in cols) for i in range(self.L)]

    # -- the walk --

    def _make_plans(self):
        """The walk's two orders of work: every operator but those whose
        outputs all folded to constants and those inside a call priced
        as a function (priced once, at its first operator), for the
        recording walk; and of those, only the ones the carry's next
        value depends on, for the fixed point's walks."""
        g = self.g
        first: Dict[int, int] = {}
        plan = []
        for n in g.nodes:
            r = n.region
            if r is not None and self._priced(r):
                if r not in first:
                    first[r] = n.idx
                    plan.append(("region", n))
                continue
            if n.outs and all(v in self.consts for v in n.outs):
                continue
            plan.append(("op", n))
        need = set(g.outputs[:g.n_carry_out])
        carry_plan = []
        for kind, n in reversed(plan):
            outs = self.region_outs.get(n.region, []) if kind == "region" \
                else n.outs
            if any(v in need for v in outs):
                carry_plan.append((kind, n))
                need.update(self.region_ins.get(n.region, [])
                            if kind == "region" else n.ins)
        return plan, carry_plan[::-1]

    def _priced(self, r: int) -> bool:
        """Whether :meth:`_region` prices this call (else its operators
        are walked)."""
        reg = self.g.regions[r]
        f, p = reg.func, reg.params
        if f in ("rng.randint", "rng.randint_from_bits"):
            return isinstance(p.get("minval"), int) and \
                isinstance(p.get("maxval"), int)
        if f == "rng.permutation":
            return isinstance(p.get("n"), int)
        if f in ("rng._wrap_i32", "xla_math.log", "xla_math.fma_f32"):
            return bool(self.region_ins.get(r))
        return f in _RNG_WORDS or f in ("rng.unit_float", "rng.uniform",
                                         "rng.uniform_from_bits",
                                         "rng.bernoulli")

    def run(self, input_vals: Sequence[Val]) -> List[Val]:
        """One walk: the graph's inputs bound to ``input_vals``; returns
        a Val per graph output (outside the recording walk, only the
        carry's are computed)."""
        env: Dict[int, Val] = {}
        for vid, val in zip(self.g.inputs, input_vals):
            env[vid] = val
        record = self.record
        for kind, n in self._plans[0] if record else self._plans[1]:
            if kind == "region":
                env.update(self._region(env, n.region))
                continue
            key = None
            if not record:
                key = (self.t if n.sym else None,
                       tuple(map(env.get, n.ins)))
                hit = self._memo.get(n.idx)
                if hit is not None and hit[0] == key:
                    for v, val in zip(n.outs, hit[1]):
                        env[v] = val
                    continue
            try:
                outs = self._eval(env, n)
            except Exception as e:  # a transfer bug must degrade, not die
                self.note(f"transfer for '{n.name}' raised "
                          f"{type(e).__name__} — widened to dtype-full")
                outs = [self._top(v) for v in n.outs]
            if key is not None:
                self._memo[n.idx] = (key, outs)
            for v, val in zip(n.outs, outs):
                env[v] = val
        return [self._get(env, v) for v in self.g.outputs]

    def _region(self, env, r: int) -> Dict[int, Val]:
        """One rng / xla_math call priced as a function (those
        :meth:`_priced` accepts)."""
        reg = self.g.regions[r]
        f, p = reg.func, reg.params
        outs = self.region_outs.get(r, [])
        ins = self.region_ins.get(r, [])

        def each(itv_of):
            return {v: self._mk(v, itv_of(v)) for v in outs}

        if f in _RNG_WORDS:
            return each(lambda v: (0, M32) if self._dtype(v) == torch.int64
                        else _dtype_itv(self._dtype(v)))
        if f == "rng.unit_float":
            return each(lambda v: (0.0, 1.0))
        if f in ("rng.uniform", "rng.uniform_from_bits"):
            lo = float(np.float32(p.get("minval", 0.0)))
            hi = float(np.float32(p.get("maxval", 1.0)))
            return each(lambda v: (min(lo, hi), max(lo, hi)))
        if f == "rng.bernoulli":
            return each(lambda v: (0, 1))
        if f == "rng._wrap_i32":
            # the defined two's-complement wrap of a bit pattern
            x = self._get(env, ins[0]).whole()
            if x is not None and 0 <= x[0] and x[1] <= INT32_MAX:
                return each(lambda v: x)
            return each(lambda v: _dtype_itv(self._dtype(v)))
        if f in ("rng.randint", "rng.randint_from_bits"):
            lo, hi = p["minval"], p["maxval"]
            span = ((hi - lo) & M32) if hi > lo else 1
            return each(lambda v: (lo, lo + span - 1))
        if f == "rng.permutation":
            return each(lambda v: (0, max(0, p["n"] - 1)))
        if f == "xla_math.log":
            x = self._get(env, ins[0]).whole()
            if x is None or not x[0] > 0:
                return each(lambda v: None)
            lo = max(x[0], float(np.float32(1.17549435e-38)))
            return each(lambda v: (math.log(lo), math.log(max(lo, x[1]))))
        if f == "xla_math.fma_f32":
            a = self._get(env, ins[0]).whole()
            rest = [self._get(env, v).whole() for v in ins[1:]]
            b = (p["b"], p["b"]) if "b" in p else (rest.pop(0) if rest
                                                   else None)
            c = (p["c"], p["c"]) if "c" in p else (rest.pop(0) if rest
                                                   else None)
            if a is None or b is None or c is None:
                return each(lambda v: None)
            cs = (a[0] * b[0], a[0] * b[1], a[1] * b[0], a[1] * b[1])
            return each(lambda v: (min(cs) + c[0], max(cs) + c[1]))
        raise ValueError(f"no pricing for {f}")

    def _eval(self, env, n: TNode) -> List[Val]:
        h = _HANDLERS.get(n.name)
        if h is not None:
            return h(self, env, n)
        if any(_is_int(self._dtype(v)) for v in n.outs):
            self.note(f"unmodeled operator '{n.name}' — outputs widened "
                      f"to dtype-full")
        return [self._top(v) for v in n.outs]

    # -- elementwise --

    def _binop_itv(self, name, a: Optional[Itv], b: Optional[Itv],
                   n: TNode, alpha=1) -> Optional[Itv]:
        if a is None or b is None:
            return None
        out_dt = self._dtype(n.outs[0])
        if name in ("add", "sub", "rsub") and alpha != 1:
            cs = (b[0] * alpha, b[1] * alpha)
            b = (min(cs), max(cs))
        (al, ah), (bl, bh) = a, b
        if name == "add":
            lo, hi = al + bl, ah + bh
        elif name == "sub":
            lo, hi = al - bh, ah - bl
        elif name == "rsub":
            lo, hi = bl - ah, bh - al
        elif name == "mul":
            cs = (al * bl, al * bh, ah * bl, ah * bh)
            lo, hi = min(cs), max(cs)
        elif name == "maximum":
            lo, hi = max(al, bl), max(ah, bh)
        elif name == "minimum":
            lo, hi = min(al, bl), min(ah, bh)
        elif name in ("remainder", "fmod"):
            return self._mod(name, a, b)
        elif name in ("floor_divide", "div_floor", "div_trunc"):
            return self._intdiv(name, a, b)
        elif name == "div":
            if not out_dt.is_floating_point or bl <= 0 <= bh:
                return None
            cs = (al / bl, al / bh, ah / bl, ah / bh)
            return (min(cs), max(cs))
        else:
            return None
        return self._check_ovf(n, lo, hi, [a, b])

    @staticmethod
    def _mod(name, a: Itv, b: Itv) -> Itv:
        (al, ah), (bl, bh) = a, b
        if name == "remainder":          # floor modulo: sign of divisor
            if bl > 0:
                if al >= 0 and ah < bl:
                    return (al, ah)
                return (0, min(bh - 1, ah) if al >= 0 else bh - 1)
            if bh < 0:
                return (bl + 1, 0)
            m = max(abs(bl), abs(bh))
            return (-(m - 1), m - 1)
        # fmod: truncating, sign of dividend (lax.rem)
        m = max(abs(bl), abs(bh))
        m = max(0, m - 1) if isinstance(m, int) else m
        m = min(m, max(abs(al), abs(ah)))
        return (0 if al >= 0 else -m, 0 if ah <= 0 else m)

    @staticmethod
    def _intdiv(name, a: Itv, b: Itv) -> Itv:
        (al, ah), (bl, bh) = a, b
        if bl <= 0 <= bh:
            m = max(abs(al), abs(ah))
            return (0 if al >= 0 and bl >= 0 else -m, m)
        if name == "div_trunc":
            f = _tdiv
        else:
            f = lambda x, y: x // y if isinstance(x, int) and \
                isinstance(y, int) else math.floor(x / y)  # noqa: E731
        cs = [f(x, y) for x in (al, ah) for y in (bl, bh)]
        return (min(cs), max(cs))

    def _binop(self, env, n: TNode, name=None) -> List[Val]:
        name = name or n.name
        a = self._opnd(env, n, 0, "self")
        b = self._opnd(env, n, 1, "other")
        alpha = n.kwargs.get("alpha", 1)
        if name == "div":
            mode = n.kwargs.get("rounding_mode")
            if mode is not None:
                name = f"div_{mode}"
        lanes_in = self._aligned_lanes(n, [a, b])
        if lanes_in is not None:
            lanes = tuple(self._binop_itv(name, x, y, n, alpha)
                          for x, y in lanes_in)
            return [self._mk(n.outs[0], None, lanes)]
        return [self._mk(n.outs[0], self._binop_itv(
            name, a[1].whole(), b[1].whole(), n, alpha))]

    def _unop(self, env, n: TNode) -> List[Val]:
        name = n.name
        vid, v = self._opnd(env, n, 0, "self")
        out = n.outs[0]

        def one(i: Optional[Itv]) -> Optional[Itv]:
            if i is None:
                if name == "sign":
                    return (-1, 1)
                return None
            lo, hi = i
            try:
                if name == "neg":
                    return self._check_ovf(n, -hi, -lo, [i])
                if name == "abs":
                    return self._check_ovf(
                        n, 0 if lo <= 0 <= hi else min(abs(lo), abs(hi)),
                        max(abs(lo), abs(hi)), [i])
                if name == "sign":
                    return (-1 if lo < 0 else (0 if lo == 0 else 1),
                            1 if hi > 0 else (0 if hi == 0 else -1))
                if name == "bitwise_not":
                    if self._dtype(out) == torch.bool:
                        return (0, 1)
                    return (-hi - 1, -lo - 1)
                if name == "exp":
                    return (math.exp(min(lo, 700)), math.exp(min(hi, 700)))
                if name == "log":
                    return (math.log(lo), math.log(hi)) if lo > 0 else None
                if name == "sqrt":
                    return (math.sqrt(lo), math.sqrt(hi)) if lo >= 0 \
                        else None
                if name == "floor":
                    return (math.floor(lo), math.floor(hi))
                if name == "ceil":
                    return (math.ceil(lo), math.ceil(hi))
                if name in ("round", "trunc"):
                    f = round if name == "round" else math.trunc
                    return (f(lo), f(hi))
            except (OverflowError, ValueError):
                return None
            return None
        ln = self._lanes_of(n, vid, v)
        if ln is not None and self._lane_axis(out) is not None:
            return [self._mk(out, None, tuple(one(i) for i in ln))]
        return [self._mk(out, one(v.whole()))]

    def _compare(self, env, n: TNode) -> List[Val]:
        return [self._mk(v, (0, 1)) for v in n.outs]

    def _bitwise(self, env, n: TNode) -> List[Val]:
        name = n.name.replace("bitwise_", "")
        out = n.outs[0]
        a = self._opnd(env, n, 0, "self")
        b = self._opnd(env, n, 1, "other")

        def one(x: Optional[Itv], y: Optional[Itv]) -> Optional[Itv]:
            if self._dtype(out) == torch.bool:
                return (0, 1)
            if x is None or y is None:
                return None
            if name == "and" and (x[0] >= 0 or y[0] >= 0):
                hi = min(z[1] for z in (x, y) if z[0] >= 0)
                return (0, hi)
            if x[0] < 0 or y[0] < 0:
                m = max(abs(x[0]), abs(x[1]), abs(y[0]), abs(y[1]), 1)
                bits = int(m).bit_length()
                return (-(1 << bits), (1 << bits) - 1)
            if name == "and":
                return (0, min(x[1], y[1]))
            bits = max(int(x[1]).bit_length(), int(y[1]).bit_length())
            lo = max(x[0], y[0]) if name == "or" else 0
            return (lo, (1 << bits) - 1)
        lanes_in = self._aligned_lanes(n, [a, b])
        if lanes_in is not None:
            return [self._mk(out, None, tuple(one(x, y)
                                              for x, y in lanes_in))]
        return [self._mk(out, one(a[1].whole(), b[1].whole()))]

    def _shift(self, env, n: TNode) -> List[Val]:
        left = "lshift" in n.name or "left" in n.name
        out = n.outs[0]
        a = self._opnd(env, n, 0, "self")[1].whole()
        s = self._opnd(env, n, 1, "other")[1].whole()
        if a is None or s is None:
            return [self._top(out)]
        sl, sh = max(0, int(s[0])), int(min(max(s[1], 0), 63))
        if left:
            # bit plumbing (the bitset idiom's 1 << bit): a shift past
            # the dtype is the defined wrap, never an ABS701
            if a[0] < 0:
                return [self._top(out)]
            lo, hi = int(a[0]) << sl, int(a[1]) << sh
            top = _dtype_itv(self._dtype(out))
            if top is not None and hi > top[1]:
                return [Val(top)]
            return [self._mk(out, (lo, hi))]
        # torch's >> on signed integers is arithmetic
        if a[0] < 0:
            return [self._mk(out, (int(a[0]) >> sl, int(a[1]) >> sl))]
        return [self._mk(out, (int(a[0]) >> sh, int(a[1]) >> sl))]

    def _pow(self, env, n: TNode) -> List[Val]:
        out = n.outs[0]
        a = self._opnd(env, n, 0, "self")[1].whole()
        b = self._opnd(env, n, 1, "exponent")[1].whole()
        if a is None or b is None or a[0] < 0 or b[0] < 0:
            return [self._top(out)]
        try:
            cs = [x ** y for x in (a[0], a[1]) for y in (b[0], b[1])]
        except OverflowError:
            return [self._top(out)]
        lo, hi = min(cs), max(cs)
        if a[0] <= 1:
            lo = min(lo, 0 if a[0] == 0 else 1)
        return [self._mk(out, self._check_ovf(n, lo, hi, [a, b]))]

    def _where(self, env, n: TNode) -> List[Val]:
        out = n.outs[0]
        c = self._opnd(env, n, 0, "condition")
        a = self._opnd(env, n, 1, "self")
        b = self._opnd(env, n, 2, "other")
        lanes_in = self._aligned_lanes(n, [c, a, b])
        if lanes_in is not None:
            return [self._mk(out, None, tuple(_itv_join_many(r[1:])
                                              for r in lanes_in))]
        w = _itv_join_many([a[1].whole(), b[1].whole()])
        return [self._mk(out, w)]

    def _clamp(self, env, n: TNode) -> List[Val]:
        out = n.outs[0]
        x = self._opnd(env, n, 0, "self")
        if n.name == "clamp_min":
            lo_o, hi_o = self._opnd(env, n, 1, "min"), (None, Val(None))
        elif n.name == "clamp_max":
            lo_o, hi_o = (None, Val(None)), self._opnd(env, n, 1, "max")
        else:
            lo_o = self._opnd(env, n, 1, "min")
            hi_o = self._opnd(env, n, 2, "max")
        inf = float("inf")

        def one(lo_i, x_i, hi_i):
            if x_i is None:
                return None
            lo_i = lo_i if lo_i is not None else (-inf, -inf)
            hi_i = hi_i if hi_i is not None else (inf, inf)
            return (min(max(x_i[0], lo_i[0]), hi_i[0]),
                    min(max(x_i[1], lo_i[1]), hi_i[1]))
        lanes_in = self._aligned_lanes(n, [lo_o, x, hi_o])
        if lanes_in is not None:
            return [self._mk(out, None, tuple(one(a, b, c)
                                              for a, b, c in lanes_in))]
        return [self._mk(out, one(lo_o[1].whole(), x[1].whole(),
                                  hi_o[1].whole()))]

    def _convert(self, env, n: TNode) -> List[Val]:
        """``_to_copy`` / ``copy``: a dtype conversion (truncating from
        floats; an int64 -> int32 narrowing that escapes int32 is an
        ABS701 site, the value the carry gets wraps)."""
        out = n.outs[0]
        if n.name == "copy":
            vid, v = self._opnd(env, n, 1, "src")
        else:
            vid, v = self._opnd(env, n, 0, "self")
        src = self._dtype(vid) if vid is not None else None
        dst = self._dtype(out)
        dst_top = _dtype_itv(dst)

        def one(i: Optional[Itv]) -> Optional[Itv]:
            if i is None:
                return dst_top
            if dst_top is None:
                return (float(i[0]), float(i[1]))
            if dst == torch.bool:
                return (0, 1) if i[0] <= 0 <= i[1] or i[0] != i[1] \
                    else ((0, 0) if i == (0, 0) else (1, 1))
            lo, hi = i
            if src is not None and src.is_floating_point:
                if not (math.isfinite(lo) and math.isfinite(hi)):
                    return dst_top
                lo, hi = math.trunc(lo), math.trunc(hi)
            if lo < dst_top[0] or hi > dst_top[1]:
                if dst == torch.int32 and src == torch.int64 \
                        and lo > -(1 << 63) and hi < (1 << 63) - 1:
                    self._check_ovf(n, lo, hi, [])
                return dst_top
            return (int(lo), int(hi))
        ln = self._lanes_of(n, vid, v)
        if ln is not None and self._lane_axis(out) is not None:
            return [Val(None, tuple(one(i) for i in ln))]
        return [Val(one(v.whole()))]

    def _bitcast(self, env, n: TNode) -> List[Val]:
        """``view.dtype``: the mantissa trick ``bits | 0x3F800000``
        viewed as float32 is [1, 2); everything else is opaque."""
        out = n.outs[0]
        vid, v = self._opnd(env, n, 0, "self")
        w = v.whole()
        if self._dtype(out).is_floating_point and vid is not None \
                and _is_int(self._dtype(vid)) and w is not None \
                and 0x3F800000 <= w[0] and w[1] <= 0x3FFFFFFF:
            return [Val((1.0, 2.0))]
        return [self._top(out)]

    # -- structure --

    def _pass(self, env, n: TNode) -> List[Val]:
        """Operators that move values without changing them (views,
        copies, broadcasts, reorders): lanes carry over when the tagger
        links the operand's lane axis to the output's."""
        vid, v = self._opnd(env, n, 0, "self")
        res = []
        for o in n.outs:
            ln = self._lanes_of(n, vid, v)
            if self._lane_axis(o) is not None and ln is not None:
                res.append(Val(None, ln))
            elif self._lane_axis(o) is not None and v.lanes is None \
                    and v.itv is not None:
                res.append(Val(None, (v.itv,) * self.L))
            else:
                res.append(self._mk(o, v.whole()))
        return res

    def _lane_pick(self, env, n: TNode, x, lanes_sel) -> Val:
        """The value of lanes ``lanes_sel`` of ``x``, joined."""
        vid, v = x
        if v.lanes is None:
            return self._mk(n.outs[0], v.whole())
        sel = [v.lanes[i] for i in lanes_sel if 0 <= i < self.L]
        return self._mk(n.outs[0], _itv_join_many(sel) if sel
                        else v.whole())

    def _select(self, env, n: TNode) -> List[Val]:
        x = self._opnd(env, n, 0, "self")
        shp = self._shape(x[0])
        d = _norm_dim(n.args[1], len(shp))
        idx = self._scalar(n, 2, n.args[2]).whole()
        size = shp[d]
        if idx is not None:
            lo, hi = idx
            if lo == hi and lo < 0:
                lo = hi = lo + size
            if hi < -size or lo > size - 1:
                self._record_oob(n, size, lo, hi, f"select axis {d}",
                                 clamped=False)
        if self.tagger is not None and self.tagger._tag(x[0]) == d \
                and x[1].lanes is not None and idx is not None:
            lo, hi = max(0, int(idx[0])), min(self.L - 1, int(idx[1]))
            return [self._lane_pick(env, n, x, range(lo, hi + 1))]
        return self._pass(env, n)

    def _slice(self, env, n: TNode) -> List[Val]:
        x = self._opnd(env, n, 0, "self")
        shp = self._shape(x[0])
        a = n.args
        d = _norm_dim(a[1] if len(a) > 1 else 0, len(shp))
        if self.tagger is not None and self.tagger._tag(x[0]) == d \
                and x[1].lanes is not None:
            size = shp[d]
            start = a[2] if len(a) > 2 and a[2] is not None else 0
            end = a[3] if len(a) > 3 and a[3] is not None else size
            step = a[4] if len(a) > 4 else 1
            start = max(0, min(start + size if start < 0 else start, size))
            end = max(0, min(end + size if end < 0 else end, size))
            sel = range(start, end, step)
            if len(sel) == self.L and self._lane_axis(n.outs[0]) is not None:
                return [Val(None, tuple(x[1].lanes[i] for i in sel))]
            return [self._lane_pick(env, n, x, sel)]
        return self._pass(env, n)

    def _cat(self, env, n: TNode) -> List[Val]:
        out = n.outs[0]
        refs = [x for x in n.args[0] if isinstance(x, Ref)]
        vals = [(r.vid, self._get(env, r.vid)) for r in refs]
        d = _norm_dim(n.args[1] if len(n.args) > 1
                      else n.kwargs.get("dim", 0), len(self._shape(out)))
        la = self._lane_axis(out)
        if la is not None and la == d and n.name == "cat":
            lanes: List[Optional[Itv]] = []
            for vid, v in vals:
                size = self._shape(vid)[d]
                if v.lanes is not None and len(v.lanes) == size:
                    lanes.extend(v.lanes)
                else:
                    lanes.extend([v.whole()] * size)
            if len(lanes) == self.L:
                return [Val(None, tuple(lanes))]
        if la is not None:
            pieces = [self._lanes_of(n, vid, v) or (v.whole(),) * self.L
                      for vid, v in vals]
            return [self._mk(out, None, tuple(
                _itv_join_many([p[i] for p in pieces])
                for i in range(self.L)))]
        return [self._mk(out, _itv_join_many([v.whole() for _, v in vals]))]

    def _pad(self, env, n: TNode) -> List[Val]:
        x = self._opnd(env, n, 0, "self")
        value = self._scalar(n, 2, n.args[2] if len(n.args) > 2
                             else n.kwargs.get("value", 0))
        w = _itv_join(x[1].whole(), value.whole())
        return [self._mk(n.outs[0], w)]

    def _unbind(self, env, n: TNode) -> List[Val]:
        x = self._opnd(env, n, 0, "self")
        shp = self._shape(x[0])
        d = _norm_dim(n.args[1] if len(n.args) > 1 else 0, len(shp))
        if self.tagger is not None and self.tagger._tag(x[0]) == d \
                and x[1].lanes is not None:
            return [self._mk(o, x[1].lanes[i]) if i < self.L
                    else self._mk(o, x[1].whole())
                    for i, o in enumerate(n.outs)]
        return self._pass(env, n)

    # -- creation --

    def _create(self, env, n: TNode) -> List[Val]:
        out = n.outs[0]
        name = n.name
        if name in ("zeros", "zeros_like", "new_zeros"):
            return [self._mk(out, (0, 0))]
        if name in ("ones", "ones_like", "new_ones"):
            return [self._mk(out, (1, 1))]
        if name == "scalar_tensor":
            return [self._mk(out, self._scalar(n, 0, n.args[0]).whole())]
        if name in ("full", "full_like", "new_full"):
            return [self._mk(out, self._scalar(
                n, 1, n.args[1] if len(n.args) > 1
                else n.kwargs.get("fill_value")).whole())]
        if name == "eye":
            return [self._mk(out, (0, 1))]
        if name == "arange":
            nums = [self._scalar(n, i, a).whole() for i, a in
                    enumerate(n.args) if not isinstance(a, Ref)]
            if len(nums) == 1:
                start, end = (0, 0), nums[0]
            else:
                start, end = nums[0], nums[1]
            if start is None or end is None:
                return [self._top(out)]
            size = self._shape(out)[0] if self._shape(out) else 1
            if self._lane_axis(out) == 0 and size == self.L \
                    and start[0] == start[1]:
                step = (end[0] - start[0]) / max(size, 1)
                return [Val(None, tuple(
                    (start[0] + int(round(step)) * i,) * 2
                    for i in range(self.L)))]
            return [self._mk(out, (start[0], max(start[0], end[1] - 1)))]
        return [self._top(out)]

    # -- reductions --

    def _reduce(self, env, n: TNode) -> List[Val]:
        name = n.name
        vid, v = self._opnd(env, n, 0, "self")
        shp = self._shape(vid)
        from .lane_liveness import _reduce_dims
        dims = _reduce_dims(n, len(shp))
        cnt = 1
        for d in dims:
            cnt *= int(shp[d])
        out = n.outs[0]
        if name in ("any", "all"):
            return [self._mk(out, (0, 1))]
        if name in ("argmax", "argmin"):
            dim = _arg(n, 1, "dim")
            size = int(np.prod(shp)) if dim is None else \
                shp[_norm_dim(dim, len(shp))]
            return [self._mk(out, (0, max(0, size - 1)))]
        if name in ("sum", "mean"):
            la = self.tagger._tag(vid) if self.tagger is not None else None
            if name == "sum" and la is not None and la in dims \
                    and v.lanes is not None and len(v.lanes) == self.L:
                rest = cnt // self.L if self.L else cnt
                lo = sum((i[0] if i else INT32_MIN) for i in v.lanes)
                hi = sum((i[1] if i else INT32_MAX) for i in v.lanes)
                lo, hi = lo * max(1, rest), hi * max(1, rest)
            else:
                w = v.whole()
                if w is None:
                    return [self._top(out)]
                if name == "mean":
                    return [self._mk(out, w)]
                lo, hi = min(w[0], w[0] * cnt), max(w[1], w[1] * cnt)
            if v.whole() is not None:
                lo, hi = self._check_ovf(n, lo, hi, [v.whole()])
            return [self._mk(out, (lo, hi))]
        if name == "prod":
            return [self._top(out)]
        # amax / amin / max.dim / min.dim keep the value envelope; the
        # .dim forms also return indices
        res = [self._mk(out, v.whole())]
        for o in n.outs[1:]:
            dim = _arg(n, 1, "dim")
            size = shp[_norm_dim(dim, len(shp))] if dim is not None else \
                int(np.prod(shp))
            res.append(self._mk(o, (0, max(0, size - 1))))
        return res

    def _sort(self, env, n: TNode) -> List[Val]:
        vid, v = self._opnd(env, n, 0, "self")
        shp = self._shape(vid)
        if n.name == "topk":
            dim = _arg(n, 2, "dim", -1)
        elif len(n.args) > 1 and isinstance(n.args[1], bool) \
                and n.name == "sort":
            dim = _arg(n, 2, "dim", -1)       # sort.stable(self, stable, dim)
        else:
            dim = _arg(n, 1, "dim", -1)
        dim = n.kwargs.get("dim", dim)
        size = shp[_norm_dim(dim, len(shp))] if shp else 1
        first = self._pass(env, n)[0]
        return [first] + [self._mk(o, (0, max(0, size - 1)))
                          for o in n.outs[1:]]

    def _cumsum(self, env, n: TNode) -> List[Val]:
        vid, v = self._opnd(env, n, 0, "self")
        w = v.whole()
        out = n.outs[0]
        if w is None:
            return [self._top(out)]
        d = _norm_dim(_arg(n, 1, "dim"), len(self._shape(vid)))
        k = int(self._shape(vid)[d])
        lo, hi = min(w[0], w[0] * k), max(w[1], w[1] * k)
        return [self._mk(out, self._check_ovf(n, lo, hi, [w]))]

    def _searchsorted(self, env, n: TNode) -> List[Val]:
        """An insertion index: ``[0, len(boundaries)]``."""
        if n.name == "bucketize":
            seq = n.args[1]
        else:
            seq = n.args[0]
        size = self._shape(seq.vid)[-1] if isinstance(seq, Ref) and \
            self._shape(seq.vid) else 1
        return [self._mk(o, (0, size)) for o in n.outs]

    # -- gather / scatter / index --

    def _record_oob(self, n: TNode, axis_size, lo, hi, what,
                    clamped: bool):
        if self.record:
            self.oob_sites.append({
                "prim": n.name, "phase": self._phase(n),
                "what": what + (" (before its clamp)" if clamped else ""),
                "axis_size": int(axis_size), "lo": int(lo), "hi": int(hi)})

    def _pre_clamp(self, env, vid) -> Tuple[Optional[Itv], bool]:
        """The index's range before the ``.clamp`` that reproduces XLA's
        clamping (through casts, views and broadcasts), and whether one
        was found; else its own range."""
        g = self.g
        cur = vid
        for _ in range(16):
            prod = g.values[cur].producer
            if prod is None:
                break
            p = g.nodes[prod]
            if p.name in ("clamp", "clamp_min", "clamp_max"):
                src = p.args[0]
                if isinstance(src, Ref):
                    return self._get(env, src.vid).whole(), True
                break
            if p.name in ("_to_copy", "view", "_unsafe_view", "expand",
                          "reshape", "unsqueeze", "squeeze", "clone",
                          "alias", "slice", "select", "permute",
                          "contiguous", "repeat") \
                    and p.args and isinstance(p.args[0], Ref):
                cur = p.args[0].vid
                continue
            break
        return self._get(env, vid).whole(), False

    def _index_cols(self, env, idx_vid) -> Optional[Itv]:
        arr = self.consts.get(idx_vid)
        if arr is not None and np.asarray(arr).size:
            return (int(np.min(arr)), int(np.max(arr)))
        return self._get(env, idx_vid).whole()

    def _check_index(self, env, n: TNode, idx_vid, size: int, what: str):
        if not self.record:
            return
        pre, clamped = self._pre_clamp(env, idx_vid)
        if pre is None:
            return
        lo, hi = pre
        if clamped:
            if lo > size - 1 or hi < 0:
                self._record_oob(n, size, lo, hi, what, clamped=True)
        elif lo > size - 1 or hi < -size:
            self._record_oob(n, size, lo, hi, what, clamped=False)

    def _gather(self, env, n: TNode) -> List[Val]:
        x = self._opnd(env, n, 0, "self")
        shp = self._shape(x[0])
        out = n.outs[0]
        if n.name == "index":
            idxs = list(n.args[1])
            lane_vals = None
            for a, iv in enumerate(idxs):
                if not isinstance(iv, Ref):
                    continue
                if self._dtype(iv.vid) == torch.bool:
                    continue
                self._check_index(env, n, iv.vid, shp[a], f"index axis {a}")
                if self.tagger is not None and self.tagger._tag(x[0]) == a \
                        and x[1].lanes is not None:
                    lane_vals = self._index_cols(env, iv.vid)
            if lane_vals is not None:
                lo, hi = max(0, int(lane_vals[0])), \
                    min(self.L - 1, int(lane_vals[1]))
                return [self._lane_pick(env, n, x, range(lo, hi + 1))]
            return [self._mk(out, x[1].whole(),
                             self._lanes_of(n, x[0], x[1]))]
        # gather(self, dim, index) / index_select(self, dim, index)
        d = _norm_dim(n.args[1], len(shp))
        idx = n.args[2]
        self._check_index(env, n, idx.vid, shp[d], f"{n.name} axis {d}")
        if self.tagger is not None and self.tagger._tag(x[0]) == d \
                and x[1].lanes is not None:
            cols = self._index_cols(env, idx.vid)
            if cols is not None:
                lo, hi = max(0, int(cols[0])), min(self.L - 1, int(cols[1]))
                return [self._lane_pick(env, n, x, range(lo, hi + 1))]
        ln = self._lanes_of(n, x[0], x[1])
        if ln is not None and self._lane_axis(out) is not None:
            return [Val(None, ln)]
        return [self._mk(out, x[1].whole())]

    def _race(self, n: TNode, why: str, rows: int):
        if self.record:
            self.race_sites.append({"prim": n.name, "phase": self._phase(n),
                                    "why": why, "rows": rows})

    def _scatter_race(self, env, n: TNode, d: int, idx_vid: int):
        """ABS702 for ``scatter`` along ``d``: the index entries of one
        fiber (all other coordinates fixed) must be distinct. Single row
        per fiber, then constant rows checked exactly, then the
        pigeonhole on the reachable index values, else reported."""
        ishape = self._shape(idx_vid)
        rows = int(ishape[d]) if ishape else 1
        if rows <= 1:
            return
        arr = self.consts.get(idx_vid)
        if arr is not None:
            fib = np.moveaxis(np.broadcast_to(arr, ishape), d, -1)
            fib = fib.reshape(-1, rows)
            if any(len(set(r.tolist())) < rows for r in fib):
                self._race(n, "constant index rows contain duplicates",
                           rows)
            return
        iw = self._get(env, idx_vid).whole()
        size = self._shape(n.args[0].vid)[d]
        if iw is not None:
            lo, hi = max(int(iw[0]), 0), min(int(iw[1]), size - 1)
            card = max(0, hi - lo + 1)
            if card < rows:
                self._race(n, f"pigeonhole: {rows} update rows over "
                              f"{card} reachable index tuples", rows)
                return
        self._race(n, "index rows unresolvable — aliasing cannot be "
                      "ruled out", rows)

    def _scatter(self, env, n: TNode) -> List[Val]:
        name = n.name
        out = n.outs[0]
        if self.record:
            ph = self._phase(n)
            self.scatter_census[ph] = self.scatter_census.get(ph, 0) + 1
        if name in ("index_put", "masked_scatter"):
            return self._index_put(env, n)
        x = self._opnd(env, n, 0, "self")
        shp = self._shape(x[0])
        d = _norm_dim(n.args[1], len(shp))
        idx = n.args[2]
        if name == "index_copy":
            src = self._opnd(env, n, 3, "source")
        elif name in ("scatter", "scatter_add", "scatter_reduce",
                      "index_add", "index_reduce"):
            src = self._opnd(env, n, 3, "src")
            if src[0] is None and name == "scatter":
                src = self._opnd(env, n, 3, "value")
        reduce = n.kwargs.get("reduce", n.args[4] if name in
                              ("scatter_reduce", "index_reduce")
                              and len(n.args) > 4 else None)
        if name == "scatter" and len(n.args) > 4:
            reduce = n.args[4]
        accumulate = name in ("scatter_add", "index_add") or \
            reduce is not None
        if accumulate:
            commut = (reduce is None or reduce in _COMMUTATIVE_REDUCES) \
                and not self._dtype(out).is_floating_point
            if not commut:
                self._scatter_race(env, n, d, idx.vid)
        elif name == "index_copy":
            self._index_copy_race(env, n, idx.vid)
        else:
            self._scatter_race(env, n, d, idx.vid)
        self._check_index(env, n, idx.vid, shp[d], f"{name} axis {d}")
        ow, uw = x[1].whole(), src[1].whole()
        if name in ("scatter_add", "index_add") or \
                reduce in ("sum", "add"):
            if ow is None or uw is None:
                return [self._top(out)]
            ishape = self._shape(idx.vid)
            rows = int(ishape[d]) if name != "index_add" and ishape else \
                int(np.prod(ishape) or 1)
            lo = ow[0] + rows * min(0, uw[0])
            hi = ow[1] + rows * max(0, uw[1])
            lo, hi = self._check_ovf(n, lo, hi, [ow, uw])
            return [self._mk(out, (lo, hi), x[1].lanes
                             if self._lane_axis(out) is not None else None)]
        if reduce in ("prod", "multiply"):
            return [self._top(out)]
        return [self._write(n, x, src, d, idx.vid)]

    def _write(self, n: TNode, x, src, d: int, idx_vid=None,
               lanes_hit=None) -> Val:
        """A weak update of ``x`` by ``src``: the written lanes join the
        update (all lanes when the write is not along the lane axis)."""
        out = n.outs[0]
        xv, sv = x[1], src[1]
        if xv.lanes is None or self._lane_axis(out) is None:
            return self._mk(out, _itv_join_many([xv.whole(), sv.whole()]))
        if self.tagger._tag(x[0]) == d:
            if lanes_hit is None and idx_vid is not None:
                cols = self._index_cols({}, idx_vid) \
                    if idx_vid in self.consts else None
                cols = None if cols is None else (int(cols[0]),
                                                  int(cols[1]))
                if cols is not None:
                    lanes_hit = range(max(0, cols[0]),
                                      min(self.L - 1, cols[1]) + 1)
            written = set(lanes_hit) if lanes_hit is not None \
                else set(range(self.L))
            upd = sv.whole()
            return Val(None, tuple(_itv_join(cur, upd) if i in written
                                   else cur
                                   for i, cur in enumerate(xv.lanes)))
        ln = self._lanes_of(n, src[0], sv) if src[0] is not None else None
        upd = ln or (sv.whole(),) * self.L
        return Val(None, tuple(_itv_join(cur, u) if cur is not None
                               and u is not None else None
                               for cur, u in zip(xv.lanes, upd)))

    def _index_copy_race(self, env, n: TNode, idx_vid: int):
        rows = int(np.prod(self._shape(idx_vid)) or 1)
        if rows <= 1:
            return
        arr = self.consts.get(idx_vid)
        if arr is not None:
            if len(set(np.asarray(arr).reshape(-1).tolist())) < rows:
                self._race(n, "constant index rows contain duplicates",
                           rows)
            return
        self._race(n, "index rows unresolvable — aliasing cannot be "
                      "ruled out", rows)

    def _index_put(self, env, n: TNode) -> List[Val]:
        out = n.outs[0]
        x = self._opnd(env, n, 0, "self")
        if n.name == "masked_scatter":
            # each masked element takes one source element: no aliasing
            src = self._opnd(env, n, 2, "source")
            return [self._mk(out, _itv_join_many([x[1].whole(),
                                                  src[1].whole()]))]
        idxs = [iv for iv in n.args[1] if isinstance(iv, Ref)]
        src = self._opnd(env, n, 2, "values")
        accumulate = bool(_arg(n, 3, "accumulate", False))
        int_idx = [iv.vid for iv in idxs
                   if self._dtype(iv.vid) != torch.bool]
        shp = self._shape(x[0])
        for a, iv in enumerate(n.args[1]):
            if isinstance(iv, Ref) and iv.vid in int_idx:
                self._check_index(env, n, iv.vid, shp[a],
                                  f"index_put axis {a}")
        if int_idx and (not accumulate
                        or self._dtype(out).is_floating_point):
            shapes = [self._shape(v) for v in int_idx]
            rows = int(np.prod(np.broadcast_shapes(*shapes)) or 1)
            if rows > 1:
                arrs = [self.consts.get(v) for v in int_idx]
                if all(a is not None for a in arrs):
                    b = np.broadcast_arrays(*arrs)
                    tup = set(zip(*(a.reshape(-1).tolist() for a in b)))
                    if len(tup) < rows:
                        self._race(n, "constant index rows contain "
                                      "duplicates", rows)
                else:
                    card = 1
                    for a, iv in enumerate(n.args[1]):
                        if isinstance(iv, Ref) and iv.vid in int_idx:
                            w = self._get(env, iv.vid).whole()
                            if w is None:
                                card = None
                                break
                            lo, hi = max(0, int(w[0])), \
                                min(int(w[1]), shp[a] - 1)
                            card *= max(0, hi - lo + 1)
                    if card is not None and card < rows:
                        self._race(n, f"pigeonhole: {rows} update rows "
                                      f"over {card} reachable index "
                                      f"tuples", rows)
                    else:
                        self._race(n, "index rows unresolvable — "
                                      "aliasing cannot be ruled out", rows)
        ow, uw = x[1].whole(), src[1].whole()
        if accumulate:
            if ow is None or uw is None:
                return [self._top(out)]
            rows = int(np.prod(np.broadcast_shapes(
                *[self._shape(v) for v in int_idx])) or 1) if int_idx \
                else 1
            lo = ow[0] + rows * min(0, uw[0])
            hi = ow[1] + rows * max(0, uw[1])
            return [self._mk(out, self._check_ovf(n, lo, hi, [ow, uw]))]
        return [self._mk(out, _itv_join_many([ow, uw]))]

    def _select_scatter(self, env, n: TNode) -> List[Val]:
        x = self._opnd(env, n, 0, "self")
        src = self._opnd(env, n, 1, "src")
        shp = self._shape(x[0])
        d = _norm_dim(n.args[2], len(shp))
        hit = None
        if self.tagger is not None and self.tagger._tag(x[0]) == d:
            idx = self._scalar(n, 3, n.args[3]).whole()
            if idx is not None:
                lo, hi = idx
                if lo == hi and lo < 0:
                    lo = hi = lo + shp[d]
                hit = range(max(0, int(lo)), min(self.L - 1, int(hi)) + 1)
            return [self._write(n, x, src, d, lanes_hit=hit)]
        return [self._write(n, x, src, d)]

    def _slice_scatter(self, env, n: TNode) -> List[Val]:
        x = self._opnd(env, n, 0, "self")
        src = self._opnd(env, n, 1, "src")
        shp = self._shape(x[0])
        a = n.args
        d = _norm_dim(a[2] if len(a) > 2 else n.kwargs.get("dim", 0),
                      len(shp))
        if self.tagger is not None and self.tagger._tag(x[0]) == d:
            size = shp[d]
            start = a[3] if len(a) > 3 and a[3] is not None else 0
            end = a[4] if len(a) > 4 and a[4] is not None else size
            step = a[5] if len(a) > 5 else 1
            start = max(0, min(start + size if start < 0 else start, size))
            end = max(0, min(end + size if end < 0 else end, size))
            hit = list(range(start, end, step))
            sv = src[1]
            if sv.lanes is not None and len(sv.lanes) == len(hit) \
                    and x[1].lanes is not None:
                lanes = list(x[1].lanes)
                for k, lane in enumerate(hit):
                    if lane < self.L:
                        lanes[lane] = _itv_join(lanes[lane], sv.lanes[k])
                return [Val(None, tuple(lanes))]
            return [self._write(n, x, src, d, lanes_hit=hit)]
        return [self._write(n, x, src, d)]

    def _masked_fill(self, env, n: TNode) -> List[Val]:
        x = self._opnd(env, n, 0, "self")
        val = self._opnd(env, n, 2, "value")
        return [self._write(n, x, val, -1)]


def _handlers() -> Dict[str, Callable]:
    I = _Interp
    h: Dict[str, Callable] = {}
    for name in ("add", "sub", "rsub", "mul", "div", "floor_divide",
                 "remainder", "fmod", "maximum", "minimum"):
        h[name] = I._binop
    for name in ("neg", "abs", "sign", "bitwise_not", "exp", "log", "sqrt",
                 "floor", "ceil", "round", "trunc"):
        h[name] = I._unop
    for name in ("eq", "ne", "lt", "le", "gt", "ge", "isnan", "isinf",
                 "isfinite", "logical_and", "logical_or", "logical_not",
                 "logical_xor"):
        h[name] = I._compare
    for name in ("bitwise_and", "bitwise_or", "bitwise_xor"):
        h[name] = I._bitwise
    for name in ("__lshift__", "__rshift__", "bitwise_left_shift",
                 "bitwise_right_shift"):
        h[name] = I._shift
    h["pow"] = I._pow
    h["where"] = I._where
    for name in ("clamp", "clamp_min", "clamp_max"):
        h[name] = I._clamp
    h["_to_copy"] = I._convert
    h["copy"] = I._convert
    for name in ("clone", "alias", "detach", "lift_fresh",
                 "lift_fresh_copy", "_unsafe_view", "reshape", "expand",
                 "unsqueeze", "squeeze", "permute", "transpose", "t",
                 "repeat", "contiguous", "flip", "roll"):
        h[name] = I._pass
    h["view"] = lambda self, env, n: (
        self._bitcast(env, n) if len(n.args) > 1 and
        isinstance(n.args[1], torch.dtype) else self._pass(env, n))
    h["select"] = I._select
    h["slice"] = I._slice
    h["cat"] = I._cat
    h["stack"] = I._cat
    h["constant_pad_nd"] = I._pad
    h["unbind"] = I._unbind
    for name in ("zeros", "ones", "full", "arange", "eye", "scalar_tensor",
                 "zeros_like", "ones_like", "full_like", "new_zeros",
                 "new_ones", "new_full", "empty", "empty_like",
                 "empty_strided", "new_empty"):
        h[name] = I._create
    for name in ("sum", "mean", "any", "all", "amax", "amin", "max", "min",
                 "argmax", "argmin", "prod"):
        h[name] = I._reduce
    h["sort"] = I._sort
    h["topk"] = I._sort
    h["cumsum"] = I._cumsum
    for name in ("gather", "index_select", "index"):
        h[name] = I._gather
    for name in _SCATTERS:
        h[name] = I._scatter
    h["select_scatter"] = I._select_scatter
    h["slice_scatter"] = I._slice_scatter
    h["masked_fill"] = I._masked_fill
    h["nextafter"] = lambda self, env, n: [Val(None)]
    h["searchsorted"] = I._searchsorted
    h["bucketize"] = I._searchsorted
    return h


# aten packet name -> transfer function
_HANDLERS = _handlers()


# --- the shared loop widener (JAX's, unchanged) -----------------------------


def _loop_fixpoint(apply, seed_vals: List[Val], length: int,
                   pad: bool = False, iters: int = 5
                   ) -> Tuple[List[Val], List[int], List[Val], List[Any]]:
    """Iterate ``apply`` (one abstract tick) joining into the carry; on
    non-convergence, extrapolate each element's per-tick growth affinely
    by ``length`` and re-verify the growth bound at the widened state.
    Returns (final carry, indices of leaves whose growth could not be
    bounded, the pre-extrapolation base, the verified rates, the final
    carry before the padding): the caller re-extrapolates the same proof
    to a smaller horizon."""
    hist = [list(seed_vals)]
    cur = list(seed_vals)
    stable = False
    # enough join iterations for coupled rates to reach steady state
    for _ in range(iters):
        outs = apply(cur, False)
        new = [_val_join(c, o) for c, o in zip(cur, outs)]
        if all(_val_eq(a, b) for a, b in zip(new, cur)):
            stable = True
            break
        hist.append(new)
        cur = new
    if stable:
        return cur, [], cur, [None] * len(cur), cur
    g_prev = [_growth(a, b) for a, b in zip(hist[-3], hist[-2])]
    g_fin = [_growth(a, b) for a, b in zip(hist[-2], hist[-1])]
    if len(hist) >= 4:
        g_old = [_growth(a, b) for a, b in zip(hist[-4], hist[-3])]
        g_prev = [_growth_max(a, b) for a, b in zip(g_old, g_prev)]
    # extrapolate with the larger of the last two growth rates, then
    # verify; the repair loop raises a failing leaf's rate to the growth
    # observed at the horizon state (coupled counters settle on a
    # common rate), climbs thresholds for accelerating leaves, and
    # widens a genuinely super-linear recurrence to dtype-full
    g_cur = [_growth_max(a, b) for a, b in zip(g_prev, g_fin)]
    unstable: List[int] = []
    threshold_mode: Set[int] = set()
    widened = []
    for i, (v, gp, gf) in enumerate(zip(cur, g_prev, g_fin)):
        if _growth_accel(gp, gf):
            threshold_mode.add(i)
            widened.append(_mixed_init(v, gp, gf, g_cur[i], length))
        else:
            widened.append(_extrapolate(v, g_cur[i], length))
    for rnd in range(24):
        outs = apply(widened, False)
        ok = True
        for i, (w, o) in enumerate(zip(widened, outs)):
            if i in unstable or _growth_within(w, o, g_cur[i]):
                continue
            ok = False
            if _step_saturated(o):
                if rnd < 2 and i not in threshold_mode:
                    threshold_mode.add(i)
                    widened[i] = _threshold_widen(cur[i])
                else:
                    widened[i] = _overflowed_like(w)
                continue
            step = _step_size(w, o)
            if i in threshold_mode:
                if step <= 256:
                    threshold_mode.discard(i)
                    g_cur[i] = _growth(w, o)
                    widened[i] = _extrapolate(_val_join(w, o), g_cur[i],
                                              length)
                else:
                    widened[i] = _threshold_sel(w, o, g_cur[i])
            elif rnd < 3:
                widened[i] = _val_join(w, o)
            else:
                g_cur[i] = _growth_max(_growth(w, o), _growth(w, o))
                widened[i] = _extrapolate(_val_join(w, o), g_cur[i],
                                          length)
        if ok:
            break
    else:
        outs = apply(widened, False)
        for i, (w, o, g) in enumerate(zip(widened, outs, g_cur)):
            if i not in unstable and not _growth_within(w, o, g):
                widened[i] = Val(None)
                unstable.append(i)
    # pay the verification slack into the claimed bounds
    raw = list(widened)
    if pad:
        for i in range(len(widened)):
            if i not in unstable:
                widened[i] = _pad(widened[i], g_cur[i])
    return widened, sorted(unstable), cur, g_cur, raw


def _growth(a: Val, b: Val):
    """Per-element (hi-growth, lo-growth) from one iteration — per-lane
    vectors when both sides carry lanes."""
    def one(x: Optional[Itv], y: Optional[Itv]):
        if x is None or y is None:
            return None
        return (max(0, y[1] - x[1]), max(0, x[0] - y[0]))
    if a.lanes is not None and b.lanes is not None \
            and len(a.lanes) == len(b.lanes):
        return [one(x, y) for x, y in zip(a.lanes, b.lanes)]
    return one(a.whole(), b.whole())


def _growth_max(gp, gl):
    def one(p, q):
        if p is None or q is None:
            return None
        return (max(p[0], q[0]), max(p[1], q[1]))
    if isinstance(gl, list) or isinstance(gp, list):
        n = len(gl) if isinstance(gl, list) else len(gp)
        gp = gp if isinstance(gp, list) else [gp] * n
        gl = gl if isinstance(gl, list) else [gl] * n
        return [one(p, q) for p, q in zip(gp, gl)]
    return one(gp, gl)


def _extrapolate(v: Val, g, n: int) -> Val:
    def one(i: Optional[Itv], gi) -> Optional[Itv]:
        if i is None:
            return None
        if gi is None or gi == (0, 0):
            return i
        return (i[0] - gi[1] * n, i[1] + gi[0] * n)
    if v.lanes is not None and isinstance(g, list) \
            and len(g) == len(v.lanes):
        return Val(None, tuple(one(i, gi) for i, gi in zip(v.lanes, g)))
    return Val(one(v.whole(), g if not isinstance(g, list) else None))


def _growth_accel(gp, gl) -> bool:
    """True when the later growth materially exceeds the earlier one."""
    def one(p, q):
        if q is None:
            return False
        if p is None:
            return max(q) > 256
        return q[0] > 1.5 * p[0] + 256 or q[1] > 1.5 * p[1] + 256
    if isinstance(gl, list) or isinstance(gp, list):
        n = len(gl) if isinstance(gl, list) else len(gp)
        gp = gp if isinstance(gp, list) else [gp] * n
        gl = gl if isinstance(gl, list) else [gl] * n
        return any(one(p, q) for p, q in zip(gp, gl))
    return one(gp, gl)


def _step_size(w: Val, o: Val) -> float:
    g = _growth(w, o)
    if isinstance(g, list):
        return max((max(gi) for gi in g if gi is not None), default=0)
    return max(g) if g is not None else 0


def _threshold_sel(w: Val, o: Val, g) -> Val:
    """Lanes within the slack keep their join; failing lanes jump to the
    next power-of-two threshold past the observed output."""
    def one(wi: Optional[Itv], oi: Optional[Itv], gi) -> Optional[Itv]:
        if wi is None or oi is None:
            return _itv_join(wi, oi)
        sh, sl = _slack(gi)
        if oi[1] <= wi[1] + sh and oi[0] >= wi[0] - sl:
            return _itv_join(wi, oi)
        return _threshold_itv(_itv_join(wi, oi))
    if w.lanes is not None and o.lanes is not None \
            and len(w.lanes) == len(o.lanes):
        gl = g if isinstance(g, list) else [g] * len(w.lanes)
        return Val(None, tuple(one(wi, oi, gi) for wi, oi, gi in
                               zip(w.lanes, o.lanes, gl)))
    return _threshold_widen(_val_join(w, o))


def _mixed_init(v: Val, gp, gf, g, length: int) -> Val:
    if v.lanes is None or not isinstance(gf, list):
        return _threshold_widen(v)
    gpl = gp if isinstance(gp, list) else [gp] * len(v.lanes)
    gcl = g if isinstance(g, list) else [g] * len(v.lanes)
    lanes = []
    for vi, gpi, gfi, gci in zip(v.lanes, gpl, gf, gcl):
        if _growth_accel(gpi, gfi):
            lanes.append(_threshold_itv(vi))
        else:
            lanes.append(_extrapolate(Val(vi), gci, length).whole())
    return Val(None, tuple(lanes))


def _threshold_itv(i: Optional[Itv]) -> Optional[Itv]:
    if i is None:
        return None
    hi = int(max(i[1], 1))
    lo = int(min(i[0], 0))
    return (-(1 << abs(lo).bit_length()) if lo < 0 else lo,
            1 << hi.bit_length())


def _threshold_widen(v: Val) -> Val:
    if v.lanes is not None:
        return Val(None, tuple(_threshold_itv(i) for i in v.lanes))
    return Val(_threshold_itv(v.whole()))


def _overflowed_like(w: Val) -> Val:
    over = (INT32_MIN - 1, INT32_MAX + 1)
    if w.lanes is not None:
        return Val(None, (over,) * len(w.lanes))
    return Val(over)


def _step_saturated(o: Val) -> bool:
    def one(i: Optional[Itv]) -> bool:
        return i is not None and (i[1] >= INT32_MAX or i[0] <= INT32_MIN)
    if o.lanes is not None:
        return any(one(i) for i in o.lanes)
    return one(o.whole())


# verification slack (JAX's): a bounded number of growth steps plus an
# absolute floor, charged back into the final bounds by _pad
_SLACK_MUL = 32
_SLACK_ABS = 16


def _slack(gi) -> Tuple[int, int]:
    gh, glo = gi if gi is not None else (0, 0)
    return (max(_SLACK_MUL * gh, _SLACK_ABS),
            max(_SLACK_MUL * glo, _SLACK_ABS))


def _growth_within(w: Val, o: Val, g) -> bool:
    def one(wi: Optional[Itv], oi: Optional[Itv], gi) -> bool:
        if wi is None:
            return True
        if oi is None:
            return False
        sh, sl = _slack(gi)
        return oi[1] <= wi[1] + sh and oi[0] >= wi[0] - sl
    if w.lanes is not None and o.lanes is not None \
            and isinstance(g, list) and len(g) == len(w.lanes):
        return all(one(wi, oi, gi)
                   for wi, oi, gi in zip(w.lanes, o.lanes, g))
    return one(w.whole(), o.whole(), g if not isinstance(g, list) else None)


def _pad(v: Val, g) -> Val:
    """Charge the verification slack into a bound, saturating at the
    int32 rails (a leaf at the rail is TOP, not an overflow)."""
    def one(i: Optional[Itv], gi) -> Optional[Itv]:
        if i is None:
            return None
        sh, sl = _slack(gi)
        lo, hi = i[0] - sl, i[1] + sh
        if i[1] <= INT32_MAX:
            hi = min(hi, INT32_MAX)
        if i[0] >= INT32_MIN:
            lo = max(lo, INT32_MIN)
        return (lo, hi)
    if v.lanes is not None and isinstance(g, list) \
            and len(g) == len(v.lanes):
        return Val(None, tuple(one(i, gi) for i, gi in zip(v.lanes, g)))
    return Val(one(v.whole(), g if not isinstance(g, list) else None))


# --- per-model analysis ----------------------------------------------------


@dataclass
class RangeReport:
    """Value-range result for ONE model."""
    label: str
    probe_log2: int                     # largest horizon probed
    horizon_log2: int = PRODUCTION_LOG2  # horizon ABS701 gates on
    proven: bool = True                 # no unbounded leaves / notes
    max_safe_horizon_log2: int = 0      # largest 2^k with a clean walk
    min_overflow_t: Optional[int] = None
    overflow_sites: List[Dict[str, Any]] = field(default_factory=list)
    oob_sites: List[Dict[str, Any]] = field(default_factory=list)
    race_sites: List[Dict[str, Any]] = field(default_factory=list)
    scatter_census: Dict[str, int] = field(default_factory=dict)
    unproven_leaves: List[str] = field(default_factory=list)
    counters: Dict[str, int] = field(default_factory=dict)
    flake: Optional[Dict[str, int]] = None
    notes: List[str] = field(default_factory=list)

    @property
    def ovf_margin_bits(self) -> int:
        """Minimum proven counter headroom: bits to int32 max at
        ``min(2^20, 2^max_safe)``. 0 = unproven. The bench metric."""
        if not self.proven:
            return 0
        return min(self.counters.values(), default=31)

    @property
    def race_status(self) -> str:
        if self.race_sites:
            return "racing"
        return "race-free" if self.proven else "unproven"

    @property
    def netsim_scatters(self) -> int:
        return sum(n for ph, n in self.scatter_census.items()
                   if ph in ("deliver", "enqueue"))

    def to_entry(self) -> Dict[str, Any]:
        """The checked-in manifest representation."""
        entry = {
            "proven": self.proven,
            "max_safe_horizon_log2": self.max_safe_horizon_log2,
            "min_overflow_t": self.min_overflow_t,
            "scatter_race": self.race_status,
            "netsim_scatters": self.netsim_scatters,
            "ovf_margin_bits": self.ovf_margin_bits,
            "counters": {k: self.counters[k] for k in sorted(self.counters)},
        }
        if self.flake is not None:
            entry["flake"] = self.flake
        if self.unproven_leaves:
            entry["unproven_leaves"] = sorted(self.unproven_leaves)
        return entry


class TickRanges:
    """The abstract tick of one model under one sim: the variants'
    interpreters, the carry's paths and dtypes, its abstract init, and
    the fixed point at a horizon (:meth:`fixpoint`)."""

    def __init__(self, model, sim, graphs: Dict[str, TickGraph],
                 init: TickGraph):
        from .lane_liveness import tagger_of
        self.L = sim.net.lanes
        self.graphs = graphs
        g0 = next(iter(graphs.values()))
        self.paths = list(g0.input_paths)
        self.n = len(self.paths)
        self.dtypes = [g0.values[v].dtype for v in g0.inputs]
        self.pool_idx = self.paths.index(".pool")
        self.interps = [_Interp(g, tagger_of(g, self.L, sim.layout), self.L)
                        for g in graphs.values()]
        init_i = _Interp(init, None, self.L)
        outs = init_i.run([])
        self.init_notes = init_i.notes
        vals = [Val(v.whole()) for v in outs[:self.n]]
        vals[self.pool_idx] = Val(None, ((0, 0),) * self.L)
        for it in self.interps:
            if it._lane_axis(it.g.inputs[self.pool_idx]) is None:
                vals[self.pool_idx] = Val((0, 0))
        self.init_vals = vals

    @property
    def notes(self) -> List[str]:
        out = list(self.init_notes)
        for it in self.interps:
            out += [m for m in it.notes if m not in out]
        return out

    def apply(self, carry_vals: Sequence[Val], rec: bool) -> List[Val]:
        """One abstract tick: the join over the tick variants."""
        out: Optional[List[Val]] = None
        for it in self.interps:
            it.record = rec
            outs = it.run(self._inputs_for(it, carry_vals))[:self.n]
            it.record = False
            out = outs if out is None else [_val_join(a, b)
                                            for a, b in zip(out, outs)]
        return out

    def _inputs_for(self, it: _Interp, carry_vals):
        vals = list(carry_vals)
        p = vals[self.pool_idx]
        if it._lane_axis(it.g.inputs[self.pool_idx]) is None \
                and p.lanes is not None:
            vals[self.pool_idx] = Val(p.whole())
        return vals

    def set_horizon(self, T: int):
        for it in self.interps:
            it.t = (0, T - 1)

    def fixpoint(self, T: int):
        self.set_horizon(T)
        return _loop_fixpoint(self.apply, list(self.init_vals), T,
                              pad=True, iters=8)

    def probe_walk(self, final, T: int):
        self.set_horizon(T)
        for it in self.interps:
            it.overflow_sites, it.oob_sites, it.race_sites = [], [], []
            it.scatter_census = {}
            it.excess = -float("inf")
        self.apply(final, True)
        self.excess = max(it.excess for it in self.interps)
        over, oob, races, census = [], [], [], {}
        for it in self.interps:
            over += it.overflow_sites
            oob += [s for s in it.oob_sites if s not in oob]
            races += [s for s in it.race_sites if s not in races]
            for ph, c in it.scatter_census.items():
                census[ph] = max(census.get(ph, 0), c)
        return over, oob, races, census

    def excess_of(self, raw, unstable) -> float:
        """How far past int32 the last probe walk's nearest site, or a
        carry leaf before its padding, reaches (negative: inside)."""
        excess = self.excess
        for i, v in enumerate(raw):
            w = v.whole()
            # a leaf at dtype-full (a bitmask on the sign bit) never
            # overflows: it would pin the excess at 0
            if i not in unstable and w is not None \
                    and self.dtypes[i] == torch.int32 \
                    and w != (INT32_MIN, INT32_MAX):
                excess = max(excess, w[1] - INT32_MAX, INT32_MIN - w[0])
        return excess

    def crossing(self, raw, unstable, rates, T: int) -> Optional[int]:
        """Where the leaves that overflow at horizon ``T`` start to: each
        leaf (or lane) past int32 in ``raw`` moves by its verified rate a
        tick, so it first escapes at ``floor(T - excess / rate) + 1``; the
        least of those. None when the last walk's sites overflow too, or
        a leaf past int32 does not move (no line to follow)."""
        if self.excess > 0:
            return None
        best = None
        for i, (v, g) in enumerate(zip(raw, rates)):
            if i in unstable or self.dtypes[i] != torch.int32:
                continue
            itvs = v.lanes if v.lanes is not None else (v.whole(),)
            gs = g if isinstance(g, list) else [g] * len(itvs)
            for w, gi in zip(itvs, gs):
                if w is None:
                    continue
                gh, gl = gi if gi is not None else (0, 0)
                for e, rate in ((w[1] - INT32_MAX, gh),
                                (INT32_MIN - w[0], gl)):
                    if e <= 0:
                        continue
                    if rate <= 0:
                        return None
                    t = math.floor(T - e / rate) + 1
                    best = t if best is None else min(best, t)
        return best

    def leaf_overflow(self, final, unstable) -> List[Tuple[str, Itv]]:
        out = []
        for i, v in enumerate(final):
            if i in unstable:
                continue
            w = v.whole()
            if w is not None and self.dtypes[i] == torch.int32 and \
                    (w[0] < INT32_MIN or w[1] > INT32_MAX):
                out.append((self.paths[i], w))
        return out


def _model_name(model) -> str:
    return getattr(model, "name", type(model).__name__)


def tick_ranges(model, sim, trace_cache=None) -> TickRanges:
    """The abstract tick of ``model`` under ``sim``: the recorded tick
    variants (shared through ``trace_cache`` with the other passes) and
    the init graph."""
    graphs = cost_model.trace_variants(model, sim, cache=trace_cache)
    key = None
    if trace_cache is not None:
        key = cost_model.entry_key(_model_name(model), sim.net.n_nodes,
                                   sim.layout) + "::init"
    init = trace_cache.get(key) if key is not None else None
    if init is None:
        init = cost_model.record_init(model, sim)
        if key is not None:
            trace_cache[key] = init
    return TickRanges(model, sim, graphs, init)


def analyze_model(model, node_count: int, layout: str = "lead",
                  label: Optional[str] = None, sim=None,
                  trace_cache=None,
                  probe_log2: Optional[int] = None) -> RangeReport:
    """Run the interval analysis for one model. ``sim`` overrides the
    shared audit config (the bench and ``chip_smoke.py`` pass their
    own); ``trace_cache`` holds one sim's graphs, shared with the other
    passes; ``probe_log2`` raises or lowers the largest horizon probed
    (2^31 plants the synthetic overflow budget every cumulative counter
    trips). A given ``sim`` brings its own layout."""
    if sim is None:
        sim = cost_model.audit_sim(model, node_count, layout)
    label = label or f"{_model_name(model)}/{sim.layout}"
    tr = tick_ranges(model, sim, trace_cache=trace_cache)
    probe = PROBE_LOG2 if probe_log2 is None else int(probe_log2)

    # one fixed point at the probe horizon; its growth rates bound
    # every smaller horizon (monotone transfer)
    final, unstable, base, rates, raw = tr.fixpoint(1 << probe)
    leaf_over = tr.leaf_overflow(final, unstable)
    over, oob, races, census = tr.probe_walk(final, 1 << probe)
    # oob and races are horizon-independent verdicts; only overflow
    # drives the horizon search
    clean = not (over or leaf_over)
    seen: Dict[int, Tuple[bool, float]] = {
        1 << probe: (not clean, tr.excess_of(raw, unstable))}

    report = RangeReport(label=label, probe_log2=probe,
                         horizon_log2=(PRODUCTION_LOG2 if probe_log2 is None
                                       else probe))
    report.scatter_census = census
    report.race_sites = races
    report.oob_sites = oob
    report.notes = tr.notes
    report.unproven_leaves = [tr.paths[i] for i in unstable]
    report.proven = not unstable and not report.notes

    def dirty(T: int) -> bool:
        """Whether the walk at horizon T overflows; also keeps its
        excess (how far past int32 the nearest site or leaf reaches)."""
        if T not in seen:
            f, uns, _, _, r = tr.fixpoint(T)
            o = tr.probe_walk(f, T)[0]
            seen[T] = (bool(o or tr.leaf_overflow(f, uns)),
                       tr.excess_of(r, uns))
        return seen[T][0]

    if clean:
        report.max_safe_horizon_log2 = probe
    else:
        # JAX bisects for the largest clean power-of-two horizon, then
        # for the minimal overflowing T above it: both are read off the
        # one boundary between clean and dirty horizons
        b = tr.crossing(raw, unstable, rates, 1 << probe)
        if not (b is not None and 1 <= b <= 1 << probe and dirty(b)
                and (b == 1 or not dirty(b - 1))):
            b = _overflow_boundary(dirty, seen, probe)
        report.max_safe_horizon_log2 = max(0, (b - 1).bit_length() - 1)
        report.min_overflow_t = b
        report.overflow_sites = over + [
            {"kind": "leaf", "leaf": p, "lo": int(w[0]), "hi": int(w[1])}
            for p, w in leaf_over]

    # per-counter headroom at the production horizon: the probe fixed
    # point's verified base and rates re-extrapolated (the same proof)
    t_prod = 1 << min(PRODUCTION_LOG2, report.max_safe_horizon_log2)
    f_prod = [v if g is None else _pad(_extrapolate(v, g, t_prod), g)
              for v, g in zip(base, rates)]
    for i, (v0, vT) in enumerate(zip(tr.init_vals, f_prod)):
        if i in unstable or tr.dtypes[i] != torch.int32:
            continue
        w0, wT = v0.whole(), vT.whole()
        if w0 is None or wT is None:
            continue
        if wT[1] >= INT32_MAX or wT[0] <= INT32_MIN:
            # rails-saturated = TOP by design (a bitmask on the sign
            # bit): no headroom claim
            continue
        if wT[1] > w0[1] or wT[0] < w0[0]:     # a counter: it moved
            m = max(abs(int(wT[0])), abs(int(wT[1])), 1)
            report.counters[tr.paths[i]] = max(0, 31 - m.bit_length())
    # the declared flake-id split: the node-state counter's proven
    # ceiling against the field width
    bits = getattr(model, "flake_counter_bits", None)
    if bits is not None:
        peak = 0
        for i, p in enumerate(tr.paths):
            if p.startswith(".node_state") and i not in unstable:
                w = f_prod[i].whole()
                if w is not None:
                    peak = max(peak, int(w[1]))
        report.flake = {"bits": int(bits), "proven_counter_max": int(peak),
                        "fits": bool(peak < (1 << bits))}
        if not report.flake["fits"]:
            report.overflow_sites.append({
                "kind": "flake", "leaf": ".node_state", "hi": int(peak),
                "bits": int(bits)})
    return report


def _overflow_boundary(dirty, seen, probe: int) -> int:
    """The minimal overflowing horizon in ``[1, 2^probe]`` (``2^probe``
    dirty; dirtiness is monotone in T, as JAX's bisections assume). The
    first probe is the production horizon; then each probe sits where
    the excess (linear in T for the additive counters) reaches zero on
    the line through the last two horizons probed, and a second such
    step in a row also probes its neighbour below, so a linear excess
    closes the bracket in a few fixed points; bisection takes over
    where two steps do not halve the bracket."""
    lo, hi = 0, 1 << probe
    order = [1 << probe]
    p = min(PRODUCTION_LOG2, probe - 1)
    if p >= 0:
        order.append(1 << p)
        if dirty(1 << p):
            hi = 1 << p
        else:
            lo = 1 << p
    slow = secants = 0
    while hi - lo > 1:
        width = hi - lo
        (a, e_a), (b, e_b) = [(t, seen[t][1]) for t in order[-2:]]
        if slow < 2 and e_a != e_b and lo > 0:
            x = b - e_b * (b - a) / (e_b - e_a)
            guess = min(hi - 1, max(lo + 1, math.ceil(x)))
            secants += 1
        else:
            guess, secants = (lo + hi) // 2, 0
        order.append(guess)
        if dirty(guess):
            hi = guess
            if secants > 1 and guess - 1 > lo:
                order.append(guess - 1)
                if not dirty(guess - 1):
                    lo = guess - 1
        else:
            lo = guess
        slow = slow + 1 if hi - lo > width // 2 else 0
    return hi


def leaf_ranges(model, sim, T: int, trace_cache=None) -> Dict[str, Itv]:
    """Each int32 carry leaf's proven interval over the first ``T``
    ticks of ``sim`` (the padded fixed point at horizon ``T``; leaves
    whose growth could not be bounded are left out): what a concrete
    run of ``T`` ticks must stay inside, on the CPU or on the card."""
    tr = tick_ranges(model, sim, trace_cache=trace_cache)
    final, unstable, _, _, _ = tr.fixpoint(T)
    out = {}
    for i, v in enumerate(final):
        w = v.whole()
        if i in unstable or w is None or tr.dtypes[i] != torch.int32:
            continue
        out[tr.paths[i]] = (int(w[0]), int(w[1]))
    return out


# --- findings --------------------------------------------------------------


def _model_path(model) -> str:
    return type(model).__module__.replace(".", os.sep) + ".py"


def _finding(rule, name, severity, path, symbol, message) -> Finding:
    return Finding(rule=rule, name=name, severity=severity,
                   pass_name=PASS_NAME, path=path, line=0,
                   symbol=symbol, message=message)


def findings_of_report(model, report: RangeReport) -> List[Finding]:
    """ABS701-ABS704 from one model's range result."""
    path = _model_path(model)
    cls = type(model).__name__
    out: List[Finding] = []

    def flag(rule, name, message, severity=SEV_ERROR):
        out.append(_finding(rule, name, severity, path, cls,
                            f"[{report.label}] {message}"))

    horizon = min(report.horizon_log2, report.probe_log2)
    if report.max_safe_horizon_log2 < horizon:
        for site in report.overflow_sites[:4]:
            if site.get("kind") == "leaf":
                where = f"carry leaf {site['leaf']} reaches " \
                        f"[{site['lo']}, {site['hi']}]"
            elif site.get("kind") == "flake":
                where = f"flake counter {site['leaf']} provably " \
                        f"reaches {site['hi']} > 2^{site['bits']} " \
                        f"(the declared id-space split) — ids collide"
            else:
                where = f"'{site['prim']}' in the {site['phase']} " \
                        f"phase reaches [{site['lo']}, {site['hi']}]"
            flag("ABS701", "int32-overflow",
                 f"int32 overflow reachable within the 2^{horizon}-tick "
                 f"horizon: {where}; minimal overflowing T = "
                 f"{report.min_overflow_t} (proven safe only to "
                 f"2^{report.max_safe_horizon_log2})")
    elif report.flake is not None and not report.flake["fits"]:
        flag("ABS701", "int32-overflow",
             f"flake counter provably reaches "
             f"{report.flake['proven_counter_max']} within the "
             f"2^{horizon}-tick horizon but the declared split is "
             f"{report.flake['bits']} bits — ids from different nodes "
             f"collide; widen flake_counter_bits (and prove the fix "
             f"with --update-ranges)")
    for site in report.race_sites[:4]:
        flag("ABS702", "scatter-write-race",
             f"non-commutative scatter in the {site['phase']} phase: "
             f"{site['rows']} update rows, {site['why']} — the card "
             f"applies duplicate overwrite updates in unspecified order, "
             f"so the tick is silently nondeterministic; make the update "
             f"commutative (scatter_add/amax/amin), sequentialize the "
             f"writes, or prove the indices distinct")
    for site in report.oob_sites[:4]:
        flag("ABS703", "oob-index",
             f"provably out-of-bounds {site['what']} in the "
             f"{site['phase']} phase: index range [{site['lo']}, "
             f"{site['hi']}] vs axis size {site['axis_size']} — past a "
             f"clamp the access silently reads the wrong element, "
             f"without one it raises on the CPU and is a device assert "
             f"on the card")
    if not report.proven:
        why = report.unproven_leaves[:3] or report.notes[:2]
        flag("ABS704", "range-unresolvable",
             f"value ranges could not be fully bounded — "
             f"{'; '.join(str(w) for w in why)}; the overflow verdict "
             f"for the widened leaves is vacuous (conservative "
             f"widening, the LNE605 mirror)", SEV_WARNING)
    return out


# --- manifest io + drift gate ----------------------------------------------


def load_range_manifest(path: Optional[str] = None) -> Dict[str, Any]:
    path = path or DEFAULT_RANGE_MANIFEST
    if not os.path.exists(path):
        return {"version": 1, "entries": {}}
    with open(path) as f:
        data = json.load(f)
    data.setdefault("entries", {})
    return data


def save_range_manifest(entries: Dict[str, Dict[str, Any]],
                        path: Optional[str] = None) -> str:
    path = path or DEFAULT_RANGE_MANIFEST
    payload = {
        "version": 1,
        "_comment": (
            "Per-model proven value-range manifest for `python -m "
            "maelstrom_tpu_torch lint --ranges`. Keys: <workload>/"
            "n=<nodes>/<layout>; max_safe_horizon_log2 = largest "
            "power-of-two tick horizon with a PROVEN overflow-free "
            "abstract walk (make_sim_config refuses horizons at or past "
            "it), counters = per-carry-leaf headroom bits to int32 max "
            "at the production horizon, scatter_race = the ABS702 "
            "determinism verdict (race-free = every overwrite scatter's "
            "index rows proven distinct), netsim_scatters = scatter "
            "operators in the deliver/enqueue phases (the plain "
            "delivery's scatter_add_ of the taken slots). Regenerate "
            "after an INTENTIONAL range change with `lint --ranges "
            "--update-ranges`; drift fails the gate (ABS705). "
            "torch-version records the tracing toolchain: under another "
            "torch the gate downgrades drift to a re-record warning."),
        "torch-version": cost_model.toolchain(),
        "production_horizon_log2": PRODUCTION_LOG2,
        "entries": {k: entries[k] for k in sorted(entries)},
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")
    _MANIFEST_CACHE.clear()
    return path


def compare_manifest(live: Dict[str, RangeReport],
                     manifest: Dict[str, Any],
                     paths: Dict[str, Tuple[str, str]],
                     full_universe: bool = True,
                     errored=frozenset()) -> List[Finding]:
    """Diff live range reports against the checked-in manifest: the
    proven horizon, the scatter-race verdict and per-counter headroom."""
    entries = manifest.get("entries", {})
    note = cost_model.toolchain_note(manifest.get("torch-version"),
                                     "the range manifest", "--update-ranges")
    findings: List[Finding] = []
    for key in sorted(live):
        rep = live[key]
        path, symbol = paths[key]
        base = entries.get(key)
        if base is None:
            findings.append(_finding(
                "ABS706", "range-manifest-missing", SEV_ERROR, path, symbol,
                f"[{key}] no range-manifest entry — record one with "
                f"`python -m maelstrom_tpu_torch lint --ranges "
                f"--update-ranges`"))
            continue
        drifts = []
        for field_name, got in (
                ("proven", rep.proven),
                ("max_safe_horizon_log2", rep.max_safe_horizon_log2),
                ("scatter_race", rep.race_status),
                ("netsim_scatters", rep.netsim_scatters),
                ("ovf_margin_bits", rep.ovf_margin_bits),
                ("counters", {k: rep.counters[k]
                              for k in sorted(rep.counters)})):
            want = base.get(field_name)
            if want is not None and want != got:
                drifts.append(f"{field_name}: live {got!r} vs manifest "
                              f"{want!r}")
        if drifts:
            findings.append(_finding(
                "ABS705", "range-manifest-drift",
                SEV_WARNING if note else SEV_ERROR, path, symbol,
                f"[{key}] proven ranges drifted from the checked-in "
                f"manifest: {'; '.join(drifts)} — a counter's proven "
                f"bound moved; if intentional, re-record with "
                f"--update-ranges and justify it in the PR"
                + (f" ({note})" if note else "")))
    if full_universe:
        for key in sorted(set(entries) - set(live) - set(errored)):
            findings.append(_finding(
                "ABS707", "range-manifest-stale", SEV_WARNING,
                "maelstrom_tpu_torch/analysis/range_manifest.json", "",
                f"[{key}] manifest entry matches no registered model — "
                f"remove or re-record it"))
    return findings


# --- the make_sim_config cross-check ---------------------------------------

_MANIFEST_CACHE: Dict[str, Dict[str, Any]] = {}


def proven_horizon_log2(model_name: str,
                        manifest_path: Optional[str] = None
                        ) -> Optional[int]:
    """The model's proven overflow-free horizon (log2) from the
    checked-in manifest: the minimum across its entries, or None when it
    has no proven entry (an unproven entry caps nothing: the global
    2^20 delivery bound still applies)."""
    path = manifest_path or DEFAULT_RANGE_MANIFEST
    cached = _MANIFEST_CACHE.get(path)
    if cached is None:
        cached = load_range_manifest(path)
        _MANIFEST_CACHE[path] = cached
    best: Optional[int] = None
    for key, entry in cached.get("entries", {}).items():
        if key.split("/", 1)[0] != model_name or not entry.get("proven"):
            continue
        k = entry.get("max_safe_horizon_log2")
        if k is None:
            continue
        best = int(k) if best is None else min(best, int(k))
    return best


# --- orchestration ---------------------------------------------------------


def range_job(spec, n: int, layout: str, label: str, graphs,
              probe_log2):
    """One model's analysis in one layout, in the calling process or a
    worker: ``spec`` is ``("workload", name)`` or ``("fixture", kind)``;
    ``graphs`` its recorded graphs by ``trace_cache`` key. Returns
    ``(report, None)`` or ``(None, "Error: message")``."""
    try:
        if spec[0] == "workload":
            from ..models import get_model
            model = get_model(spec[1], n, "grid")
        else:
            from ..models.ir_hazards import RANGE_FIXTURE_MODELS
            model = RANGE_FIXTURE_MODELS[spec[1]]()
        return analyze_model(model, n, layout, label=label,
                             trace_cache=graphs,
                             probe_log2=probe_log2), None
    except Exception as e:
        return None, f"{type(e).__name__}: {e}"


def run_range_lint(repo_root: str = ".",
                   manifest_path: Optional[str] = None,
                   update_manifest: bool = False,
                   workloads: Optional[List[Tuple[str, int]]] = None,
                   layouts: Sequence[str] = cost_model.AUDIT_LAYOUTS,
                   include_fixtures: bool = True,
                   trace_cache=None,
                   probe_log2: Optional[int] = None,
                   reports: Optional[Dict[str, Tuple[Any, Optional[str]]]]
                   = None) -> List[Finding]:
    """The ranges pass: analyze every registered model (or a restricted
    list), emit ABS7xx findings, and gate against (or re-record) the
    manifest. ``reports`` holds :func:`range_job` results already in
    hand by label (the lint's static workers); those are not done
    again."""
    from ..models import get_model

    full = workloads is None
    specs = cost_model.cost_specs() if full else list(workloads)
    findings: List[Finding] = []
    live: Dict[str, RangeReport] = {}
    paths: Dict[str, Tuple[str, str]] = {}
    errored: Set[str] = set()

    # (spec, model, node count, layout, label) per analysis: the registered
    # models, then the fixtures (never gated against the manifest)
    jobs = []
    for wl, n in specs:
        try:
            model = get_model(wl, n, "grid")
        except Exception as e:
            findings.append(_finding(
                "ABS708", "range-analysis-failure", SEV_ERROR,
                "maelstrom_tpu_torch/models/__init__.py", "get_model",
                f"get_model({wl!r}, {n}) raised: {e!r}"))
            errored.update(cost_model.entry_key(wl, n, lay)
                           for lay in layouts)
            continue
        for layout in layouts:
            jobs.append((("workload", wl), model, n, layout,
                         cost_model.entry_key(wl, n, layout)))
    n_registered = len(jobs)
    if full and include_fixtures:
        from ..models.ir_hazards import RANGE_FIXTURE_MODELS
        for kind, cls in sorted(RANGE_FIXTURE_MODELS.items()):
            for layout in layouts:
                jobs.append((("fixture", kind), cls(), 2, layout,
                             f"fixture-{kind}/{layout}"))
    cache = trace_cache if trace_cache is not None else {}
    for i, (spec, model, n, layout, label) in enumerate(jobs):
        done = (reports or {}).get(label)
        rep, err = done if done is not None else range_job(
            spec, n, layout, label, cache, probe_log2)
        if err is not None:
            findings.append(_finding(
                "ABS708", "range-analysis-failure", SEV_ERROR,
                _model_path(model), type(model).__name__,
                f"[{label}] range analysis raised {err}"))
            if i < n_registered:
                errored.add(label)
            continue
        findings.extend(findings_of_report(model, rep))
        if i < n_registered:
            live[label] = rep
            paths[label] = (_model_path(model), type(model).__name__)

    if update_manifest:
        path = save_range_manifest(
            {k: r.to_entry() for k, r in live.items()}, manifest_path)
        findings.append(_finding(
            "ABS700", "range-manifest-updated", SEV_INFO,
            os.path.relpath(path, os.path.abspath(repo_root))
            if os.path.isabs(path) else path, "",
            f"recorded {len(live)} range-manifest entr"
            f"{'y' if len(live) == 1 else 'ies'}"))
    else:
        manifest = load_range_manifest(manifest_path)
        findings.extend(compare_manifest(live, manifest, paths,
                                         full_universe=full,
                                         errored=errored))
    return findings


# --- bench surface -----------------------------------------------------------


def tick_range_stats(model, sim, cache=None) -> Dict[str, int]:
    """The bench line's range field: the minimum proven counter headroom
    (bits to int32 max at the production horizon) of this exact
    configuration's tick. 0 = unproven. ``cache`` holds ``sim``'s
    graphs (the ones ``cost_model.tick_cost`` traced)."""
    rep = analyze_model(model, sim.net.n_nodes, sim.layout, sim=sim,
                        trace_cache=cache)
    return {"ovf_margin_bits": rep.ovf_margin_bits}
