"""Static per-tick cost model over an aten graph of the port's tick.

Counterpart of ``maelstrom_tpu/analysis/cost_model.py``. The eager
port launches about one kernel per non-view aten operator it
dispatches, so the quantity to budget is the **operator graph of one
tick**: how many operators it dispatches, how they split across the
phases the runtime marks (``telemetry/profiler.phase``: nemesis /
faults / deliver / node_phase / client_step / enqueue / check_summary /
telemetry), and how many intermediate bytes they write. This module
computes those numbers *statically*: the tick runs once on ``meta``
tensors, which carry shapes and dtypes and no values, under
``torch.func.functionalize`` and a ``TorchDispatchMode`` that records
every aten operator with its inputs, outputs and phase
(:class:`TickGraph`). No device is touched and no value is read.

Where it differs from the JAX model, and why:

- **The graph.** JAX traces the tick with ``jax.make_jaxpr``. The port
  records the aten operators the tick dispatches on ``meta`` tensors.
  ``torch.fx``'s ``make_fx`` records the same operators, but its
  per-node bookkeeping made one trace of the lin-kv audit tick take
  10.5 s against 1.5 s for the recorder on a CPU, and the lint traces
  some thirty models. The recorder memoises a functional pointwise
  operator's meta output by its arguments' metadata (:func:`_meta_key`):
  torch's meta versions of those operators are Python references, run
  once per operator and metadata (the graph is the same,
  ``tests/test_torch_cost.py``).
  Functionalization makes every in-place write a pure operator, as
  every equation of a jaxpr is (the lanes pass needs that): a write
  through a view (``x[..., VALID] = v``) is recorded as the operator
  (``copy``, ``mul``, ...) plus the ``select_scatter`` /
  ``slice_scatter`` that puts the result back into its base. On the
  card that write is one launch, so the cost counts leave those
  scatters out (the tick calls none itself): the counts then equal the
  operators the eager tick dispatches (``telemetry/profiler.
  phase_op_counts`` counts those on its own, and
  ``tests/test_torch_cost.py`` holds the two equal).
- **Tick variants.** The tick number ``t`` is a host int, and three
  host branches on it pick the graph: the nemesis draws a grudge only
  inside a partition phase and a scripted schedule writes each phase's
  pairs (``runtime.partition_matrix``), and clients switch to
  ``sample_final_op`` at ``final_start`` (``runtime.client_step``); a
  fault plan reads its phase's rows (``faults/engine._phase_of``). One
  jaxpr holds both arms of each; the port traces one tick per outcome
  (:func:`tick_variants`) and ``eqns`` is the heaviest variant's count,
  an upper bound per tick as JAX's is, with the breakdown in
  ``variants``.
- **eqns** counts non-view operators (views launch nothing; the view
  list is ``profile_tick._VIEW_OPS``), ``hbm_bytes`` the bytes their
  outputs hold, ``max_broadcast_bytes`` the largest output of one that
  is larger than every tensor it reads (a materialised broadcast), and
  ``const_bytes`` / ``max_const_bytes`` the tensors the tick reads that
  no operator of it made (closure constants, the counterpart of a
  jaxpr's consts).
- **loops** is always 0: eager Python loops unroll into the graph, so
  no operator is a loop.
- The 64-bit census (JAX's ``_dtype_census``) is kept per issuing
  function: the innermost frame of the port on the stack when the
  operator was dispatched (``wide_sites``).
- **The tick number.** A jaxpr's ``t`` is a traced int32; the port's is
  a host int, so ``t - heartbeat`` reaches the graph as a folded scalar.
  The recorder passes the tick a :class:`TickInt` (an int that remembers
  how it was computed from ``t``) and keeps, per operator, which scalar
  arguments came from it (:attr:`TNode.sym`): the ranges pass reads
  them as functions of ``t``. It also marks the operators issued inside
  a call of the RNG (``rng.py``) and of ``xla_math.py`` with that call
  (:attr:`TNode.region`, :class:`Region`), which the ranges pass prices
  as one function. Neither changes the graph the other passes read.

The numbers feed the same consumers as in JAX: ``lint --cost``
(``analysis/ir_lint.py``, gated against ``analysis/cost_baseline.json``
with a 10% tolerance), the bench line (``ir_eqns``, ``ir_bytes_est``;
through :func:`tick_shard_stats` the shard pass's fields),
``profile_tick.py``'s static column, the campaign report's
``ir-bytes-est``, and ``chip_smoke.py``'s check that the static count
predicts the kernels the card launches.
"""

from __future__ import annotations

import inspect
import json
import os
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

# The tick's phase vocabulary (runtime.py's phase marks). Operators
# outside these count under OTHER_PHASE, as in JAX.
PHASES = ("nemesis", "deliver", "node_phase", "client_step", "enqueue",
          "telemetry")
OTHER_PHASE = "other"

# The full known phase vocabulary: the table above plus the phases that
# ride specific configs (the fault lanes and the device verdict lanes).
# An operator outside every one of these counts as unattributed (the
# COST505 column).
KNOWN_SCOPES = PHASES + ("faults", "check_summary")

DEFAULT_COST_BASELINE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "cost_baseline.json")

# cost-gate tolerance: a model's tick may drift this fraction above its
# baseline figures before COST501 fails the gate
DEFAULT_TOLERANCE = 0.10

# the passes audit both carry layouts: batch-leading and batch-minor
AUDIT_LAYOUTS = ("lead", "minor")

META = torch.device("meta")

X64_DTYPES = ("int64", "uint64", "float64")
_X64 = frozenset(getattr(torch, name) for name in X64_DTYPES)

# the operators functionalization adds to put an in-place write's result
# back into its base (the eager tick launches only the write itself)
WRITE_BACKS = frozenset(("select_scatter", "slice_scatter",
                         "diagonal_scatter", "as_strided_scatter"))

# small integer tensors (constants, and the lane pass's folded index
# tensors) keep their values up to this many elements
CONST_VALUE_MAX_ELEMS = 8192

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ANALYSIS_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO_DIR = os.path.dirname(_PKG_DIR)


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


# --- the recorded graph ------------------------------------------------------


@dataclass(frozen=True)
class Ref:
    """A tensor argument of a :class:`TNode`: the id of its value."""
    vid: int


@dataclass
class TValue:
    """One tensor of the graph: an input (carry leaf), a constant, or an
    operator's output."""
    vid: int
    shape: Tuple[int, ...]
    dtype: torch.dtype
    kind: str                         # "input" | "const" | "op"
    producer: Optional[int] = None    # node index for kind "op"
    value: Optional[np.ndarray] = None  # a constant's value, when known

    @property
    def nbytes(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n * self.dtype.itemsize


@dataclass
class TNode:
    """One aten operator of the tick."""
    idx: int
    op: Any                           # the OpOverload
    name: str                         # its packet name ("select", ...)
    args: Any                         # args with tensors as Ref
    kwargs: Dict[str, Any]
    ins: List[int]                    # tensor inputs, flattened
    outs: List[int]                   # tensor outputs
    phase: str
    site: Optional[Tuple[str, str]] = None   # (path, function) issuing it
    sym: Optional[Dict[Any, Any]] = None     # arg index or kwarg name ->
                                             # its TickInt expression
    region: Optional[int] = None             # the Region issuing it

    @property
    def is_view(self) -> bool:
        from ..profile_tick import _VIEW_OPS
        return self.name in _VIEW_OPS

    # an OpOverload does not pickle: a graph pickles with its name
    def __getstate__(self):
        return {**self.__dict__, "op": str(self.op)}

    def __setstate__(self, state):
        ns, packet, overload = state["op"].split(".")
        state["op"] = getattr(getattr(getattr(torch.ops, ns), packet),
                              overload)
        self.__dict__.update(state)


@dataclass
class Region:
    """One call of a function of ``rng.py`` or ``xla_math.py`` (the
    outermost on the stack): its name and its scalar parameters (Python
    numbers; a TickInt's expression), for the ranges pass."""
    func: str                         # "rng.randint_from_bits", ...
    params: Dict[str, Any]


@dataclass
class TickGraph:
    """The aten graph of one tick at one ``t``: nodes in dispatch order,
    values, the carry's input leaves and the tick's output leaves (the
    carry's, then :class:`~..runtime.TickOutputs`'), each with its path
    (``.pool``, ``.node_state.term``, ...)."""
    t: int
    nodes: List[TNode] = field(default_factory=list)
    values: List[TValue] = field(default_factory=list)
    input_paths: List[str] = field(default_factory=list)
    inputs: List[int] = field(default_factory=list)
    output_paths: List[str] = field(default_factory=list)
    outputs: List[int] = field(default_factory=list)
    n_carry_out: int = 0
    regions: List[Region] = field(default_factory=list)

    def __getstate__(self):
        # the lanes pass's cached tagger is rebuilt on demand
        return {k: v for k, v in self.__dict__.items() if k != "_tagger"}

    def ops(self) -> List[TNode]:
        """The operators that launch: not views, and not the write-backs
        functionalization adds for in-place writes."""
        return [n for n in self.nodes
                if not n.is_view and n.name not in WRITE_BACKS]

    def base_bytes(self, vid: int) -> int:
        """The bytes behind a value: a view's are its base's (an
        ``expand`` of a scalar holds 4 bytes, whatever its shape)."""
        v = self.values[vid]
        while v.producer is not None and self.nodes[v.producer].is_view:
            refs = [x for x in self.nodes[v.producer].args
                    if isinstance(x, Ref)]
            if not refs:
                break
            v = self.values[refs[0].vid]
        return v.nbytes


def flatten_paths(tree, path: str = "") -> List[Tuple[str, torch.Tensor]]:
    """``(path, tensor)`` per leaf of a tree of NamedTuples, dicts and
    tuples in ``tree.tree_leaves`` order, ``None`` skipped; the paths
    are JAX's ``keystr`` (``.node_state.term``, ``['k']``, ``[0]``)."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [x for k in tree for x in flatten_paths(tree[k],
                                                       f"{path}[{k!r}]")]
    names = getattr(tree, "_fields", None)
    return [x for i, t in enumerate(tree) for x in flatten_paths(
        t, f"{path}.{names[i]}" if names else f"{path}[{i}]")]


# the site of each function of the port that issued a 64-bit operator
_SITES: Dict[Any, Tuple[str, str]] = {}


def _site() -> Optional[Tuple[str, str]]:
    """The innermost frame of the port (outside this package) on the
    stack: ``(repo-relative path, qualified function name)``."""
    f = sys._getframe(2)
    while f is not None:
        code = f.f_code
        site = _SITES.get(code)
        if site is not None:
            return site
        fn = code.co_filename
        if fn.startswith(_PKG_DIR) and not fn.startswith(_ANALYSIS_DIR):
            site = _SITES[code] = (
                os.path.relpath(fn, _REPO_DIR),
                getattr(code, "co_qualname", code.co_name))
            return site
        f = f.f_back
    return None


# --- the tick number as a function of t ------------------------------------


def _tick_op(name, fn, reflected=False):
    def op(self, other):
        if isinstance(other, bool) or not isinstance(other, int):
            return NotImplemented
        o = other.expr if isinstance(other, TickInt) else int(other)
        a, b = (o, self.expr) if reflected else (self.expr, o)
        x, y = (int(other), int(self)) if reflected else (int(self),
                                                            int(other))
        return TickInt(fn(x, y), (name, a, b))
    return op


class TickInt(int):
    """The tick number as the recorder hands it to the tick: an int
    whose value the host branches on ``t`` read as usual, and which
    carries ``expr``, how it was computed from ``t``: ``("t",)``, or
    ``(op, a, b)`` with ``op`` one of ``+ - * // %`` and ``a``/``b`` an
    expression or an int. Arithmetic with ints keeps it a TickInt; a
    torch call that takes one as a scalar records the expression on the
    operator (:attr:`TNode.sym`)."""

    def __new__(cls, value: int, expr=("t",)):
        obj = int.__new__(cls, value)
        obj.expr = expr
        return obj

    __add__ = _tick_op("+", lambda a, b: a + b)
    __radd__ = _tick_op("+", lambda a, b: a + b, reflected=True)
    __sub__ = _tick_op("-", lambda a, b: a - b)
    __rsub__ = _tick_op("-", lambda a, b: a - b, reflected=True)
    __mul__ = _tick_op("*", lambda a, b: a * b)
    __rmul__ = _tick_op("*", lambda a, b: a * b, reflected=True)
    __floordiv__ = _tick_op("//", lambda a, b: a // b)
    __mod__ = _tick_op("%", lambda a, b: a % b)

    def __neg__(self):
        return TickInt(-int(self), ("-", 0, self.expr))


def _flat(args):
    for a in args:
        if isinstance(a, (list, tuple)):
            yield from _flat(a)
        else:
            yield a


class _TickArgs:
    """A torch function mode (built lazily: ``torch.overrides`` is heavy
    to import) that, while a torch call with TickInt arguments runs,
    holds their values -> expressions in ``live`` for the recorder."""

    def __init__(self):
        from torch.overrides import TorchFunctionMode

        outer = self

        class _Mode(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                found = {int(a): a.expr for a in _flat(
                    tuple(args) + tuple(kwargs.values()))
                    if isinstance(a, TickInt)}
                if not found:
                    return func(*args, **kwargs)
                prev = outer.live
                outer.live = {**prev, **found}
                try:
                    return func(*args, **kwargs)
                finally:
                    outer.live = prev

        self.live: Dict[int, Any] = {}
        self.mode = _Mode()


# the functions whose calls are one Region: every function of rng.py and
# xla_math.py, by code object
_REGION_CODES: Dict[Any, str] = {}


def _region_codes() -> Dict[Any, str]:
    if not _REGION_CODES:
        from .. import rng, xla_math
        for mod in (rng, xla_math):
            short = mod.__name__.rsplit(".", 1)[-1]
            for name, f in vars(mod).items():
                if inspect.isfunction(f) and f.__module__ == mod.__name__:
                    _REGION_CODES[f.__code__] = f"{short}.{name}"
    return _REGION_CODES


class _Recorder:
    """Builds a :class:`TickGraph` from the operators a dispatch mode
    sees. Every tensor it meets is kept alive, so an ``id`` is never
    reused during the trace."""

    def __init__(self, graph: TickGraph, ticks: Optional[_TickArgs] = None):
        self.g = graph
        self.vid_of: Dict[int, int] = {}
        self.keep: List[torch.Tensor] = []
        self.ticks = ticks
        self._codes = _region_codes()
        self._frame = None            # the open region's frame (kept
                                      # alive, so its id is not reused)
        self._inner = None            # the last operator's innermost
        self._inner_region = None     # frame of the port, its region
        self.stop = None              # the code of the recorded call

    def value(self, x: torch.Tensor, kind: str,
              producer: Optional[int] = None) -> int:
        vid = len(self.g.values)
        val = None
        if kind == "const" and x.device.type == "cpu" \
                and x.numel() <= CONST_VALUE_MAX_ELEMS:
            try:
                val = x.detach().numpy().copy()
            except (RuntimeError, TypeError):
                val = None
        self.g.values.append(TValue(vid, tuple(x.shape), x.dtype, kind,
                                    producer, val))
        self.vid_of[id(x)] = vid
        self.keep.append(x)
        return vid

    def ref(self, x: torch.Tensor) -> int:
        vid = self.vid_of.get(id(x))
        if vid is None:
            vid = self.value(x, "const")
        return vid

    def _region(self) -> Optional[int]:
        """The Region of the outermost rng / xla_math call on the stack,
        opened at its first operator."""
        # the innermost frame of the port: while it runs, the stack above
        # it (and so the region) stays the same
        f = sys._getframe(3)
        while f is not None and (
                not f.f_code.co_filename.startswith(_PKG_DIR)
                or f.f_code.co_filename.startswith(_ANALYSIS_DIR)):
            f = f.f_back
        if f is self._inner:
            return self._inner_region
        self._inner, top = f, None
        # up to the recorded call's own frame: the tick's frames only
        while f is not None and f.f_code is not self.stop:
            if f.f_code in self._codes:
                top = f
            f = f.f_back
        self._inner_region = self._open(top)
        return self._inner_region

    def _open(self, top) -> Optional[int]:
        if top is None:
            self._frame = None
            return None
        if top is not self._frame:
            self._frame = top
            code = top.f_code
            params = {}
            for name in code.co_varnames[:code.co_argcount]:
                v = top.f_locals.get(name)
                if isinstance(v, TickInt):
                    params[name] = v.expr
                elif isinstance(v, (bool, int, float)):
                    params[name] = v
            self.g.regions.append(Region(self._codes[code], params))
        return len(self.g.regions) - 1

    def add(self, func, args, kwargs, out) -> None:
        ins: List[int] = []

        def to_ref(x):
            if isinstance(x, torch.Tensor):
                vid = self.ref(x)
                ins.append(vid)
                return Ref(vid)
            if isinstance(x, (list, tuple)):
                return type(x)(to_ref(y) for y in x)
            return x

        rargs = tuple(to_ref(x) for x in args)
        rkwargs = {k: to_ref(x) for k, x in kwargs.items()}
        idx = len(self.g.nodes)
        outs = []
        for o in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(o, torch.Tensor):
                vid = self.vid_of.get(id(o))
                if vid is None or vid in ins:
                    # a fresh output, or an operator that returns its
                    # operand (a write back into a carry input): a new
                    # version of it
                    vid = self.value(o, "op", idx)
                outs.append(vid)
        name = func.overloadpacket.__name__
        site = None
        if any(self.g.values[v].dtype in _X64 for v in outs):
            site = _site()
        sym = None
        live = self.ticks.live if self.ticks is not None else None
        if live:
            sym = {k: live[a] for k, a in list(enumerate(args))
                   + list(kwargs.items())
                   if type(a) is int and a in live} or None
        from ..telemetry.profiler import _CURRENT
        self.g.nodes.append(TNode(idx, func, name, rargs, rkwargs, ins,
                                  outs, _CURRENT[0], site, sym,
                                  self._region()))


# the process-group operators of torch.distributed: functional
# collectives and the c10d ops behind the classic API
COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d")


def _collective_out(func, args, group_size: int):
    """What a collective of :data:`COLLECTIVE_NAMESPACES` returns, on
    ``meta`` and without a process group: the gathers' outputs grow by
    the group's size along dim 0, a reduce-scatter's shrink by it, the
    rest keep their input's shape (the in-place c10d ops return their
    operands). No backend runs: the recorder sees the operator and its
    shapes, and nothing is communicated."""
    name = func.overloadpacket.__name__
    x = args[0]
    if isinstance(x, (list, tuple)):
        return type(x)(torch.empty_like(t) for t in x)
    if name.startswith("all_gather"):
        n = args[1] if len(args) > 1 and isinstance(args[1], int) \
            else group_size
        return x.new_empty((x.shape[0] * n,) + tuple(x.shape[1:]))
    if name.startswith("reduce_scatter"):
        n = args[2] if len(args) > 2 and isinstance(args[2], int) \
            else group_size
        return x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    if name == "wait_tensor":
        return x
    return torch.empty_like(x)


def _off_meta_copy(func, args, kwargs) -> bool:
    """A copy of a ``meta`` tensor to another accelerator device (a
    cross-device copy on the card); a copy to the CPU is a host read and
    raises as before."""
    dev = kwargs.get("device")
    return (func is torch.ops.aten._to_copy.default and dev is not None
            and torch.device(dev).type not in ("meta", "cpu")
            and isinstance(args[0], torch.Tensor) and args[0].is_meta)


# per operator: whether its meta output may be memoised (a functional
# pointwise operator: a fresh tensor whose shape, strides and dtype
# follow from its arguments' alone)
_MEMOISABLE: Dict[Any, bool] = {}
# the meta versions' outputs, (shape, strides, dtype), by operator and
# :func:`_meta_key`; emptied when it reaches this many entries
_META_OUTS: Dict[Any, Tuple] = {}
META_OUTS_MAX = 1 << 16


def _meta_key(func, args, kwargs):
    """The key of a functional pointwise operator's meta output: the
    operator, each tensor argument's shape, strides, offset and dtype,
    and every other argument with its type. None where the output is
    not memoised (another operator, a tensor off ``meta``, a list, a
    tuple or an unhashable argument)."""
    ok = _MEMOISABLE.get(func)
    if ok is None:
        ok = _MEMOISABLE[func] = (torch.Tag.pointwise in func.tags
                                  and not func._schema.is_mutable)
    if not ok:
        return None
    key = [func]
    for name, a in (*enumerate(args), *kwargs.items()):
        if isinstance(a, torch.Tensor):
            if not a.is_meta:
                return None
            key.append((name, a.shape, a.stride(), a.storage_offset(),
                        a.dtype))
        elif isinstance(a, (list, tuple)):
            return None
        else:
            key.append((name, type(a), a))
    key = tuple(key)
    try:
        hash(key)
    except TypeError:
        return None
    return key


def _recording(rec: _Recorder, group_size: int = 2):
    """The dispatch mode that feeds ``rec``. A collective (the tick of a
    shard that talks to its peers) is recorded with the shapes of
    :func:`_collective_out` at ``group_size`` shards and is not run; a
    copy of a ``meta`` tensor to an accelerator stays on ``meta`` and
    keeps its ``device`` argument in the graph."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func.namespace in COLLECTIVE_NAMESPACES:
                out = _collective_out(func, args, group_size)
            elif _off_meta_copy(func, args, kwargs):
                out = func(*args, **{**kwargs, "device": META})
            else:
                # torch's meta versions of the pointwise operators are
                # Python references: each is run once per operator and
                # arguments' metadata
                key = _meta_key(func, args, kwargs)
                hit = _META_OUTS.get(key) if key is not None else None
                if hit is not None:
                    out = torch.empty_strided(*hit[:2], dtype=hit[2],
                                              device=META)
                else:
                    out = func(*args, **kwargs)
                    if key is not None and isinstance(out, torch.Tensor):
                        if len(_META_OUTS) >= META_OUTS_MAX:
                            _META_OUTS.clear()
                        _META_OUTS[key] = (out.shape, out.stride(),
                                           out.dtype)
            # the phase ranges' own profiler ops launch nothing
            if func.namespace != "profiler":
                rec.add(func, args, kwargs, out)
            return out

    return _Mode()


def record_tick(model, sim, t: int) -> TickGraph:
    """Run one tick of ``model`` under ``sim`` at tick ``t`` on ``meta``
    tensors, functionalized, and record its aten graph: the same
    ``init_carry`` and ``make_tick_fn`` closure the executors run. The
    tick gets ``t`` as a :class:`TickInt`. Raises what the tick raises
    (a host read raises on ``meta``)."""
    from ..runtime import init_carry, make_tick_fn

    g = TickGraph(t=int(t))
    ticks = _TickArgs()
    rec = _Recorder(g, ticks)

    with torch.no_grad():
        carry = init_carry(model, sim, 0, META)
        tick = make_tick_fn(model, sim, None, META)
        for p, x in flatten_paths(carry):
            g.input_paths.append(p)
            g.inputs.append(rec.value(x, "input"))
        def call(c):
            return tick(c, TickInt(t))
        rec.stop = call.__code__
        fn = torch.func.functionalize(call, remove="mutations")
        with _recording(rec), ticks.mode:
            new_carry, ys = fn(carry)
    outs = flatten_paths(new_carry)
    g.n_carry_out = len(outs)
    outs += flatten_paths(ys, ".ys")
    for p, x in outs:
        g.output_paths.append(p)
        g.outputs.append(rec.ref(x))
    return g


def record_call(fn, inputs, *args, group_size: int = 2) -> TickGraph:
    """The aten graph of ``fn(inputs, *args)`` on ``meta`` tensors,
    functionalized, as :func:`record_tick` records a tick: the tensors
    of ``inputs`` (a tree) are the graph's inputs, what ``fn`` returns
    its outputs. The executable store's certificate records a chunk
    dispatch so (``aot_store.record_dispatch``), and the shard pass one
    shard's chunk (``shard_audit.trace_sharded_chunk``)."""
    g = TickGraph(t=0)
    rec = _Recorder(g)

    def call(c):
        return fn(c, *args)
    rec.stop = call.__code__
    with torch.no_grad():
        for p, x in flatten_paths(inputs):
            g.input_paths.append(p)
            g.inputs.append(rec.value(x, "input"))
        f = torch.func.functionalize(call, remove="mutations")
        with _recording(rec, group_size):
            out = f(inputs)
    for p, x in flatten_paths(out):
        g.output_paths.append(p)
        g.outputs.append(rec.ref(x))
    g.n_carry_out = len(g.outputs)
    return g


def record_init(model, sim) -> TickGraph:
    """The aten graph of ``init_carry(model, sim, 0)`` on ``meta``
    tensors: no inputs; its outputs are the carry's leaves (the ranges
    pass seeds the carry from it)."""
    from ..runtime import init_carry

    g = TickGraph(t=0)
    rec = _Recorder(g)

    def call():
        return init_carry(model, sim, 0, META)
    rec.stop = call.__code__
    with torch.no_grad(), _recording(rec):
        carry = call()
    for p, x in flatten_paths(carry):
        g.output_paths.append(p)
        g.outputs.append(rec.ref(x))
    g.n_carry_out = len(g.outputs)
    return g


# --- tick variants -----------------------------------------------------------


def variant_tick(sim, t: int) -> str:
    """The variant of tick ``t``: the outcome of the tick's host
    branches on ``t``, as a name. ``heal`` when every branch takes its
    default, else the non-default outcomes joined by ``+``:
    ``partition`` (the nemesis draws a grudge), ``scripted-<i>`` /
    ``scripted-healed`` (the phase of a scripted schedule), ``plan-<i>``
    (a fault plan's phase row; ``plan-<P>`` is its healthy row),
    ``final`` (clients draw final ops)."""
    import bisect
    nem, parts = sim.nemesis, []
    if nem.enabled and t < nem.stop_tick:
        if nem.kind == "scripted":
            untils = [u for u, _ in nem.schedule]
            i = bisect.bisect_right(untils, t)
            parts.append(f"scripted-{i}" if i < len(untils)
                         else "scripted-healed")
        elif (t // nem.interval) % 2 == 1:
            parts.append("partition")
    fx = sim.faults
    if fx.active and not fx.has_fuzz:
        P = len(fx.untils)
        i = P if t >= fx.stop_tick else min(
            bisect.bisect_right(list(fx.untils), t), P)
        parts.append(f"plan-{i}")
    if t >= sim.client.final_start:
        parts.append("final")
    return "+".join(parts) or "heal"


def tick_variants(sim) -> Dict[str, int]:
    """One representative tick per outcome of the tick's host branches
    on ``t`` (:func:`variant_tick`), in tick order: the first tick of
    each outcome among tick 0, the nemesis phase boundaries, the
    schedule's and the fault plan's phase starts, ``stop_tick`` and
    ``final_start``."""
    nem, fx = sim.nemesis, sim.faults
    cands = {0, nem.stop_tick, sim.client.final_start}
    if nem.enabled and nem.kind != "scripted":
        cands.update(k * nem.interval for k in (1, 2))
    cands.update(u for u, _ in nem.schedule)
    if fx.active and not fx.has_fuzz:
        cands.update(fx.untils)
        cands.add(fx.stop_tick)
    out: Dict[str, int] = {}
    for t in sorted(c for c in cands if 0 <= c < sim.n_ticks):
        out.setdefault(variant_tick(sim, t), int(t))
    return out


def trace_tick(model, sim, t: int = 0, cache=None,
               variant: Optional[str] = None) -> TickGraph:
    """The recorded tick at ``t`` (:func:`record_tick`). ``cache`` (a
    mutable mapping) holds one graph per model, layout and variant,
    keyed by :func:`entry_key` and ``variant``, so that ``lint --ir
    --cost --lanes`` traces each model once per layout and variant. The
    key does not capture the rest of the sim config: a cache holds one
    sim's graphs per model and layout (the lint passes' :func:`audit_sim`
    sims, or a caller's own)."""
    key = None
    if cache is not None:
        key = (entry_key(_model_name(model), sim.net.n_nodes, sim.layout)
               + f"::{variant or t}")
        hit = cache.get(key)
        if hit is not None:
            return hit
    g = record_tick(model, sim, t)
    if key is not None:
        cache[key] = g
    return g


def trace_variants(model, sim, cache=None) -> Dict[str, TickGraph]:
    """One recorded tick per :func:`tick_variants` entry."""
    return {name: trace_tick(model, sim, t, cache=cache, variant=name)
            for name, t in tick_variants(sim).items()}


def _model_name(model) -> str:
    return getattr(model, "name", type(model).__name__)


# --- the report --------------------------------------------------------------


@dataclass
class CostReport:
    """Static cost of one tick (one model), the heaviest variant's."""
    eqns: int                        # non-view operators per tick
    hbm_bytes: int                   # their output bytes per tick
    phases: Dict[str, int] = field(default_factory=dict)
    ops: Dict[str, int] = field(default_factory=dict)
    const_bytes: int = 0             # bytes of the tick's constants
    max_const_bytes: int = 0         # the largest constant
    carry_bytes: int = 0             # carry bytes (audit config)
    max_broadcast_bytes: int = 0     # largest materialised broadcast
    loops: int = 0                   # always 0: Python loops unroll
    scopes: Dict[str, int] = field(default_factory=dict)
                                     # operators per raw phase name
                                     # (KNOWN_SCOPES members; those
                                     # outside every phase under "")
    unattributed_eqns: int = 0       # operators outside every
                                     # KNOWN_SCOPES phase: COST505
    unknown_scopes: Tuple[str, ...] = ()
    variant: str = "heal"            # the variant the figures are of
    variants: Dict[str, int] = field(default_factory=dict)
                                     # eqns per tick variant
    wide_sites: Dict[Tuple[str, str], int] = field(default_factory=dict)
                                     # 64-bit outputs per issuing
                                     # function: the census

    def to_entry(self) -> Dict[str, Any]:
        """The checked-in baseline representation (stable keys only).
        ``fusion-breakers`` is 0 for every eager tick; ``variants`` is
        the port's per-variant breakdown."""
        return {"eqns": self.eqns,
                "hbm-bytes-per-tick": self.hbm_bytes,
                "fusion-breakers": self.loops,
                "unattributed-eqns": self.unattributed_eqns,
                "phases": {k: self.phases[k] for k in sorted(self.phases)},
                "variants": dict(self.variants)}


def cost_of_graph(g: TickGraph) -> CostReport:
    """Walk one recorded tick into a :class:`CostReport`."""
    phases: Dict[str, int] = {p: 0 for p in PHASES + (OTHER_PHASE,)}
    ops: Dict[str, int] = {}
    scopes: Dict[str, int] = {}
    wide: Dict[Tuple[str, str], int] = {}
    total = nbytes = max_bcast = 0
    vals = g.values
    for n in g.ops():
        total += 1
        ph = n.phase if n.phase in PHASES else OTHER_PHASE
        phases[ph] += 1
        raw = "" if n.phase == OTHER_PHASE else n.phase
        scopes[raw] = scopes.get(raw, 0) + 1
        ops[n.name] = ops.get(n.name, 0) + 1
        out_b = [vals[v].nbytes for v in n.outs]
        nbytes += sum(out_b)
        in_max = max((g.base_bytes(v) for v in n.ins), default=0)
        for b in out_b:
            if b > in_max:
                max_bcast = max(max_bcast, b)
        if any(_dtype_name(vals[v].dtype) in X64_DTYPES for v in n.outs):
            site = n.site or ("?", "?")
            wide[site] = wide.get(site, 0) + 1
    consts = [v.nbytes for v in vals if v.kind == "const"]
    carry_bytes = sum(vals[v].nbytes for v in g.inputs)
    unattributed = sum(c for r, c in scopes.items() if r not in KNOWN_SCOPES)
    unknown = tuple(sorted(r for r in scopes
                           if r and r not in KNOWN_SCOPES))
    return CostReport(
        eqns=total, hbm_bytes=nbytes,
        phases={k: v for k, v in phases.items() if v}, ops=ops,
        const_bytes=sum(consts), max_const_bytes=max(consts, default=0),
        carry_bytes=carry_bytes, max_broadcast_bytes=max_bcast, loops=0,
        scopes={k: scopes[k] for k in sorted(scopes)},
        unattributed_eqns=unattributed, unknown_scopes=unknown,
        wide_sites=wide)


def cost_of_variants(graphs: Dict[str, TickGraph]) -> CostReport:
    """The heaviest variant's :class:`CostReport` with every variant's
    operator count in ``variants``. Constants and the 64-bit census
    are the union over the variants (a site issues in some tick)."""
    reports = {name: cost_of_graph(g) for name, g in graphs.items()}
    name = max(reports, key=lambda k: (reports[k].eqns,
                                       reports[k].hbm_bytes))
    rep = reports[name]
    rep.variant = name
    rep.variants = {k: r.eqns for k, r in reports.items()}
    wide: Dict[Tuple[str, str], int] = {}
    for r in reports.values():
        for site, c in r.wide_sites.items():
            wide[site] = max(wide.get(site, 0), c)
        rep.max_const_bytes = max(rep.max_const_bytes, r.max_const_bytes)
        rep.max_broadcast_bytes = max(rep.max_broadcast_bytes,
                                      r.max_broadcast_bytes)
    rep.wide_sites = wide
    return rep


# --- the audited configuration -------------------------------------------


def audit_sim(model, node_count: int, layout: str = "lead"):
    """The small fixed audit config every static analysis shares (the
    contract audit's opts): cost numbers are comparable only under one
    config."""
    from ..harness import make_sim_config
    from .contract_audit import _audit_opts
    # range_horizon_check=False: the audit config is what the ranges pass
    # analyzes — a stale proven bound must not block its own re-proof
    return make_sim_config(model, {**_audit_opts(node_count),
                                   "layout": layout,
                                   "range_horizon_check": False})


def tick_cost(model, sim, cache=None) -> CostReport:
    """One-call static cost of ``model``'s tick under ``sim``, over
    every tick variant: the bench and campaign-report entry point."""
    return cost_of_variants(trace_variants(model, sim, cache=cache))


def tick_range_stats(model, sim, cache=None) -> Dict[str, int]:
    """The bench line's ``ovf_margin_bits``: the minimum proven counter
    headroom of ``sim``'s own tick (0 = unproven). Thin delegation; the
    analysis lives in :mod:`.absint`."""
    from .absint import tick_range_stats as stats
    return stats(model, sim, cache=cache)


def tick_shard_stats(model, sim, mesh_size: int = 8,
                     cache=None) -> Dict[str, int]:
    """The bench line's shard fields: ``collectives_per_tick`` (the
    collectives in a shard's tick under ``sim``) and ``ici_bytes_est``
    (the per-tick estimate at ``mesh_size`` shards). Thin delegation;
    the analysis lives in :mod:`.shard_audit`."""
    from .shard_audit import shard_stats
    return shard_stats(model, sim, mesh_size, cache=cache)


def tick_lane_stats(model, sim, cost: Optional[CostReport] = None,
                    cache=None) -> Dict[str, int]:
    """Lane-liveness stats of ``model``'s tick under ``sim``:
    ``lanes_live`` / ``lanes_dead`` / ``lanes_dead_bytes``, the figures
    the bench line and ``profile_tick.py`` print next to
    ``ir_bytes_est``. ``cost`` and ``cache`` (the :func:`tick_cost` of
    the same sim and the cache it traced into) skip the duplicate
    traces. Thin delegation; the analysis lives in
    :mod:`.lane_liveness`."""
    from .lane_liveness import lane_stats
    return lane_stats(model, sim, cost=cost, cache=cache)


def cost_specs() -> List[Tuple[str, int]]:
    """Every registered model: the contract audit's workload table plus
    the registered mutants (the universe CON2xx audits); the passes
    audit each in every layout of :data:`AUDIT_LAYOUTS`."""
    from .contract_audit import AUDIT_WORKLOADS, _buggy_workloads
    return list(AUDIT_WORKLOADS) + _buggy_workloads()


def entry_key(workload: str, node_count: int, layout: str) -> str:
    return f"{workload}/n={node_count}/{layout}"


# --- baseline io -------------------------------------------------------------


def toolchain() -> str:
    """The tracing toolchain's version: torch's, without its build tag
    (a CPU and a CUDA build of one release dispatch the same operators
    on ``meta`` tensors)."""
    return torch.__version__.split("+")[0]


def toolchain_note(recorded: Optional[str], what: str,
                   re_record_flag: str = "--update-baseline",
                   ) -> Optional[str]:
    """The staleness downgrade: recorded baselines and manifests depend
    on the torch version (its decompositions pick the operators), so
    when the recording version differs from the running one, drift
    downgrades to a warning that says how to re-record. ``None`` when
    the versions match (or nothing was recorded)."""
    if recorded is None or recorded == toolchain():
        return None
    return (f"recorded under torch {recorded}, this run is torch "
            f"{toolchain()} — toolchain drift, not necessarily a code "
            f"regression; re-record {what} with {re_record_flag} and "
            f"commit the result")


def load_cost_baseline(path: Optional[str] = None) -> Dict[str, Any]:
    path = path or DEFAULT_COST_BASELINE
    if not os.path.exists(path):
        return {"version": 1, "tolerance": DEFAULT_TOLERANCE,
                "entries": {}}
    with open(path) as f:
        data = json.load(f)
    data.setdefault("tolerance", DEFAULT_TOLERANCE)
    data.setdefault("entries", {})
    return data


def save_cost_baseline(entries: Dict[str, Dict[str, Any]],
                       path: Optional[str] = None,
                       tolerance: float = DEFAULT_TOLERANCE) -> str:
    path = path or DEFAULT_COST_BASELINE
    payload = {
        "version": 1,
        "_comment": (
            "Per-model static tick-cost baseline for `python -m "
            "maelstrom_tpu_torch lint --cost`. Keys: <workload>/n=<nodes>"
            "/<layout>; eqns = non-view aten operators of one tick of "
            "the heaviest tick variant (variants = the count per "
            "variant), hbm-bytes-per-tick = their summed output bytes, "
            "phases = operators per runtime phase, unattributed-eqns = "
            "operators outside every known phase (the COST505 budget). "
            "Regenerate after an INTENTIONAL cost change with `lint "
            "--cost --update-baseline`; a change that regresses any "
            "entry by more than `tolerance` fails the gate (COST501/"
            "COST505). torch-version records the tracing toolchain: "
            "under another torch the gate downgrades drift to a "
            "re-record warning."),
        "torch-version": toolchain(),
        "tolerance": tolerance,
        "entries": {k: entries[k] for k in sorted(entries)},
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")
    return path
