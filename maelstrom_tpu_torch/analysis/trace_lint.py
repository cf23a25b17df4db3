"""Trace-hygiene lint: an AST pass over the code that runs in the tick.

Counterpart of ``maelstrom_tpu/analysis/trace_lint.py`` with torch
rules. The port runs its tick eagerly, so nothing is traced; what the
JAX pass calls a *traced* function is here one that runs on device
tensors inside the tick. The hazards are the ones a CUDA graph of the
tick forbids and a bit-exact replay cannot afford: a Python branch,
loop or assert on a device value and every explicit host read (each a
host sync that stalls the issuing thread), hidden mutable state
(runs on every call, not once per graph), data-dependent shapes (a
sync, and a shape that differs between replicas), and draws from
torch's global generator or Python's (not a pure function of (seed,
purpose, tick, instance id) like ``rng.py``'s threefry).

Mechanics: the JAX pass's file-local taint analysis. A function is
**traced** when

- it is a known Model hook (``handle``, ``inbox_step``, ``sample_op``,
  ...), or
- one of its parameters has a conventional device-value name (``row``,
  ``msg``, ``keys``, ``carry``, ``pool``, ...), or
- it is (transitively) called from a traced function — by-name fixpoint
  over ``self.x(...)`` / bare-name calls across all scanned files, or
- it is defined *inside* a traced function.

Inside a traced function, parameters are tainted (except a static-name
allowlist: ``self``, ``cfg``, ``sim``, config objects, and parameters
annotated ``int``, ``float``, ``bool`` or ``str``), and taint
propagates through expressions; every ``torch.*`` call yields a tensor
except the static queries (``torch.device``, ``torch.iinfo``, ...).
**The tick index ``t`` is static**: the port's tick takes it as a host
``int`` (``runtime.make_tick_fn``'s ``tick_fn(carry, t)``), so a Python
branch on it is legal — where the JAX pass must flag it.

Rules (TRC1xx):

=======  ====================  ========  =====================================
rule     name                  severity  what it flags
=======  ====================  ========  =====================================
TRC101   traced-branch         error     python ``if`` on a device value
TRC102   traced-while          error     python ``while`` on a device value
TRC103   traced-assert         error     ``assert`` on a device value
TRC104   host-sync             error     ``.item()`` / ``.tolist()`` /
                                         ``.cpu()`` / ``.numpy()`` /
                                         ``int()`` / ``float()`` / ``bool()``
                                         / ``np.asarray`` on a device value
TRC105   mutable-capture       error     mutating a list/dict/set captured
                                         from an enclosing scope (or module /
                                         ``self`` state) inside the tick
TRC106   data-dependent-shape  warning   ``torch.nonzero`` / ``unique`` /
                                         ``masked_select`` / ``argwhere`` /
                                         1-arg ``where`` / boolean-mask
                                         indexing — a host sync and a
                                         value-dependent shape
TRC107   bare-python-rng       error     ``random.*`` / ``np.random.*`` /
                                         ``torch.rand*`` / ``randint`` /
                                         ``randn`` / ``randperm`` /
                                         ``bernoulli`` / ``multinomial`` in
                                         the tick (the global generators;
                                         ``rng.py``'s threefry is the only
                                         replay-stable source)
=======  ====================  ========  =====================================
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set, Tuple

from .findings import Finding, SEV_ERROR, SEV_WARNING

PASS_NAME = "trace"

# Model hooks that the runtime calls inside the tick (runtime.Model):
# the legacy and the fused node protocols, the client vocabulary, the
# invariants and verdict lanes, and the fault planes' restart hooks.
KNOWN_TRACED_METHODS = {
    "init_state", "handle", "tick", "node_rng", "inbox_step",
    "fused_tick", "invariants", "summary_step", "sample_op",
    "sample_final_op", "encode_request", "decode_reply",
    "decode_reply_wide", "snapshot_row", "restart_row", "join_row",
    "boot_config",
}

# Conventional device-value argument names: presence of one marks a
# module-level function as traced (tick-loop helpers, netsim ops). The
# JAX pass's list less ``t`` (a host int here), plus the port's batched
# names (``keys``, ``mkeys``, ``jitter``, ``cs``, ``summ``).
TRACED_PARAM_NAMES = {
    "row", "msg", "msgs", "key", "keys", "mkeys", "carry", "pool",
    "node_state", "client_state", "cs", "inbox", "inbox_nodes",
    "inbox_clients", "op", "uniq", "msg_id", "client_idx", "node_idx",
    "partitions", "instance_key", "row_body", "tel", "jitter", "summ",
}

# Parameters that are static (python-level) even inside traced functions:
# the JAX pass's list, plus the tick index ``t`` and torch's placement
# arguments.
STATIC_PARAM_NAMES = {
    "self", "cls", "cfg", "ccfg", "nem", "sim", "model", "params",
    "n_nodes", "node_count", "seed", "interpret", "length", "checker",
    "opts", "mesh", "axes", "gossip_prob", "body_lanes",
    # fault-plan engine (faults/): the compiled FaultConfig and its
    # snapshot stride are host constants, exactly like `nem`/`cfg`
    "fx", "every",
    # the tick index is a host int in the eager tick
    "t",
    "device", "dtype",
}

# Attribute reads on tainted values that yield static metadata.
_STATIC_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda", "is_meta",
                 "layout"}
# Methods on tainted values that return static metadata.
_STATIC_METHODS = {"dim", "numel", "size", "element_size", "get_device",
                   "is_contiguous", "is_floating_point", "stride",
                   "data_ptr"}

# A parameter annotated as one of these host scalar types is static (the
# port annotates its shape and bound arguments: ``geometry(S: int, ...)``).
_STATIC_ANNOTATIONS = {"int", "float", "bool", "str"}

# torch functions whose results are host values, not tensors.
_TORCH_STATIC = {"device", "Size", "iinfo", "finfo", "is_tensor",
                 "is_floating_point", "get_default_dtype", "no_grad",
                 "promote_types", "is_grad_enabled", "get_num_threads",
                 "cuda", "profiler", "autograd", "distributed",
                 "is_inference_mode_enabled", "dtype"}

# Calls that launder taint into static python values (and are themselves
# host syncs when applied to a device value).
_HOST_SYNC_BUILTINS = {"int", "float", "bool", "complex"}
_HOST_SYNC_ATTRS = {"item", "tolist", "cpu", "numpy"}
_NP_SYNC_FUNCS = {"asarray", "array", "copyto"}

_DATA_DEP_FUNCS = {"nonzero", "flatnonzero", "argwhere", "unique",
                   "unique_values", "unique_consecutive", "masked_select"}

# torch's global-generator draws, as functions and as tensor methods
_TORCH_RNG_FUNCS = {"rand", "rand_like", "randint", "randint_like", "randn",
                    "randn_like", "randperm", "bernoulli", "multinomial",
                    "normal", "poisson"}
_TORCH_RNG_METHODS = {"bernoulli", "bernoulli_", "multinomial", "uniform_",
                      "normal_", "random_", "exponential_", "geometric_",
                      "cauchy_", "log_normal_"}

# elementwise ops whose results are boolean masks (for mask indexing)
_MASK_METHODS = {"bool", "logical_and", "logical_or", "logical_not",
                 "logical_xor", "isin", "eq", "ne", "lt", "le", "gt", "ge",
                 "isnan", "isfinite"}

_MUTATING_METHODS = {"append", "extend", "insert", "remove", "pop",
                     "clear", "add", "discard", "update", "setdefault",
                     "popitem"}

_RNG_MODULE_NAMES = {"random"}          # stdlib `import random`
_NP_NAMES = {"np", "numpy"}

# Builtins whose results are static regardless of argument taint (len of
# a tensor is its static shape; range/enumerate over statics).
_STATIC_RESULT_BUILTINS = {"len", "range", "enumerate", "zip", "isinstance",
                           "hasattr", "getattr", "type", "round", "repr",
                           "str", "print", "min", "max", "abs", "sorted"}


def _func_params(fn: ast.AST) -> List[str]:
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


def _static_annotated(fn: ast.AST) -> Set[str]:
    """Parameters annotated as a host scalar (``n: int``, ``x:
    Optional[float]``): static, whatever their name."""
    a = fn.args
    out = set()
    for p in a.posonlyargs + a.args + a.kwonlyargs:
        ann = p.annotation
        if isinstance(ann, ast.Subscript) and \
                _dotted(ann.value) in ("Optional", "typing.Optional"):
            ann = ann.slice
        if isinstance(ann, ast.Name) and ann.id in _STATIC_ANNOTATIONS:
            out.add(p.arg)
        elif isinstance(ann, ast.Constant) and ann.value in \
                _STATIC_ANNOTATIONS:
            out.add(p.arg)
    return out


def _tensor_checks(test: ast.AST) -> Set[str]:
    """Names that ``isinstance(name, torch.Tensor)`` tests in ``test``
    (alone or joined by ``or``): in the ``else`` branch they are host
    values."""
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.Or):
        out: Set[str] = set()
        for v in test.values:
            got = _tensor_checks(v)
            if not got:
                return set()
            out |= got
        return out
    if isinstance(test, ast.Call) and isinstance(test.func, ast.Name) \
            and test.func.id == "isinstance" and len(test.args) == 2 \
            and isinstance(test.args[0], ast.Name) \
            and (_dotted(test.args[1]) or "").endswith("Tensor"):
        return {test.args[0].id}
    return set()


def _dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for nested attribute chains rooted at a Name, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _torch_static(dotted: str) -> bool:
    parts = dotted.split(".")
    return len(parts) > 1 and parts[1] in _TORCH_STATIC


class _FileIndex(ast.NodeVisitor):
    """First pass over one file: function defs, their called names, and
    which functions look traced by themselves."""

    def __init__(self):
        self.functions: Dict[str, List[Tuple[str, ast.AST]]] = {}
        # name -> list of (qualname, node); name collisions keep all
        self.calls_from: Dict[str, Set[str]] = {}   # qualname -> callee names
        self.self_traced: Set[str] = set()          # qualnames
        self._class_stack: List[str] = []

    def _qual(self, name: str) -> str:
        return ".".join(self._class_stack + [name])

    def visit_ClassDef(self, node: ast.ClassDef):
        self._class_stack.append(node.name)
        self.generic_visit(node)
        self._class_stack.pop()

    def _visit_fn(self, node):
        qual = self._qual(node.name)
        self.functions.setdefault(node.name, []).append((qual, node))
        params = _func_params(node)
        if self._class_stack:
            # methods: only the runtime's known hooks (and the call-graph
            # fixpoint) — names like `row` also appear on host decoders
            if node.name in KNOWN_TRACED_METHODS:
                self.self_traced.add(qual)
        elif any(p in TRACED_PARAM_NAMES
                 for p in params if p not in STATIC_PARAM_NAMES
                 and p not in _static_annotated(node)):
            self.self_traced.add(qual)
        callees: Set[str] = set()
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                f = sub.func
                if isinstance(f, ast.Name):
                    callees.add(f.id)
                elif isinstance(f, ast.Attribute) and \
                        isinstance(f.value, ast.Name) and \
                        f.value.id in ("self", "cls"):
                    callees.add(f.attr)
        self.calls_from[qual] = callees
        # nested defs are deliberately NOT indexed as separate functions:
        # the checker walks them inline with the parent's taint env

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn


def _traced_qualnames(indexes: Dict[str, _FileIndex]) -> Set[str]:
    """Global fixpoint: traced roots + anything they call (by name)."""
    traced_names: Set[str] = set()      # bare function/method names
    traced_quals: Set[str] = set()
    for idx in indexes.values():
        for qual in idx.self_traced:
            traced_quals.add(qual)
            traced_names.add(qual.rsplit(".", 1)[-1])
    changed = True
    while changed:
        changed = False
        for idx in indexes.values():
            for name, defs in idx.functions.items():
                for qual, _node in defs:
                    if qual not in traced_quals and name not in traced_names:
                        continue
                    if qual not in traced_quals:
                        traced_quals.add(qual)
                        changed = True
                    for callee in idx.calls_from.get(qual, ()):
                        if callee in traced_names:
                            continue
                        # only propagate to names actually defined
                        # somewhere in the scanned set
                        if any(callee in i.functions
                               for i in indexes.values()):
                            traced_names.add(callee)
                            changed = True
    return traced_quals


class _TraceChecker(ast.NodeVisitor):
    """Taint-tracking walk of ONE traced function (incl. nested defs)."""

    def __init__(self, path: str, symbol: str, module_mutables: Set[str],
                 findings: List[Finding]):
        self.path = path
        self.symbol = symbol
        self.module_mutables = module_mutables
        self.findings = findings
        self.tainted: Set[str] = set()
        self.masks: Set[str] = set()        # names bound to bool masks
        self.local_names: Set[str] = set()
        self._flagged: Set[Tuple[str, int]] = set()

    # --- reporting --------------------------------------------------------

    def _flag(self, rule: str, name: str, severity: str, node: ast.AST,
              message: str):
        k = (rule, getattr(node, "lineno", 0))
        if k in self._flagged:
            return
        self._flagged.add(k)
        self.findings.append(Finding(
            rule=rule, name=name, severity=severity, pass_name=PASS_NAME,
            path=self.path, line=getattr(node, "lineno", 0),
            symbol=self.symbol, message=message))

    # --- taint evaluation -------------------------------------------------

    def _is_tainted(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_ATTRS:
                return False
            base = node.value
            # self.x / cfg.x / module.CONST are static configuration
            if isinstance(base, ast.Name) and base.id not in self.tainted:
                return False
            return self._is_tainted(base)
        if isinstance(node, ast.Subscript):
            return (self._is_tainted(node.value)
                    or self._is_tainted(node.slice))
        if isinstance(node, ast.Call):
            return self._call_taint(node)
        if isinstance(node, ast.BinOp):
            return self._is_tainted(node.left) or self._is_tainted(node.right)
        if isinstance(node, ast.UnaryOp):
            return self._is_tainted(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self._is_tainted(v) for v in node.values)
        if isinstance(node, ast.Compare):
            # `x is None` / `x is not None` is a static python-level
            # structure check, legitimate on optional tensor args
            if all(isinstance(op, (ast.Is, ast.IsNot))
                   for op in node.ops):
                return False
            return (self._is_tainted(node.left)
                    or any(self._is_tainted(c) for c in node.comparators))
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any(self._is_tainted(e) for e in node.elts)
        if isinstance(node, ast.Dict):
            return any(self._is_tainted(v) for v in node.values
                       if v is not None)
        if isinstance(node, ast.IfExp):
            return (self._is_tainted(node.test)
                    or self._is_tainted(node.body)
                    or self._is_tainted(node.orelse))
        if isinstance(node, ast.Starred):
            return self._is_tainted(node.value)
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            return self._comp_taint(node, [node.elt])
        if isinstance(node, ast.DictComp):
            return self._comp_taint(node, [node.key, node.value])
        if isinstance(node, ast.Slice):
            return any(self._is_tainted(p) for p in
                       (node.lower, node.upper, node.step) if p is not None)
        return False

    def _comp_taint(self, node: ast.AST, elts: List[ast.AST]) -> bool:
        """A comprehension's elements, with each target bound to its
        iterable's taint (``x.data_ptr() for x in tensors`` is static)."""
        saved = set(self.tainted)
        try:
            for g in node.generators:
                it = self._is_tainted(g.iter)
                for n in ast.walk(g.target):
                    if isinstance(n, ast.Name):
                        (self.tainted.add if it else self.tainted.discard)(
                            n.id)
            return any(self._is_tainted(e) for e in elts)
        finally:
            self.tainted = saved

    def _call_taint(self, node: ast.Call) -> bool:
        f = node.func
        dotted = _dotted(f) or ""
        root = dotted.split(".", 1)[0]
        args_tainted = (any(self._is_tainted(a) for a in node.args)
                        or any(self._is_tainted(kw.value)
                               for kw in node.keywords))
        if isinstance(f, ast.Name) and f.id in _STATIC_RESULT_BUILTINS:
            return False
        if isinstance(f, ast.Name) and f.id in _HOST_SYNC_BUILTINS:
            return False        # flagged separately; result is host-static
        if root == "torch":
            return not _torch_static(dotted)   # torch ops make tensors
        if isinstance(f, ast.Attribute) and (f.attr in _STATIC_ATTRS
                                             or f.attr in _STATIC_METHODS):
            return False
        if isinstance(f, ast.Attribute) and f.attr in _HOST_SYNC_ATTRS:
            return False        # flagged separately; result is on the host
        if isinstance(f, ast.Attribute) and self._is_tainted(f.value):
            return True         # method on a tensor (.where, .gather, ...)
        return args_tainted

    def _is_mask(self, node: ast.AST) -> bool:
        """A boolean mask expression (a comparison, its negation or
        conjunction, a name bound to one)."""
        if isinstance(node, ast.Name):
            return node.id in self.masks
        if isinstance(node, ast.Compare):
            return not all(isinstance(op, (ast.Is, ast.IsNot, ast.In,
                                           ast.NotIn)) for op in node.ops) \
                and self._is_tainted(node)
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
            return self._is_mask(node.operand)
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self._is_mask(node.left) or self._is_mask(node.right)
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute):
            return node.func.attr in _MASK_METHODS and self._is_tainted(node)
        return False

    # --- binding ----------------------------------------------------------

    def _bind(self, target: ast.AST, tainted: bool, mask: bool = False):
        if isinstance(target, ast.Name):
            self.local_names.add(target.id)
            if tainted:
                self.tainted.add(target.id)
            else:
                self.tainted.discard(target.id)
            if mask:
                self.masks.add(target.id)
            else:
                self.masks.discard(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._bind(e, tainted)
        elif isinstance(target, ast.Starred):
            self._bind(target.value, tainted)
        # subscript/attribute targets: handled by mutation rule

    # --- statements -------------------------------------------------------

    def check_function(self, fn: ast.AST):
        static = _static_annotated(fn)
        for p in _func_params(fn):
            self.local_names.add(p)
            if p not in STATIC_PARAM_NAMES and p not in static:
                self.tainted.add(p)
        for stmt in fn.body:
            self.visit(stmt)

    def visit_Assign(self, node: ast.Assign):
        t = self._is_tainted(node.value)
        m = self._is_mask(node.value)
        for target in node.targets:
            if isinstance(target, (ast.Subscript, ast.Attribute)):
                self._check_mutation_target(target, node)
            self._bind(target, t, m)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign):
        if node.value is not None:
            self._bind(node.target, self._is_tainted(node.value),
                       self._is_mask(node.value))
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign):
        t = self._is_tainted(node.value) or self._is_tainted(node.target)
        if isinstance(node.target, (ast.Subscript, ast.Attribute)):
            self._check_mutation_target(node.target, node)
        self._bind(node.target, t)
        self.generic_visit(node)

    def visit_If(self, node: ast.If):
        if self._is_tainted(node.test):
            self._flag("TRC101", "traced-branch", SEV_ERROR, node,
                       "python `if` on a device value — a host sync per "
                       "tick; use torch.where or a mask")
        self.visit(node.test)
        for stmt in node.body:
            self.visit(stmt)
        # `if isinstance(x, torch.Tensor): ... else:` — x is a host value
        # in the else branch, and after the if when its body returns
        narrowed = _tensor_checks(node.test) & self.tainted
        self.tainted -= narrowed
        for stmt in node.orelse:
            self.visit(stmt)
        exits = bool(node.body) and isinstance(node.body[-1],
                                               (ast.Return, ast.Raise))
        if not (exits and not node.orelse):
            self.tainted |= narrowed

    def visit_While(self, node: ast.While):
        if self._is_tainted(node.test):
            self._flag("TRC102", "traced-while", SEV_ERROR, node,
                       "python `while` on a device value — a host sync "
                       "per iteration; loop a static count")
        self.generic_visit(node)

    def visit_Assert(self, node: ast.Assert):
        if self._is_tainted(node.test):
            self._flag("TRC103", "traced-assert", SEV_ERROR, node,
                       "assert on a device value — a host sync per tick; "
                       "use an invariants() lane")
        self.generic_visit(node)

    def visit_For(self, node: ast.For):
        # iterating a tensor unrolls (legal); the target is a tensor. The
        # iterable expression itself still gets the call rules
        # (host-sync/RNG inside `for x in row.tolist()`).
        self.visit(node.iter)
        self._bind(node.target, self._is_tainted(node.iter))
        for stmt in node.body + node.orelse:
            self.visit(stmt)

    def visit_Subscript(self, node: ast.Subscript):
        # TRC106: boolean-mask indexing (load or store) is nonzero()
        idx = node.slice.elts if isinstance(node.slice, ast.Tuple) \
            else [node.slice]
        if self._is_tainted(node.value) and any(self._is_mask(i)
                                                for i in idx):
            self._flag("TRC106", "data-dependent-shape", SEV_WARNING, node,
                       "boolean-mask indexing computes nonzero() — a host "
                       "sync and a value-dependent shape; use torch.where "
                       "or a masked fixed-size update")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        f = node.func
        dotted = _dotted(f) or ""
        parts = dotted.split(".")
        root = parts[0]
        args_tainted = (any(self._is_tainted(a) for a in node.args)
                        or any(self._is_tainted(kw.value)
                               for kw in node.keywords))

        # TRC104: host syncs
        if isinstance(f, ast.Name) and f.id in _HOST_SYNC_BUILTINS \
                and args_tainted:
            self._flag("TRC104", "host-sync", SEV_ERROR, node,
                       f"`{f.id}()` on a device value reads it on the "
                       f"host: the issuing thread waits for the device")
        if isinstance(f, ast.Attribute) and f.attr in _HOST_SYNC_ATTRS \
                and self._is_tainted(f.value):
            self._flag("TRC104", "host-sync", SEV_ERROR, node,
                       f"`.{f.attr}()` on a device value copies it to the "
                       f"host inside the tick")
        if root in _NP_NAMES and len(parts) == 2 \
                and parts[1] in _NP_SYNC_FUNCS and args_tainted:
            self._flag("TRC104", "host-sync", SEV_ERROR, node,
                       f"`{dotted}()` on a device value materializes it "
                       f"on the host — use torch ops inside the tick")

        # TRC106: data-dependent output shapes
        leaf = parts[-1] if dotted else (
            f.attr if isinstance(f, ast.Attribute) else "")
        func_form = root in {"torch"} | _NP_NAMES and len(parts) > 1
        method_form = (isinstance(f, ast.Attribute) and not func_form
                       and self._is_tainted(f.value))
        if (func_form or method_form) and leaf in _DATA_DEP_FUNCS:
            self._flag("TRC106", "data-dependent-shape", SEV_WARNING,
                       node,
                       f"`{dotted or '.' + leaf}` has a value-dependent "
                       f"output shape — a host sync, and not "
                       f"replica-deterministic; use fixed-size masks")
        if func_form and leaf == "where" and len(node.args) == 1 \
                and not node.keywords:
            self._flag("TRC106", "data-dependent-shape", SEV_WARNING,
                       node,
                       "1-arg `where` returns value-dependent shapes "
                       "— use the 3-arg select form")

        # TRC107: draws from a global generator
        if root in _RNG_MODULE_NAMES and "." in dotted:
            self._flag("TRC107", "bare-python-rng", SEV_ERROR, node,
                       f"`{dotted}()` (python RNG) inside the tick is not "
                       f"a pure function of (seed, tick, instance) — "
                       f"draw from rng.py's threefry keys")
        if root in _NP_NAMES and ".random." in "." + dotted + ".":
            self._flag("TRC107", "bare-python-rng", SEV_ERROR, node,
                       f"`{dotted}()` (numpy RNG) inside the tick is not "
                       f"a pure function of (seed, tick, instance) — "
                       f"draw from rng.py's threefry keys")
        if (root == "torch" and len(parts) == 2
                and leaf in _TORCH_RNG_FUNCS) or (
                method_form and leaf in _TORCH_RNG_METHODS):
            self._flag("TRC107", "bare-python-rng", SEV_ERROR, node,
                       f"`{dotted or '.' + leaf}()` draws from torch's "
                       f"global generator — not a pure function of "
                       f"(seed, tick, instance); draw from rng.py's "
                       f"threefry keys")

        # TRC105: mutating a captured container
        if isinstance(f, ast.Attribute) and f.attr in _MUTATING_METHODS:
            self._check_mutation_target(f.value, node, method=f.attr)

        self.generic_visit(node)

    def _check_mutation_target(self, target: ast.AST, node: ast.AST,
                               method: Optional[str] = None):
        """Flag in-place mutation of state captured from outside the
        traced function (enclosing scope, module globals, or self)."""
        root = target
        while isinstance(root, (ast.Subscript, ast.Attribute)):
            root = root.value
        if not isinstance(root, ast.Name):
            return
        name = root.id
        is_self_state = (isinstance(target, ast.Attribute)
                         and name in ("self", "cls"))
        captured = (name not in self.local_names
                    and (name in self.module_mutables
                         or name in self.tainted))
        if is_self_state or captured:
            what = f".{method}()" if method else "assignment"
            self._flag("TRC105", "mutable-capture", SEV_ERROR, node,
                       f"in-place {what} on `{name}` captured from an "
                       f"enclosing scope — the tick must be pure: a "
                       f"CUDA graph replays it without the host side "
                       f"effect")

    def _visit_nested_fn(self, node):
        # nested defs (per-slot bodies) share the enclosing taint env;
        # their params are tensors unless conventionally static
        self.local_names.add(node.name)
        saved = (set(self.tainted), set(self.masks), set(self.local_names))
        static = _static_annotated(node)
        for p in _func_params(node):
            self.local_names.add(p)
            if p not in STATIC_PARAM_NAMES and p not in static:
                self.tainted.add(p)
        for stmt in node.body:
            self.visit(stmt)
        self.tainted, self.masks, self.local_names = saved

    visit_FunctionDef = _visit_nested_fn
    visit_AsyncFunctionDef = _visit_nested_fn

    def visit_Lambda(self, node: ast.Lambda):
        saved = (set(self.tainted), set(self.masks), set(self.local_names))
        for p in _func_params(node):
            self.local_names.add(p)
            if p not in STATIC_PARAM_NAMES:
                self.tainted.add(p)
        self.visit(node.body)
        self.tainted, self.masks, self.local_names = saved

    def visit_ClassDef(self, node: ast.ClassDef):
        pass    # class defs inside traced fns: out of scope

    def visit_Import(self, node):
        for a in node.names:
            self.local_names.add(a.asname or a.name.split(".")[0])

    def visit_ImportFrom(self, node):
        for a in node.names:
            self.local_names.add(a.asname or a.name)


def _module_mutables(tree: ast.Module) -> Set[str]:
    """Module-level names bound to mutable literals (lists/dicts/sets)."""
    out: Set[str] = set()
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and isinstance(
                stmt.value, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                             ast.DictComp, ast.SetComp)):
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
    return out


# the port's counterparts of the JAX pass's traced surfaces
TRACE_TARGET_PATTERNS = (
    "maelstrom_tpu_torch/models/*.py", "maelstrom_tpu_torch/runtime.py",
    "maelstrom_tpu_torch/netsim.py", "maelstrom_tpu_torch/rng.py",
    "maelstrom_tpu_torch/xla_math.py", "maelstrom_tpu_torch/pipeline.py",
    "maelstrom_tpu_torch/decode.py", "maelstrom_tpu_torch/journal.py",
    "maelstrom_tpu_torch/kernels/delivery.py",
    "maelstrom_tpu_torch/telemetry/recorder.py",
    "maelstrom_tpu_torch/telemetry/stream.py",
    "maelstrom_tpu_torch/telemetry/profiler.py",
    "maelstrom_tpu_torch/checkers/triage.py",
    "maelstrom_tpu_torch/checkers/pool.py",
    "maelstrom_tpu_torch/campaign/*.py", "maelstrom_tpu_torch/faults/*.py",
    "maelstrom_tpu_torch/parallel/mesh.py",
    # host-side analysis code whose verdicts gate the executors: keep the
    # analyzers themselves lint-clean, as the JAX pass does
    "maelstrom_tpu_torch/analysis/shard_audit.py",
    "maelstrom_tpu_torch/analysis/aot_audit.py",
)


def default_trace_targets(repo_root: str) -> List[str]:
    """The files the pass reads by default: every model, the tick loop
    and its helpers, the delivery kernel's wrapper, the executors around
    the tick, and the shard and aot analyzers."""
    import glob
    out = []
    for p in TRACE_TARGET_PATTERNS:
        out.extend(sorted(glob.glob(os.path.join(repo_root, p))))
    return [p for p in out if os.path.basename(p) != "__init__.py"
            or "models" not in p]


def lint_sources(sources: Dict[str, str]) -> List[Finding]:
    """Lint a {repo-relative-path: source} mapping (testable core)."""
    findings: List[Finding] = []
    indexes: Dict[str, _FileIndex] = {}
    trees: Dict[str, ast.Module] = {}
    for path, src in sources.items():
        try:
            tree = ast.parse(src, filename=path)
        except SyntaxError as e:
            findings.append(Finding(
                rule="TRC100", name="syntax-error", severity=SEV_ERROR,
                pass_name=PASS_NAME, path=path, line=e.lineno or 0,
                symbol="", message=f"cannot parse: {e.msg}"))
            continue
        trees[path] = tree
        idx = _FileIndex()
        idx.visit(tree)
        indexes[path] = idx

    traced_quals = _traced_qualnames(indexes)

    for path, idx in indexes.items():
        mutables = _module_mutables(trees[path])
        for name, defs in idx.functions.items():
            for qual, node in defs:
                if qual in traced_quals:
                    _TraceChecker(path, qual, mutables,
                                  findings).check_function(node)
                    continue
                # host-side factories (make_tick_fn & co.) wrap the tick
                # in nested defs: check any nested def whose own params
                # look like device values, with a fresh environment
                for sub in ast.walk(node):
                    if sub is node or not isinstance(
                            sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        continue
                    if any(p in TRACED_PARAM_NAMES
                           for p in _func_params(sub)
                           if p not in STATIC_PARAM_NAMES
                           and p not in _static_annotated(sub)):
                        _TraceChecker(path, f"{qual}.{sub.name}", mutables,
                                      findings).check_function(sub)
    # nested-def scanning can visit a doubly-nested body twice — dedupe
    # on (rule, location)
    seen, out = set(), []
    for f in findings:
        k = (f.rule, f.path, f.line)
        if k not in seen:
            seen.add(k)
            out.append(f)
    return out


def run_trace_lint(repo_root: str,
                   paths: Optional[List[str]] = None) -> List[Finding]:
    targets = paths if paths else default_trace_targets(repo_root)
    sources = {}
    findings: List[Finding] = []
    for p in targets:
        ap = p if os.path.isabs(p) else os.path.join(repo_root, p)
        rel = os.path.relpath(ap, repo_root)
        try:
            with open(ap) as f:
                sources[rel] = f.read()
        except OSError as e:
            # surface unreadable targets as findings and keep scanning
            # the rest — one bad path must not hide real hazards
            findings.append(Finding(
                rule="TRC100", name="unreadable-file",
                severity=SEV_ERROR, pass_name=PASS_NAME, path=rel,
                line=0, symbol="", message=str(e)))
    findings.extend(lint_sources(sources))
    return findings
