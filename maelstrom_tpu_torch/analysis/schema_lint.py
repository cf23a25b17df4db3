"""Schema/wire conformance lint: the RPC registry against the wire.

Counterpart of the wire half of ``maelstrom_tpu/analysis/schema_lint.py``.
The ``rpc()`` registry (``core/schema.py``, filled by ``core/rpcs.py``)
is the single source of truth for message vocabularies; this pass
cross-checks it with the places where the port encodes them:

- the error-code registry (``core/errors.py``) against the runtime's
  definite-code table and the literal error codes in the port's
  sources;
- the registered request RPCs of every device-modeled workload against
  its model's int32 wire TYPE constants (``T_*`` / ``TYPE_*``, or a
  ``WIRE_TYPES`` map) and body lanes.

The JAX pass's other half (SCH301-303) reads the demo nodes of the JAX
CLI's ``demo`` matrix; the port has no ``demo`` command or host runtime,
so it is not ported.

Rules (SCH3xx, the wire half):

=======  =====================  ========  ==================================
rule     name                   severity  what it flags
=======  =====================  ========  ==================================
SCH304   unknown-error-code     error     an error code used in code is not
                                          in the core/errors registry; or
                                          the runtime's definite-code table
                                          drifted from the registry
SCH305   no-wire-lane           error     a registered request RPC of a
                                          device-modeled workload has no
                                          int32 wire TYPE (``WIRE_TYPES`` /
                                          ``T_<NAME>`` convention), or its
                                          required scalar fields exceed the
                                          model's body lanes
=======  =====================  ========  ==================================
"""

from __future__ import annotations

import ast
import glob
import os
from typing import Dict, List, Optional, Set

from .findings import Finding, SEV_ERROR

PASS_NAME = "schema"

# workload namespace -> (model workload name, node_count) for the wire
# coverage rule (the JAX pass's TPU_MODELED)
TPU_MODELED = {
    "echo": ("echo", 1),
    "unique-ids": ("unique-ids", 3),
    "broadcast": ("broadcast", 5),
    "g-set": ("g-set", 5),
    "pn-counter": ("pn-counter", 3),
    "g-counter": ("g-counter", 3),
    "lin-kv": ("lin-kv", 5),
    "txn-list-append": ("txn-list-append", 3),
    "txn-rw-register": ("txn-rw-register", 3),
    "kafka": ("kafka", 1),
}

RUNTIME_PATH = "maelstrom_tpu_torch/runtime.py"


def _finding(rule, name, severity, path, line, symbol, message):
    return Finding(rule=rule, name=name, severity=severity,
                   pass_name=PASS_NAME, path=path, line=line,
                   symbol=symbol, message=message)


def _registry():
    """The populated RPC registry (importing ``core.rpcs`` fills it)."""
    from ..core import rpcs  # noqa: F401  (side effect: rpc())
    from ..core.schema import REGISTRY
    return REGISTRY


# --- error codes ------------------------------------------------------------

def check_definite_codes() -> List[Finding]:
    """SCH304a: runtime.py's definite-code table == error registry."""
    from ..core.errors import _ERRORS
    from ..runtime import _DEFINITE_CODES
    registry_definite = tuple(sorted(e.code for e in _ERRORS if e.definite))
    runtime_definite = tuple(sorted(_DEFINITE_CODES))
    if registry_definite != runtime_definite:
        return [_finding(
            "SCH304", "unknown-error-code", SEV_ERROR, RUNTIME_PATH, 0,
            "_DEFINITE_CODES",
            f"runtime definite-error table {runtime_definite} != "
            f"core.errors registry {registry_definite} — fail/info "
            f"verdicts drift from the registry")]
    return []


def check_error_codes(sources: Dict[str, str],
                      valid_codes: Optional[Set[int]] = None
                      ) -> List[Finding]:
    """SCH304b: literal error codes must exist in the registry
    (codes >= 1000 are the documented user range)."""
    if valid_codes is None:
        from ..core.errors import ERRORS_BY_CODE
        valid_codes = set(ERRORS_BY_CODE)
    findings = []
    for rel_path, src in sources.items():
        try:
            tree = ast.parse(src, filename=rel_path)
        except SyntaxError:
            continue    # the trace pass reports parse errors already
        for node in ast.walk(tree):
            code = None
            if isinstance(node, ast.Call):
                f = node.func
                name = f.id if isinstance(f, ast.Name) else (
                    f.attr if isinstance(f, ast.Attribute) else "")
                if name == "RPCError" and node.args and \
                        isinstance(node.args[0], ast.Constant) and \
                        isinstance(node.args[0].value, int):
                    code = node.args[0].value
            elif isinstance(node, ast.Dict):
                for k, v in zip(node.keys, node.values):
                    if isinstance(k, ast.Constant) and k.value == "code" \
                            and isinstance(v, ast.Constant) \
                            and isinstance(v.value, int):
                        code = v.value
            if code is not None and code not in valid_codes \
                    and code < 1000:
                findings.append(_finding(
                    "SCH304", "unknown-error-code", SEV_ERROR, rel_path,
                    node.lineno, "",
                    f"error code {code} is not in the core/errors.py "
                    f"registry (user codes start at 1000) — checkers "
                    f"will misclassify its definiteness"))
    return findings


# --- wire coverage ----------------------------------------------------------

def _scalar_required_fields(rpcdef) -> List[str]:
    from ..core import schema as S
    out = []
    for k, v in rpcdef.request.items():
        if k is Ellipsis or isinstance(k, S.Opt):
            continue
        if isinstance(v, (list, dict, S.MapOf)):
            continue    # structured payloads have bespoke encodings
        out.append(k)
    return out


def check_wire_coverage(registry=None) -> List[Finding]:
    """SCH305: every registered request RPC of a device-modeled workload
    resolves to a wire TYPE constant, and its required scalar fields fit
    the model's body lanes."""
    import importlib
    from ..models import get_model

    registry = registry if registry is not None else _registry()
    findings: List[Finding] = []
    for ns, (workload, n) in sorted(TPU_MODELED.items()):
        if ns not in registry:
            findings.append(_finding(
                "SCH305", "no-wire-lane", SEV_ERROR,
                "maelstrom_tpu_torch/core/rpcs.py", 0, ns,
                f"workload {ns!r} has a device model but no registered "
                f"RPCs — the registry is blind to it"))
            continue
        model = get_model(workload, n, "grid")
        mod = importlib.import_module(type(model).__module__)
        path = type(model).__module__.replace(".", os.sep) + ".py"
        wire_types = getattr(model, "WIRE_TYPES", None)
        for name, d in registry[ns].items():
            if wire_types is not None and name in wire_types:
                continue    # explicit map (None = declared lane-free)
            const = name.upper().replace("-", "_")
            if hasattr(mod, f"T_{const}") or hasattr(mod, f"TYPE_{const}"):
                continue
            findings.append(_finding(
                "SCH305", "no-wire-lane", SEV_ERROR, path, 0,
                type(model).__name__,
                f"registered RPC {ns}/{name} has no wire TYPE "
                f"(expected T_{const}/TYPE_{const} or a WIRE_TYPES "
                f"entry) — the device runtime cannot carry it"))
        for name, d in registry[ns].items():
            fields = _scalar_required_fields(d)
            if len(fields) > model.body_lanes:
                findings.append(_finding(
                    "SCH305", "no-wire-lane", SEV_ERROR, path, 0,
                    type(model).__name__,
                    f"RPC {ns}/{name} needs {len(fields)} scalar "
                    f"request lanes {fields} but the model declares "
                    f"body_lanes={model.body_lanes}"))
    return findings


# --- orchestration ----------------------------------------------------------

def run_schema_lint(repo_root: str = ".") -> List[Finding]:
    registry = _registry()
    findings: List[Finding] = []
    # error codes: the whole port
    sources = {}
    for p in glob.glob(os.path.join(repo_root, "maelstrom_tpu_torch",
                                    "**", "*.py"), recursive=True):
        rel = os.path.relpath(p, repo_root)
        with open(p) as f:
            sources[rel] = f.read()
    findings.extend(check_error_codes(sources))
    findings.extend(check_definite_codes())
    findings.extend(check_wire_coverage(registry))
    return findings
