"""Schema system + RPC registry — the single source of truth for message
vocabularies (a copy of ``maelstrom_tpu/core/schema.py``: the port
imports nothing of the JAX package; ``core/rpcs.py`` fills the
registry).

Every workload declares its RPCs with :func:`rpc`: a name, a docstring, and
request/response schemas. The registry drives (a) runtime validation of
requests and responses at the client boundary, (b) generated protocol docs,
and (c) the fixed-width payload encodings used by the TPU runtime.

Parity: reference src/maelstrom/client.clj:228-270 (defrpc macro + registry),
src/maelstrom/doc.clj (doc generation from the registry).

Schemas are intentionally tiny — just enough to validate JSON bodies and to
render readable docs. A schema is one of:

- a python type: ``int``, ``str``, ``bool``, ``float`` (accepts int too)
- ``Any`` — anything
- ``[elem]`` — list with homogeneous element schema
- ``{key: schema, ...}`` with string keys; wrap a key in :class:`Opt` to mark
  it optional; an ``Ellipsis`` key allows arbitrary extra entries
- :class:`MapOf`\\ (key_schema, val_schema) — homogeneous dict
- :class:`Enum`\\ (*values) — one of the literal values
- :class:`OneOf`\\ (*schemas) — union
- ``None`` — JSON null only
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any as TAny, Dict, List, Optional


class _AnyType:
    def __repr__(self):
        return "Any"


Any = _AnyType()


class Opt:
    """Marks a dict key as optional."""

    def __init__(self, key: str):
        self.key = key

    def __repr__(self):
        return f"Opt({self.key!r})"

    def __hash__(self):
        return hash(("Opt", self.key))

    def __eq__(self, other):
        return isinstance(other, Opt) and other.key == self.key


class MapOf:
    def __init__(self, key_schema, val_schema):
        self.key_schema = key_schema
        self.val_schema = val_schema

    def __repr__(self):
        return f"MapOf({render(self.key_schema)}, {render(self.val_schema)})"


class Enum:
    def __init__(self, *values):
        self.values = values

    def __repr__(self):
        return "Enum(" + ", ".join(map(repr, self.values)) + ")"


class OneOf:
    def __init__(self, *schemas):
        self.schemas = schemas

    def __repr__(self):
        return "OneOf(" + ", ".join(render(s) for s in self.schemas) + ")"


class SchemaError(ValueError):
    pass


def check(schema, value, path="value"):
    """Validate value against schema; raises SchemaError with a path."""
    if schema is Any:
        return
    if schema is None:
        if value is not None:
            raise SchemaError(f"{path}: expected null, got {value!r}")
        return
    if schema is int:
        if not isinstance(value, int) or isinstance(value, bool):
            raise SchemaError(f"{path}: expected an integer, got {value!r}")
        return
    if schema is float:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise SchemaError(f"{path}: expected a number, got {value!r}")
        return
    if schema is str:
        if not isinstance(value, str):
            raise SchemaError(f"{path}: expected a string, got {value!r}")
        return
    if schema is bool:
        if not isinstance(value, bool):
            raise SchemaError(f"{path}: expected a boolean, got {value!r}")
        return
    if isinstance(schema, Enum):
        if value not in schema.values:
            raise SchemaError(
                f"{path}: expected one of {schema.values!r}, got {value!r}")
        return
    if isinstance(schema, OneOf):
        errs = []
        for s in schema.schemas:
            try:
                check(s, value, path)
                return
            except SchemaError as e:
                errs.append(str(e))
        raise SchemaError(f"{path}: no alternative matched {value!r}: "
                          + "; ".join(errs))
    if isinstance(schema, MapOf):
        if not isinstance(value, dict):
            raise SchemaError(f"{path}: expected a map, got {value!r}")
        for k, v in value.items():
            check(schema.key_schema, k, f"{path} key {k!r}")
            check(schema.val_schema, v, f"{path}[{k!r}]")
        return
    if isinstance(schema, list):
        if len(schema) != 1:
            # tuple-style positional schema
            if not isinstance(value, list) or len(value) != len(schema):
                raise SchemaError(
                    f"{path}: expected a {len(schema)}-element list, got "
                    f"{value!r}")
            for i, (s, v) in enumerate(zip(schema, value)):
                check(s, v, f"{path}[{i}]")
            return
        if not isinstance(value, list):
            raise SchemaError(f"{path}: expected a list, got {value!r}")
        for i, v in enumerate(value):
            check(schema[0], v, f"{path}[{i}]")
        return
    if isinstance(schema, dict):
        if not isinstance(value, dict):
            raise SchemaError(f"{path}: expected a map, got {value!r}")
        open_map = any(k is Ellipsis for k in schema)
        known = set()
        for k, vschema in schema.items():
            if k is Ellipsis:
                continue
            optional = isinstance(k, Opt)
            key = k.key if optional else k
            known.add(key)
            if key not in value:
                if not optional:
                    raise SchemaError(f"{path}: missing required key {key!r} "
                                      f"in {value!r}")
                continue
            check(vschema, value[key], f"{path}[{key!r}]")
        if not open_map:
            extra = set(value) - known
            if extra:
                raise SchemaError(
                    f"{path}: unexpected keys {sorted(extra)!r} in {value!r}")
        return
    raise SchemaError(f"{path}: unknown schema {schema!r}")


def valid(schema, value) -> bool:
    try:
        check(schema, value)
        return True
    except SchemaError:
        return False


def render(schema) -> str:
    """Human-readable schema rendering for docs."""
    if schema is Any:
        return "any"
    if schema is None:
        return "null"
    if schema is int:
        return "Int"
    if schema is float:
        return "Number"
    if schema is str:
        return "String"
    if schema is bool:
        return "Bool"
    if isinstance(schema, (Enum, OneOf, MapOf)):
        return repr(schema)
    if isinstance(schema, list):
        return "[" + ", ".join(render(s) for s in schema) + "]"
    if isinstance(schema, dict):
        parts = []
        for k, v in schema.items():
            if k is Ellipsis:
                parts.append("...")
            elif isinstance(k, Opt):
                parts.append(f"{k.key}?: {render(v)}")
            else:
                parts.append(f"{k}: {render(v)}")
        return "{" + ", ".join(parts) + "}"
    return repr(schema)


# --- RPC registry ----------------------------------------------------------

@dataclass
class RPCDef:
    namespace: str               # workload/service name, e.g. "broadcast"
    name: str                    # message type, e.g. "broadcast"
    doc: str
    request: dict
    response: dict
    response_type: str = ""

    def full_request_schema(self) -> dict:
        s = {"type": Enum(self.name), Opt("msg_id"): int, Ellipsis: Any}
        s.update(self.request)
        return s

    def full_response_schema(self) -> dict:
        s = {"type": Enum(self.response_type),
             Opt("msg_id"): int, Opt("in_reply_to"): int, Ellipsis: Any}
        s.update(self.response)
        return s


# namespace -> name -> RPCDef, insertion-ordered for stable docs
REGISTRY: Dict[str, Dict[str, RPCDef]] = {}


def rpc(namespace: str, name: str, doc: str, request: dict, response: dict,
        response_type: Optional[str] = None) -> RPCDef:
    """Declare an RPC: registers it and returns the definition.

    ``request``/``response`` are body schemas *excluding* the envelope fields
    (type / msg_id / in_reply_to), which are added automatically.
    """
    d = RPCDef(namespace=namespace, name=name, doc=doc, request=request,
               response=response,
               response_type=response_type or (name + "_ok"))
    REGISTRY.setdefault(namespace, {})[name] = d
    return d


def get_rpc(namespace: str, name: str) -> Optional[RPCDef]:
    return REGISTRY.get(namespace, {}).get(name)
