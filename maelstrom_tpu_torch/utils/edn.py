"""A minimal EDN writer and reader: ``journal.edn`` and ``export``.

Copy of ``maelstrom_tpu/utils/edn.py``: the writer (maps, vectors,
keywords, strings, ints, floats, nil, booleans), the reader of that
subset (for round trips; no tagged literals, sets or chars), and the
history conversion to Jepsen's op maps, so a forensics journal reads
like a reference ``net/journal.clj`` stream and an exported history is
what stock Elle or Knossos consumes (``{:process 7, :type :invoke, :f
:txn, :value [[:append 4 1] [:r 5 nil]], :index 0, :time 168390535}``).
"""

from __future__ import annotations

import re
from typing import Any, Iterator, List, Tuple


class Keyword(str):
    """An EDN keyword (``:foo``). Subclasses str so existing code that
    compares against plain strings keeps working after a round-trip."""

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f":{str.__str__(self)}"


def _dump(x: Any, out: List[str]) -> None:
    if isinstance(x, Keyword):
        out.append(":" + str.__str__(x))
    elif x is None:
        out.append("nil")
    elif x is True:
        out.append("true")
    elif x is False:
        out.append("false")
    elif isinstance(x, str):
        out.append('"' + x.replace("\\", "\\\\").replace('"', '\\"')
                   .replace("\n", "\\n").replace("\t", "\\t")
                   .replace("\r", "\\r") + '"')
    elif isinstance(x, int):
        out.append(repr(x))
    elif isinstance(x, float):
        # repr would emit 'inf'/'nan', which are not EDN tokens; the
        # reader-macro forms are the portable spelling
        if x != x:
            out.append("##NaN")
        elif x == float("inf"):
            out.append("##Inf")
        elif x == float("-inf"):
            out.append("##-Inf")
        else:
            out.append(repr(x))
    elif isinstance(x, dict):
        out.append("{")
        first = True
        for k, v in x.items():
            if not first:
                out.append(", ")
            first = False
            _dump(k, out)
            out.append(" ")
            _dump(v, out)
        out.append("}")
    elif isinstance(x, (list, tuple)):
        out.append("[")
        for i, v in enumerate(x):
            if i:
                out.append(" ")
            _dump(v, out)
        out.append("]")
    else:
        raise TypeError(f"cannot EDN-serialize {type(x).__name__}: {x!r}")


def dumps(x: Any) -> str:
    out: List[str] = []
    _dump(x, out)
    return "".join(out)


# --- reader (writer-subset EDN) -------------------------------------------

_WS = " \t\n\r,"            # comma is whitespace in EDN
_DELIM = _WS + "{}[]()\""


def _skip_ws(s: str, i: int) -> int:
    while i < len(s) and s[i] in _WS:
        i += 1
    return i


def _parse(s: str, i: int) -> Tuple[Any, int]:
    i = _skip_ws(s, i)
    if i >= len(s):
        raise ValueError("unexpected end of EDN input")
    c = s[i]
    if c == "{":
        i += 1
        m = {}
        while True:
            i = _skip_ws(s, i)
            if i >= len(s):
                raise ValueError("unterminated map")
            if s[i] == "}":
                return m, i + 1
            k, i = _parse(s, i)
            v, i = _parse(s, i)
            m[k] = v
    if c == "[":
        i += 1
        vec = []
        while True:
            i = _skip_ws(s, i)
            if i >= len(s):
                raise ValueError("unterminated vector")
            if s[i] == "]":
                return vec, i + 1
            v, i = _parse(s, i)
            vec.append(v)
    if c == '"':
        i += 1
        buf = []
        while i < len(s):
            ch = s[i]
            if ch == "\\":
                nxt = s[i + 1]
                buf.append({"n": "\n", "t": "\t", "r": "\r",
                            '"': '"', "\\": "\\"}.get(nxt, nxt))
                i += 2
            elif ch == '"':
                return "".join(buf), i + 1
            else:
                buf.append(ch)
                i += 1
        raise ValueError("unterminated string")
    if c == ":":
        j = i + 1
        while j < len(s) and s[j] not in _DELIM:
            j += 1
        return Keyword(s[i + 1:j]), j
    if c == "#" and s[i:i + 2] == "##":
        j = i + 2
        while j < len(s) and s[j] not in _DELIM:
            j += 1
        tok = s[i + 2:j]
        try:
            return {"Inf": float("inf"), "-Inf": float("-inf"),
                    "NaN": float("nan")}[tok], j
        except KeyError:
            raise ValueError(f"unknown EDN symbolic value ##{tok}")
    # symbol-ish atom: nil / true / false / number
    j = i
    while j < len(s) and s[j] not in _DELIM:
        j += 1
    tok = s[i:j]
    if tok == "nil":
        return None, j
    if tok == "true":
        return True, j
    if tok == "false":
        return False, j
    try:
        return int(tok), j
    except ValueError:
        pass
    try:
        return float(tok), j
    except ValueError:
        raise ValueError(f"unparseable EDN token {tok!r} at offset {i}")


def loads(s: str) -> Any:
    v, i = _parse(s, 0)
    if _skip_ws(s, i) != len(s):
        raise ValueError(f"trailing EDN content at offset {i}")
    return v


# --- history conversion ---------------------------------------------------

# workloads whose :value is a vector of [f k v] micro-op vectors whose
# first element Jepsen/Elle expects as a keyword (:append/:r/:w,
# kafka's :send/:poll)
_MOP_WORKLOADS = ("txn-list-append", "txn-rw-register", "kafka")

# strings that are legal as EDN keyword names (subset of the spec's
# symbol charset — enough for every error slug this codebase emits)
_KW_SAFE = re.compile(r"^[A-Za-z*+!_?<>=.-][A-Za-z0-9*+!_?<>=.-]*$")


def op_to_edn_map(op: dict, workload: str) -> dict:
    """One JSONL history record -> Jepsen EDN op map (Python form:
    Keyword keys/values where Jepsen uses keywords)."""
    out = {}
    mops = workload.split("-bug-")[0] in _MOP_WORKLOADS
    for k, v in op.items():
        key = Keyword(k)
        if k in ("type", "f") and isinstance(v, str):
            # only strings keywordize — a null f must stay nil, not
            # become the nonsense keyword :None
            out[key] = Keyword(v)
        elif k == "error":
            # Jepsen spells error tags as keywords: :net-timeout, or
            # [:precondition-failed "msg"] — tag keywordized, text kept.
            # Only token-safe strings keywordize; prose ("timed out")
            # would be syntactically invalid as a keyword.
            if isinstance(v, str) and _KW_SAFE.match(v):
                out[key] = Keyword(v)
            elif isinstance(v, list) and v and isinstance(v[0], str) \
                    and _KW_SAFE.match(v[0]):
                out[key] = [Keyword(v[0])] + list(v[1:])
            else:
                out[key] = v
        elif k == "value" and mops and isinstance(v, list):
            out[key] = [[Keyword(m[0])] + list(m[1:])
                        if isinstance(m, list) and m
                        and isinstance(m[0], str) else m
                        for m in v]
        else:
            out[key] = v
    return out


def edn_map_to_op(m: dict) -> dict:
    """Inverse of :func:`op_to_edn_map`: EDN op map -> plain-JSON form."""
    out = {}
    for k, v in m.items():
        key = str.__str__(k) if isinstance(k, Keyword) else k
        if key in ("type", "f"):
            out[key] = str.__str__(v) if isinstance(v, Keyword) else v
        elif key == "error":
            if isinstance(v, Keyword):
                out[key] = str.__str__(v)
            elif isinstance(v, list) and v and isinstance(v[0], Keyword):
                out[key] = [str.__str__(v[0])] + list(v[1:])
            else:
                out[key] = v
        elif key == "value" and isinstance(v, list):
            out[key] = [[str.__str__(e[0])] + list(e[1:])
                        if isinstance(e, list) and e
                        and isinstance(e[0], Keyword) else e
                        for e in v]
        else:
            out[key] = v
    return out


def history_to_edn_lines(records, workload: str) -> Iterator[str]:
    for op in records:
        yield dumps(op_to_edn_map(op, workload))


def history_to_edn_vector_lines(records, workload: str) -> Iterator[str]:
    """Jepsen's ``store/<test>/history.edn`` is a single EDN vector of op
    maps — a stock ``read-string`` of a line-delimited export would see
    only the first op. This form wraps the ops in ``[`` … ``]`` (one map
    per line, so it stays diffable/grep-able) and is drop-in for JVM
    tooling that slurps the whole file."""
    yield "["
    for op in records:
        yield dumps(op_to_edn_map(op, workload))
    yield "]"
