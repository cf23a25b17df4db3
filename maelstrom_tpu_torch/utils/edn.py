"""A minimal EDN writer: the forensics bundle's ``journal.edn``.

Copy of the writer of ``maelstrom_tpu/utils/edn.py`` (maps, vectors,
keywords, strings, ints, floats, nil, booleans), so the journal reads
like a reference ``net/journal.clj`` stream in Clojure tooling.
"""

from __future__ import annotations

from typing import Any, List


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
