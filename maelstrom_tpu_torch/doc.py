"""Documentation generator: renders workload and protocol docs from the
RPC schema registry and error catalog, so schema drift shows up as a docs
diff.

A copy of ``maelstrom_tpu/doc.py`` over the port's ``core.schema``
registry (filled by the port's ``workloads/``) and ``core.errors``: the
files it writes are byte-equal to the JAX package's. Parity: reference
src/maelstrom/doc.clj (workloads.md from the defrpc registry grouped by
namespace :23-64, protocol.md with the error table :66-96), wired to
the CLI ``doc`` command.
"""

from __future__ import annotations

import os

from .core import schema
from .core.errors import ERRORS_BY_CODE

PROTOCOL_INTRO = """\
# Protocol

Nodes and the framework communicate by sending messages: JSON objects
with `src`, `dest`, and `body` fields, exchanged as newline-delimited
JSON over STDIN/STDOUT in the process runtime, and as fixed-width int32
lane encodings in the TPU runtime.

A message body has a `type`, usually a `msg_id` (unique per sender), and
replies carry `in_reply_to` echoing the request's `msg_id`. Nodes receive
an `init` message first:

```json
{"type": "init", "msg_id": 1, "node_id": "n3",
 "node_ids": ["n1", "n2", "n3"]}
```

and must answer with `init_ok`. Errors are bodies of type `error` with a
numeric `code` and free-form `text`; codes below 1000 are reserved for
the framework, and each code is either *definite* (the op certainly did
not happen) or *indefinite* (outcome unknown).
"""


def workloads_md() -> str:
    out = ["# Workloads", "",
           "RPC vocabulary per workload, generated from the schema "
           "registry (single source of truth for validation, docs, and "
           "the TPU runtime's lane encodings).", ""]
    for namespace in sorted(schema.REGISTRY):
        out.append(f"## {namespace}")
        out.append("")
        for name, d in schema.REGISTRY[namespace].items():
            out.append(f"### {name}")
            out.append("")
            out.append(d.doc)
            out.append("")
            out.append("Request:")
            out.append("```")
            out.append(schema.render(d.full_request_schema()))
            out.append("```")
            out.append(f"Response ({d.response_type}):")
            out.append("```")
            out.append(schema.render(d.full_response_schema()))
            out.append("```")
            out.append("")
    return "\n".join(out)


def protocol_md() -> str:
    out = [PROTOCOL_INTRO, "", "## Errors", "",
           "| Code | Name | Definite | Description |",
           "|------|------|----------|-------------|"]
    for e in sorted(ERRORS_BY_CODE.values(), key=lambda e: e.code):
        out.append(f"| {e.code} | {e.name} | "
                   f"{'yes' if e.definite else 'no'} | {e.doc} |")
    out.append("")
    return "\n".join(out)


def write_docs(doc_dir: str = "doc"):
    """Regenerate doc/workloads.md and doc/protocol.md."""
    # import every workload module so all RPCs are registered
    from . import workloads  # noqa: F401
    os.makedirs(doc_dir, exist_ok=True)
    with open(os.path.join(doc_dir, "workloads.md"), "w") as f:
        f.write(workloads_md())
    with open(os.path.join(doc_dir, "protocol.md"), "w") as f:
        f.write(protocol_md())
    return [os.path.join(doc_dir, "workloads.md"),
            os.path.join(doc_dir, "protocol.md")]
