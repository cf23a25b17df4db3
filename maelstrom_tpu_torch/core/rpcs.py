"""The workloads' RPC declarations, which fill :data:`.schema.REGISTRY`
when this module is imported.

A copy of the ``schema.rpc(...)`` calls that the JAX package's
``maelstrom_tpu/workloads/*.py`` make at import, in the same order
(``workloads/__init__.py``'s), without their host clients and
generators: the port has no host runtime, and the schema lint holds its
models' wire encodings against this registry.
"""

from __future__ import annotations

from . import schema

schema.rpc(
    "broadcast", "topology",
    "A topology message is sent at the start of the test, after initial "
    "setup, and informs the node of an optional network topology: a map of "
    "nodes to neighbors.",
    request={"topology": schema.MapOf(str, [str])},
    response={})

schema.rpc(
    "broadcast", "broadcast",
    "Sends a single message into the broadcast system, and requests that it "
    "be broadcast to everyone. Nodes respond with a simple acknowledgement "
    "message.",
    request={"message": schema.Any},
    response={})

schema.rpc(
    "broadcast", "read",
    "Requests all messages present on a node.",
    request={},
    response={"messages": [schema.Any]})

schema.rpc(
    "echo", "echo",
    "Clients send `echo` messages to servers with an `echo` field containing "
    "an arbitrary payload they'd like to have sent back. Servers should "
    "respond with `echo_ok` messages containing that same payload.",
    request={"echo": schema.Any},
    response={"echo": schema.Any})

schema.rpc(
    "g-set", "add",
    "Requests that a server add a single element to the set.",
    request={"element": schema.Any},
    response={})

schema.rpc(
    "g-set", "read",
    "Requests the current set of all elements. Servers respond with a "
    "message containing an `elements` key, whose `value` is a JSON array of "
    "added elements.",
    request={},
    response={"value": [schema.Any]})

schema.rpc(
    "kafka", "send",
    "Requests that a single message with the given `msg` value be "
    "appended to the log for key `key`. The response includes the "
    "`offset` the message was assigned.",
    request={"key": str, "msg": schema.Any},
    response={"offset": int})

schema.rpc(
    "kafka", "poll",
    "Requests messages from the node. The response `msgs` maps keys to "
    "arrays of [offset, msg] pairs, in ascending offset order, resuming "
    "after the client's previous position for each key.",
    request={schema.Opt("offsets"): schema.MapOf(str, int)},
    response={"msgs": schema.MapOf(str, [[schema.Any]])})

schema.rpc(
    "kafka", "txn",
    "Atomically applies a list of micro-operations: `[\"send\", key, "
    "msg]` appends msg to key's log; `[\"poll\", offsets]` reads each "
    "key from the given offset. Either every send in the transaction "
    "becomes visible or none does. Completed mops are returned with "
    "sends as `[\"send\", key, [offset, msg]]` and polls as "
    "`[\"poll\", {key: [[offset, msg], ...]}]`. Nodes that do not "
    "support transactions reply with error 10 (not supported) and "
    "clients fall back to sequential per-mop RPCs.",
    request={"txn": [[schema.Any]]},
    response={"txn": [[schema.Any]]})

schema.rpc(
    "kafka", "commit_offsets",
    "Informs the node that the client has successfully processed "
    "messages up to and including the given offset for each key.",
    request={"offsets": schema.MapOf(str, int)},
    response={})

schema.rpc(
    "kafka", "list_committed_offsets",
    "Requests the latest committed offsets for the given keys.",
    request={"keys": [str]},
    response={"offsets": schema.MapOf(str, int)})

schema.rpc(
    "lin-kv", "read",
    "Reads the current value of a single key. Clients send a read request "
    "with the key they'd like to observe, and expect a response with the "
    "current value of that key.",
    request={"key": schema.Any},
    response={"value": schema.Any})

schema.rpc(
    "lin-kv", "write",
    "Blindly overwrites the value of a key. Creates keys if they do not "
    "presently exist.",
    request={"key": schema.Any, "value": schema.Any},
    response={})

schema.rpc(
    "lin-kv", "cas",
    "Atomically compare-and-sets a single key: if the value of `key` is "
    "currently `from`, sets it to `to`. Returns error 20 if the key doesn't "
    "exist, and 22 if the `from` value doesn't match.",
    request={"key": schema.Any, "from": schema.Any, "to": schema.Any},
    response={})

for ns in ("pn-counter", "g-counter"):
    schema.rpc(
        ns, "add",
        "Adds a (possibly negative) integer to the counter."
        if ns == "pn-counter" else
        "Adds a non-negative integer to the counter.",
        request={"delta": int},
        response={})
    schema.rpc(
        ns, "read",
        "Reads the current value of the counter.",
        request={},
        response={"value": int})

schema.rpc(
    "txn-list-append", "txn",
    "Requests that the node execute a single transaction: a list of "
    "micro-operations [f, k, v]. `[\"r\", k, null]` reads the list of "
    "elements appended to key k; `[\"append\", k, v]` appends v to key "
    "k. The response contains the same micro-ops with read values "
    "filled in. Transactions are atomic: all micro-ops apply, or none "
    "do (error 30 indicates a conflict abort).",
    request={"txn": [[schema.Any]]},
    response={"txn": [[schema.Any]]})

schema.rpc(
    "txn-rw-register", "txn",
    "Requests that the node execute a single transaction: a list of "
    "micro-operations [f, k, v]. `[\"r\", k, null]` reads the current "
    "value of key k; `[\"w\", k, v]` sets key k to v. The response "
    "contains the same micro-ops with read values filled in. "
    "Transactions are atomic (error 30 indicates a conflict abort).",
    request={"txn": [[schema.Any]]},
    response={"txn": [[schema.Any]]})

schema.rpc(
    "unique-ids", "generate",
    "Asks a node to generate a new ID. Servers respond with a generate_ok "
    "message containing an `id` field, which should be a globally unique "
    "identifier. IDs may be of any type--strings, booleans, integers, "
    "floats, compound JSON values, etc.",
    request={},
    response={"id": schema.Any})
