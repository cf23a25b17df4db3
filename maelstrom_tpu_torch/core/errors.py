"""Protocol error catalog (a copy of ``maelstrom_tpu/core/errors.py``:
the port imports nothing of the JAX package).

The wire protocol defines a fixed set of numeric error codes carried in
``{"type": "error", "code": <int>, "text": <str>}`` bodies. Each code is either
*definite* (the requested operation certainly did not happen) or *indefinite*
(the outcome is unknown — e.g. a timeout). Checkers rely on this distinction:
a definite error maps a client op to ``fail``, an indefinite one to ``info``.

Parity: reference resources/errors.edn:1-44 and
src/maelstrom/client.clj:22-39 (error registry + exception mapping).
Codes >= 1000 are reserved for user-defined errors and treated as definite
unless declared otherwise (reference resources/protocol-intro.md:133-135).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ErrorDef:
    code: int
    name: str
    definite: bool
    doc: str


_ERRORS = [
    ErrorDef(0, "timeout", False,
             "Indicates that the requested operation could not be completed "
             "within a timeout."),
    ErrorDef(1, "node-not-found", True,
             "Thrown when a client sends an RPC request to a node which does "
             "not exist."),
    ErrorDef(10, "not-supported", True,
             "Use this error to indicate that a requested operation is not "
             "supported by the current implementation."),
    ErrorDef(11, "temporarily-unavailable", True,
             "Indicates that the operation definitely cannot be performed at "
             "this time -- perhaps because the server is in a read-only "
             "state, has not yet been initialized, believes its peers to be "
             "down, and so on."),
    ErrorDef(12, "malformed-request", True,
             "The client's request did not conform to the server's "
             "expectations, and could not possibly have been processed."),
    ErrorDef(13, "crash", False,
             "Indicates that some kind of general, indefinite error "
             "occurred."),
    ErrorDef(14, "abort", True,
             "Indicates that some kind of general, definite error occurred."),
    ErrorDef(20, "key-does-not-exist", True,
             "The client requested an operation on a key which does not "
             "exist (assuming the operation should not automatically create "
             "missing keys)."),
    ErrorDef(21, "key-already-exists", True,
             "The client requested the creation of a key which already "
             "exists, and the server will not overwrite it."),
    ErrorDef(22, "precondition-failed", True,
             "The requested operation expected some conditions to hold, and "
             "those conditions were not met."),
    ErrorDef(30, "txn-conflict", True,
             "The requested transaction has been aborted because of a "
             "conflict with another transaction."),
]

ERRORS_BY_CODE = {e.code: e for e in _ERRORS}
ERRORS_BY_NAME = {e.name: e for e in _ERRORS}


def definite(code: int) -> bool:
    """Is this error code definite? Unknown (user) codes default to definite."""
    e = ERRORS_BY_CODE.get(code)
    return e.definite if e is not None else True


class RPCError(Exception):
    """An ``error`` body received in reply to an RPC request."""

    def __init__(self, code: int, text: str = ""):
        self.code = code
        self.text = text
        e = ERRORS_BY_CODE.get(code)
        self.name = e.name if e else f"error-{code}"
        self.definite = definite(code)
        super().__init__(f"RPC error {code} ({self.name}): {text}")

    def to_body(self, in_reply_to=None) -> dict:
        body = {"type": "error", "code": self.code, "text": self.text}
        if in_reply_to is not None:
            body["in_reply_to"] = in_reply_to
        return body


def timeout(text="timed out") -> RPCError:
    return RPCError(0, text)


def node_not_found(text) -> RPCError:
    return RPCError(1, text)


def not_supported(text) -> RPCError:
    return RPCError(10, text)


def temporarily_unavailable(text) -> RPCError:
    return RPCError(11, text)


def malformed_request(text) -> RPCError:
    return RPCError(12, text)


def crash(text) -> RPCError:
    return RPCError(13, text)


def abort(text) -> RPCError:
    return RPCError(14, text)


def key_does_not_exist(text) -> RPCError:
    return RPCError(20, text)


def key_already_exists(text) -> RPCError:
    return RPCError(21, text)


def precondition_failed(text) -> RPCError:
    return RPCError(22, text)


def txn_conflict(text) -> RPCError:
    return RPCError(30, text)
