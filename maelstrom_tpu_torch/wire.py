"""Fixed-width message rows: the lane layout of the simulated network.

Counterpart of ``maelstrom_tpu/tpu/wire.py``. A message is one int32 row
of ``lanes(body_lanes)`` lanes: an 8-lane header and the model's body
lanes. (The JAX format's trailing NETID lane exists only for
per-message journals, which the port does not record yet.)

====  ===========================================================
lane  meaning
====  ===========================================================
0     valid (0/1)
1     src   (logical sender: node index; clients follow server nodes)
2     dest
3     deliver_tick (virtual-clock deadline)
4     type  (workload-specific enum)
5     msg_id
6     in_reply_to (-1 if none)
7     origin (physical sender; latency and partitions key on it)
8+    body lanes
====  ===========================================================
"""

from __future__ import annotations

import torch

VALID = 0
SRC = 1
DEST = 2
DTICK = 3
TYPE = 4
MSGID = 5
REPLYTO = 6
ORIGIN = 7
BODY = 8          # first body lane

HDR_LANES = 8


def lanes(body_lanes: int) -> int:
    """Row width of the wire format: 8 header + body lanes."""
    return HDR_LANES + body_lanes


def make_msg(src, dest, type_, msg_id=-1, reply_to=-1, body=(),
             body_lanes: int = 6, origin=None, batch_shape=(),
             device=None) -> torch.Tensor:
    """Build message rows ``[*batch_shape, lanes]``. Every field is a
    Python int or an int tensor broadcastable to ``batch_shape``;
    ``origin`` defaults to ``src``. A body wider than ``body_lanes`` is
    refused: its writes would run past the row end."""
    if len(body) > body_lanes:
        raise ValueError(
            f"make_msg: body has {len(body)} values but the wire "
            f"format carries body_lanes={body_lanes}; widen the model's "
            f"body_lanes or shrink the body")
    m = torch.zeros(tuple(batch_shape) + (lanes(body_lanes),),
                    dtype=torch.int32, device=device)
    m[..., VALID] = 1
    m[..., SRC] = src
    m[..., DEST] = dest
    m[..., TYPE] = type_
    m[..., MSGID] = msg_id
    m[..., REPLYTO] = reply_to
    m[..., ORIGIN] = src if origin is None else origin
    for i, b in enumerate(body):
        m[..., BODY + i] = b
    return m


def reply_rows(msg: torch.Tensor, valid: torch.Tensor, type_, lanes_: int,
               body=()) -> torch.Tensor:
    """One reply row per request row ``msg [B, L]``, as ``[B, 1, lanes]``:
    VALID from ``valid``, DEST the request's SRC, REPLYTO its MSGID,
    and ``type_`` and the body lanes (ints or ``[B]`` tensors). SRC and
    ORIGIN stay 0 for the runtime's stamp."""
    out = torch.zeros((msg.shape[0], 1, lanes_), dtype=torch.int32,
                      device=msg.device)
    out[:, 0, VALID] = valid.to(torch.int32)
    out[:, 0, DEST] = msg[:, SRC]
    out[:, 0, TYPE] = type_
    out[:, 0, REPLYTO] = msg[:, MSGID]
    for i, b in enumerate(body):
        out[:, 0, BODY + i] = b
    return out

