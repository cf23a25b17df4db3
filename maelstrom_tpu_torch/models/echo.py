"""Vectorized echo: stateless servers answer an ``echo`` request with an
``echo_ok`` carrying the same payload lane.

Counterpart of ``maelstrom_tpu/models/echo.py`` (legacy handle/tick
protocol), batched over a leading node axis.
"""

from __future__ import annotations

import torch

from .. import rng, wire
from ..runtime import EV_INFO, EV_OK, Model, op_rows

TYPE_ECHO = 1
TYPE_ECHO_OK = 2

F_ECHO = 1

_I32 = torch.int32


class EchoModel(Model):
    name = "echo"
    checker_name = "echo"
    body_lanes = 2
    max_out = 1
    tick_out = 0
    idempotent_fs = (F_ECHO,)

    def init_state(self, n_nodes, keys):
        return torch.zeros(keys.shape[:-1], dtype=_I32, device=keys.device)

    def handle(self, row, node_idx, msg, t, keys, cfg, params):
        is_echo = msg[:, wire.TYPE] == TYPE_ECHO
        return row, wire.reply_rows(msg, is_echo, TYPE_ECHO_OK, cfg.lanes,
                                    (msg[:, wire.BODY],))

    # --- client side --------------------------------------------------------

    def sample_op(self, keys, uniq, cfg, params=None):
        return op_rows(F_ECHO, rng.randint(keys, (), 0, 1_000_000))

    def encode_request(self, op, msg_id, client_idx, keys, cfg,
                       params=None):
        dest = rng.randint(keys, (), 0, cfg.n_nodes)
        return wire.make_msg(src=0, dest=dest, type_=TYPE_ECHO,
                             msg_id=msg_id, body=(op[..., 1],),
                             body_lanes=self.body_lanes, netid=cfg.netid,
                             batch_shape=op.shape[:-1], device=op.device)

    def decode_reply(self, op, msg, cfg, params=None):
        ok = msg[..., wire.TYPE] == TYPE_ECHO_OK
        etype = torch.where(ok, EV_OK, EV_INFO).to(_I32)
        # value lanes: (received payload, sent payload, -)
        value = torch.stack([msg[..., wire.BODY], op[..., 1],
                             torch.zeros_like(op[..., 1])], dim=-1)
        return etype, value

    # --- host-side history decoding -----------------------------------------

    def invoke_record(self, f, a, b, c):
        return {"f": "echo", "value": int(a)}

    def complete_record(self, f, a, b, c, etype):
        if etype == EV_OK:
            return {"f": "echo", "value": int(b), "echo": int(a)}
        return {"f": "echo", "value": None}

    def checker(self):
        from ..checkers.echo import echo_checker
        return lambda history, opts: echo_checker(history, opts)
