"""Vectorized unique-ids: flake-style ids ``node_idx << 25 | counter``,
unique without coordination.

Counterpart of ``maelstrom_tpu/models/unique_ids.py`` (legacy
handle/tick protocol), batched over a leading node axis. The split
keeps 6 bits of node id (up to 63 nodes) and 25 bits of per-node
counter, in int32.
"""

from __future__ import annotations

import torch

from .. import rng, wire
from ..runtime import EV_INFO, EV_OK, Model, op_rows

TYPE_GEN = 1
TYPE_GEN_OK = 2

F_GENERATE = 1

_I32 = torch.int32


class UniqueIdsModel(Model):
    name = "unique-ids"
    checker_name = "unique-ids"
    body_lanes = 1
    max_out = 1
    tick_out = 0
    idempotent_fs = ()
    flake_counter_bits = 25
    WIRE_TYPES = {"generate": TYPE_GEN}

    def init_state(self, n_nodes, keys):
        # the per-node counter
        return torch.zeros(keys.shape[:-1], dtype=_I32, device=keys.device)

    def handle(self, row, node_idx, msg, t, keys, cfg, params):
        is_gen = msg[:, wire.TYPE] == TYPE_GEN
        row = torch.where(is_gen, row + 1, row)
        ident = node_idx * (1 << self.flake_counter_bits) + row
        return row, wire.reply_rows(msg, is_gen, TYPE_GEN_OK, cfg.lanes,
                                    (ident,))

    # --- client side --------------------------------------------------------

    def sample_op(self, keys, uniq, cfg, params=None):
        return op_rows(F_GENERATE, torch.zeros_like(uniq))

    def encode_request(self, op, msg_id, client_idx, keys, cfg,
                       params=None):
        dest = rng.randint(keys, (), 0, cfg.n_nodes)
        return wire.make_msg(src=0, dest=dest, type_=TYPE_GEN,
                             msg_id=msg_id, body_lanes=self.body_lanes,
                             netid=cfg.netid,
                             batch_shape=op.shape[:-1], device=op.device)

    def decode_reply(self, op, msg, cfg, params=None):
        ok = msg[..., wire.TYPE] == TYPE_GEN_OK
        etype = torch.where(ok, EV_OK, EV_INFO).to(_I32)
        z = torch.zeros_like(op[..., 0])
        return etype, torch.stack([msg[..., wire.BODY], z, z], dim=-1)

    # --- host-side history decoding -----------------------------------------

    def invoke_record(self, f, a, b, c):
        return {"f": "generate", "value": None}

    def complete_record(self, f, a, b, c, etype):
        return {"f": "generate", "value": int(a) if etype == EV_OK
                else None}

    def checker(self):
        from ..checkers.unique_ids import unique_ids_checker
        return lambda history, opts: unique_ids_checker(history)
