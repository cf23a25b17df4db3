"""Vectorized kafka: keyed append-only logs in fixed slots, batched.

Counterpart of ``maelstrom_tpu/models/kafka.py`` (legacy handle/tick
protocol): send / send_ok{offset}, poll / poll_ok{msgs},
commit_offsets, list_committed_offsets against a single-node log. Per
node, per-key logs live in ``[n_keys, log_cap]`` value slots, and the
broker holds each client's consumer cursor (clients are stateless rows),
so a client's polls stay monotonic as the checker verifies.

Fixed-shape encodings: a poll returns up to ``poll_max`` messages of
every key (``n_keys * poll_max * 2`` body lanes of ``[offset+1,
value]`` pairs, 0 = absent); commit and list replies carry ``n_keys``
offset+1 lanes.

``crash_clients``: clients randomly send crash ops; the broker re-seats
the crashed client's cursor at the committed offsets, so its next poll
may legally jump backwards (the checker marks it reassigned).

Mutants: :class:`KafkaOffsetReuse` hands out the same offset twice (a
non-atomic fetch-and-add); :class:`KafkaCommitRegression` lets a commit
overwrite instead of taking the maximum.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import rng, wire, xla_math
from ..checkers import device_summary as ds
from ..runtime import EV_INFO, EV_OK, TYPE_ERROR, Model
from .raft_core import sel, set_drop, tget

F_SEND = 1
F_POLL = 2
F_COMMIT = 3
F_LIST = 4
F_CRASH = 5       # crash_clients: the client's cursor resets to the
                  # committed offsets

T_SEND = 30
T_SEND_OK = 31
T_POLL = 32
T_POLL_OK = 33
T_COMMIT = 34
T_COMMIT_OK = 35
T_LIST = 36
T_LIST_OK = 37
T_CRASH = 38
T_CRASH_OK = 39

_I32 = torch.int32


class KafkaRow(NamedTuple):
    """Per-node log state; every leaf has the node batch leading."""
    log_vals: torch.Tensor    # [..., K, cap]
    log_len: torch.Tensor     # [..., K]
    committed: torch.Tensor   # [..., K] highest committed offset (-1 none)
    positions: torch.Tensor   # [..., MAX_CLIENTS, K] next offset to poll


class KafkaModel(Model):
    name = "kafka"
    checker_name = "kafka"
    max_out = 1
    idempotent_fs = (F_POLL, F_LIST)
    # schema-conformance map (SCH305): registry RPC name -> wire TYPE.
    # `txn` is None: kafka transactions belong to the host runtimes —
    # the device model never encodes them (the CLI notes --txn)
    WIRE_TYPES = {"send": T_SEND, "poll": T_POLL,
                  "commit_offsets": T_COMMIT,
                  "list_committed_offsets": T_LIST,
                  "txn": None}

    # bug switches (see KafkaOffsetReuse / KafkaCommitRegression)
    reuse_offsets = False     # non-atomic offset assignment
    commit_monotonic = True   # False: commits blindly overwrite

    # consumer cursors are a fixed [MAX_CLIENTS, K] block per node
    MAX_CLIENTS = 8

    def __init__(self, n_keys: int = 4, log_cap: int = 64,
                 poll_max: int = 3, crash_clients: bool = False,
                 crash_rate: float = 0.05):
        self.n_keys = n_keys
        self.log_cap = log_cap
        self.poll_max = poll_max
        self.crash_clients = bool(crash_clients)
        self.crash_rate = float(crash_rate)
        self.body_lanes = max(n_keys * poll_max * 2, n_keys, 3)
        self.ev_vals = 1 + self.body_lanes
        self.op_lanes = 4

    def validate_config(self, cfg) -> None:
        if self.n_keys * self.poll_max * 2 > self.body_lanes:
            raise ValueError(
                f"kafka with {self.n_keys} keys needs "
                f"{self.n_keys * self.poll_max * 2} poll body lanes and "
                f"the model was built for {self.body_lanes}: build "
                f"KafkaModel(n_keys={self.n_keys})")
        if cfg.n_clients > self.MAX_CLIENTS:
            raise ValueError(
                f"the kafka model tracks MAX_CLIENTS={self.MAX_CLIENTS} "
                f"consumer cursors per node; concurrency {cfg.n_clients} "
                f"would alias them")

    def init_state(self, n_nodes, keys):
        lead = keys.shape[:-1]
        z = lambda *s: torch.zeros(lead + s, dtype=_I32, device=keys.device)
        return KafkaRow(
            log_vals=z(self.n_keys, self.log_cap),
            log_len=z(self.n_keys),
            committed=torch.full(lead + (self.n_keys,), -1, dtype=_I32,
                                 device=keys.device),
            positions=z(self.MAX_CLIENTS, self.n_keys))

    def handle(self, row: KafkaRow, node_idx, msg, t, keys, cfg, params):
        K, P, cap = self.n_keys, self.poll_max, self.log_cap
        B = msg.shape[0]
        dev = msg.device
        mtype = msg[:, wire.TYPE]
        src = msg[:, wire.SRC]
        positions = row.positions
        ci = (src - cfg.n_nodes).clamp(0, self.MAX_CLIENTS - 1)

        is_send = mtype == T_SEND
        is_poll = mtype == T_POLL
        is_commit = mtype == T_COMMIT
        is_list = mtype == T_LIST
        is_any = is_send | is_poll | is_commit | is_list
        if self.crash_clients:
            # the broker re-seats the crashed consumer's cursor at the
            # committed offsets (committed is -1 when none)
            is_crash = mtype == T_CRASH
            is_any = is_any | is_crash
            positions = torch.where(
                is_crash[:, None, None],
                set_drop(positions, ci, row.committed + 1), positions)

        k = msg[:, wire.BODY].clamp(0, K - 1)
        v = msg[:, wire.BODY + 1]

        # send: offset = the key's log length, append
        cur_len = tget(row.log_len, k)
        off = cur_len
        if self.reuse_offsets:
            # BUG: hand out the previous offset again
            off = (off - 1).clamp(min=0)
        fits = off < cap
        do_send = is_send & fits
        slot = (k.long() * cap + off.clamp(0, cap - 1).long())[:, None]
        log_vals = torch.where(
            do_send[:, None, None],
            row.log_vals.flatten(1).scatter(1, slot, v[:, None])
            .view(B, K, cap), row.log_vals)
        log_len = torch.where(
            do_send[:, None],
            set_drop(row.log_len, k, torch.maximum(cur_len, off + 1)),
            row.log_len)

        # poll: up to poll_max messages per key from this client's
        # cursor; the cursor advances past what was returned
        pos = tget(positions, ci)                              # [B, K]
        o = pos[:, :, None] + torch.arange(P, dtype=_I32, device=dev)
        have = o < log_len[:, :, None]                         # [B, K, P]
        got = log_vals.gather(2, o.clamp(0, cap - 1).long())
        pairs = torch.stack([torch.where(have, o + 1, 0),
                             torch.where(have, got, 0)], dim=-1)
        poll_body = torch.zeros((B, self.body_lanes), dtype=_I32, device=dev)
        poll_body[:, :K * P * 2] = pairs.reshape(B, K * P * 2)
        new_pos = torch.minimum(pos + P, log_len)
        positions = torch.where(is_poll[:, None, None],
                                set_drop(positions, ci, new_pos), positions)

        # commit_offsets: committed[k] advances to this client's
        # processed position - 1, read before this message's updates
        my_pos = tget(row.positions, ci)
        if self.commit_monotonic:
            new_committed = torch.maximum(row.committed, my_pos - 1)
        else:
            # BUG: a blind overwrite drags committed offsets backwards
            new_committed = torch.where(my_pos > 0, my_pos - 1,
                                        row.committed)
        committed = torch.where(is_commit[:, None], new_committed,
                                row.committed)

        # the reply
        tail = (sel(is_list, T_LIST_OK, T_CRASH_OK) if self.crash_clients
                else T_LIST_OK)
        type_ = sel(do_send, T_SEND_OK,
                    sel(is_send, TYPE_ERROR,
                        sel(is_poll, T_POLL_OK,
                            sel(is_commit, T_COMMIT_OK, tail))))
        body = torch.zeros((B, self.body_lanes), dtype=_I32, device=dev)
        # send_ok: the offset; a full log: error 11 (definite)
        body[:, 0] = sel(do_send, off, sel(is_send, 11, 0))
        body = torch.where(is_poll[:, None], poll_body, body)
        kmask = torch.arange(self.body_lanes, device=dev) < K
        pad = lambda x: torch.nn.functional.pad(x, (0, self.body_lanes - K))
        body = torch.where(is_commit[:, None] & kmask, pad(my_pos), body)
        body = torch.where(is_list[:, None] & kmask, pad(row.committed + 1),
                           body)
        out = torch.zeros((B, 1, cfg.lanes), dtype=_I32, device=dev)
        out[:, 0, wire.VALID] = is_any.to(_I32)
        out[:, 0, wire.DEST] = src
        out[:, 0, wire.TYPE] = type_
        out[:, 0, wire.REPLYTO] = msg[:, wire.MSGID]
        out[:, 0, wire.BODY:wire.BODY + self.body_lanes] = body
        return KafkaRow(log_vals=log_vals, log_len=log_len,
                        committed=committed, positions=positions), out

    def invariants(self, ns: KafkaRow, cfg, params=None) -> torch.Tensor:
        """Per instance: a committed offset at or past its log's end."""
        return (ns.committed >= ns.log_len).flatten(1).any(dim=1)

    def summary_step(self, summ, ns: KafkaRow, events, cfg, params=None):
        """The committed-offset lane, per instance: frontier = the
        committed watermark summed over every (node, key) — per-slot
        commits only advance on a correct trace, so a commit overwritten
        downward (KafkaCommitRegression) regresses the sum even where
        another node holds a higher offset; hash = every node's committed
        log prefix (forensic only: replication legitimately churns it);
        model flag = a committed offset at or past the log end."""
        committed = ns.committed                               # [I, N, K]
        frontier = (committed + 1).flatten(1).sum(dim=1)
        pos = torch.arange(self.log_cap, device=committed.device)
        in_pref = pos <= committed[..., None]                  # [I, N, K, cap]
        terms = (((ns.log_vals.long() * ds.HASH_C1 + pos) & 0xFFFFFFFF)
                 * ((pos << 1) | 1))
        h = torch.where(in_pref, terms, 0).flatten(1).sum(dim=1)
        return ds.fold_frontier(
            summ, frontier, h,
            model_flag=(committed >= ns.log_len).flatten(1).any(dim=1))

    # --- client side --------------------------------------------------------

    def sample_op(self, keys, uniq, cfg, params=None):
        """JAX's ``kf, kk = split(key)``, ``uniform(kf)``, ``randint(kk,
        (), 0, n_keys)`` and, with ``crash_clients``, ``uniform(
        fold_in(key, 3))`` (``split(key, 4)[3]``) for keys ``[I, C,
        2]``, in three threefry calls."""
        ks = rng.split(keys, 4 if self.crash_clients else 2)
        halves = rng.split(ks[..., 1, :], 2)               # [I, C, 2, 2]
        bits = rng.random_bits(torch.cat(
            [ks[..., :1, :], halves, ks[..., 3:, :]], dim=-2))
        r = rng.uniform_from_bits(bits[..., 0])
        k = rng.randint_from_bits(bits[..., 1], bits[..., 2], 0,
                                  self.n_keys)
        f = sel(r < xla_math.f32(0.45), F_SEND,
                sel(r < xla_math.f32(0.85), F_POLL,
                    sel(r < xla_math.f32(0.95), F_COMMIT, F_LIST)))
        if self.crash_clients:
            f = sel(rng.uniform_from_bits(bits[..., 3])
                    < xla_math.f32(self.crash_rate), F_CRASH, f)
        v = sel(f == F_SEND, 1 + uniq, 0)   # unique per instance
        return torch.stack([f, k, v, torch.zeros_like(v)], dim=-1)

    def encode_request(self, op, msg_id, client_idx, keys, cfg,
                       params=None):
        f = op[..., 0]
        tail = (sel(f == F_LIST, T_LIST, T_CRASH) if self.crash_clients
                else T_LIST)
        mtype = sel(f == F_SEND, T_SEND,
                    sel(f == F_POLL, T_POLL,
                        sel(f == F_COMMIT, T_COMMIT, tail)))
        return wire.make_msg(src=0, dest=0, type_=mtype, msg_id=msg_id,
                             body=(op[..., 1], op[..., 2]),
                             body_lanes=self.body_lanes, netid=cfg.netid,
                             batch_shape=op.shape[:-1], device=op.device)

    def decode_reply_wide(self, op, msg, cfg, params=None):
        mtype = msg[..., wire.TYPE]
        ok = ((mtype == T_SEND_OK) | (mtype == T_POLL_OK)
              | (mtype == T_COMMIT_OK) | (mtype == T_LIST_OK))
        etype = torch.where(ok, EV_OK, EV_INFO).to(_I32)
        body = msg[..., wire.BODY:wire.BODY + self.body_lanes]
        # send_ok: (k, v, offset+1); others: the raw body
        send_vals = torch.zeros_like(body)
        send_vals[..., 0] = op[..., 1]
        send_vals[..., 1] = op[..., 2]
        send_vals[..., 2] = body[..., 0] + 1
        payload = torch.where((mtype == T_SEND_OK)[..., None], send_vals,
                              body)
        return etype, torch.cat([op[..., :1], payload], dim=-1)

    # --- host-side decoding -------------------------------------------------

    def invoke_record(self, *vals):
        f = vals[0]
        if f == F_SEND:
            return {"f": "send", "value": [vals[1], vals[2]]}
        if f == F_POLL:
            return {"f": "poll", "value": None}
        if f == F_COMMIT:
            return {"f": "commit_offsets", "value": {}}
        if f == F_CRASH:
            # crash ops never complete ok by design
            return {"f": "crash", "value": None}
        return {"f": "list_committed_offsets",
                "value": list(range(self.n_keys))}

    def complete_record(self, *vals_etype):
        vals, etype = vals_etype[:-1], vals_etype[-1]
        f = vals[0]
        if etype != EV_OK:
            return self.invoke_record(*vals)
        if f == F_SEND:
            return {"f": "send",
                    "value": [vals[1], vals[2], vals[3] - 1]}
        if f == F_POLL:
            msgs = {}
            for kk in range(self.n_keys):
                base = 1 + kk * self.poll_max * 2
                pairs = []
                for j in range(self.poll_max):
                    off1, v = vals[base + 2 * j], vals[base + 2 * j + 1]
                    if off1 > 0:
                        pairs.append([off1 - 1, v])
                if pairs:
                    msgs[kk] = pairs
            return {"f": "poll", "value": msgs}
        offsets = {kk: vals[1 + kk] - 1 for kk in range(self.n_keys)
                   if vals[1 + kk] > 0}
        name = ("commit_offsets" if f == F_COMMIT
                else "list_committed_offsets")
        return {"f": name, "value": offsets}

    def checker(self):
        from ..checkers.kafka import (kafka_checker,
                                      mark_reassigned_after_crashes)
        if not self.crash_clients:
            return lambda history, opts: kafka_checker(history)
        # a reopened consumer resumes from the committed offsets, so its
        # first poll after a crash may legally jump backwards
        return lambda history, opts: kafka_checker(
            mark_reassigned_after_crashes(history))


class KafkaOffsetReuse(KafkaModel):
    """BUG: non-atomic offset assignment — concurrent sends to a key can
    be acked with the same offset, silently overwriting each other."""
    name = "kafka-bug-offset-reuse"
    reuse_offsets = True


class KafkaCommitRegression(KafkaModel):
    """BUG: commit_offsets blindly overwrites instead of taking the max,
    so a lagging consumer drags the group's committed offsets
    backwards."""
    name = "kafka-bug-commit-regression"
    commit_monotonic = False


KAFKA_BUGGY_MODELS = {
    "offset-reuse": KafkaOffsetReuse,
    "commit-regression": KafkaCommitRegression,
}
