"""Transactional workloads over the vectorized Raft log: txn-list-append
and txn-rw-register, batched.

Counterpart of ``maelstrom_tpu/models/txn_raft.py``. A whole
transaction is one log entry, applied atomically at commit on every
node, the leader replying with the read results at apply time; the
history goes to the Elle checker (``checkers/elle.py``). Fixed-shape
encodings:

- a txn is ``txn_max`` micro-op slots ``(f, k, v)`` plus a length lane;
- request body  = ``[len, (f,k,v)*txn_max]`` (+ a proxy-hops lane);
- log entry     = ``[len, (f,k,v)*txn_max, client, client_msg_id]``;
- reply body    = the request echo plus per-micro-op read results
  (list-append: ``txn_max * list_cap`` value lanes; rw-register: read
  values folded into the echoed ``v`` lanes);
- written values are minted unique per instance from the client-striped
  op counter ``uniq``, which lets Elle infer version orders.

A list-append txn whose appends would overflow a key's ``list_cap``
value slots aborts whole with error 30 (txn-conflict, definite).

The dirty-apply mutants flip ``apply_uncommitted``: nodes apply, and the
leader replies, at append time instead of commit, so a leader change
truncates acknowledged transactions.
"""

from __future__ import annotations

import torch

from .. import rng, wire, xla_math
from ..runtime import EV_INFO, EV_OK
from .raft import RaftModel
from .raft_core import TYPE_ERROR, sel, set_drop, tget

# micro-op f codes
MF_R = 1
MF_APPEND = 2    # list-append write
MF_W = 2         # rw-register write (same slot, different semantics)

# message types (distinct from the Raft protocol's 10-13)
T_TXN = 20
T_TXN_OK = 21

_I32 = torch.int32


class _TxnRaftBase(RaftModel):
    """The txn-over-Raft machinery both workloads share; subclasses set
    the state machine (list-append or rw-register)."""

    idempotent_fs = ()          # txns are never idempotent
    write_f = MF_APPEND

    def __init__(self, n_nodes_hint: int = 3, log_cap: int = 96,
                 n_keys: int = 8, txn_max: int = 3, list_cap: int = 16,
                 read_prob: float = 0.5, **kw):
        self.txn_max = txn_max
        self.list_cap = list_cap
        self.read_prob = read_prob
        super().__init__(n_nodes_hint=n_nodes_hint, log_cap=log_cap,
                         n_keys=n_keys, **kw)
        # [len, (f,k,v)*txn_max, client, cmsg]
        self.entry_lanes = 1 + 3 * txn_max + 2
        self.op_lanes = 1 + 3 * txn_max
        self.proxy_hops_lane = 1 + 3 * txn_max
        self.ev_vals = self._reply_width()
        self.body_lanes = max(6 + self.entry_lanes, self._reply_width(),
                              self.proxy_hops_lane + 1)

    def _reply_width(self) -> int:
        raise NotImplementedError

    # --- request / entry encoding -------------------------------------------

    def _is_client_request(self, mtype):
        return mtype == T_TXN

    def _encode_entry(self, msg, src):
        return torch.cat([msg[:, wire.BODY:wire.BODY + 1 + 3 * self.txn_max],
                          src[:, None], msg[:, wire.MSGID:wire.MSGID + 1]],
                         dim=1)

    def _op_rows(self, ln, fs, ks, vs):
        """Op rows ``[I, C, op_lanes]``: the length, then ``(f, k, v)``
        per micro-op slot (``fs``, ``ks``, ``vs`` of shape ``[I, C,
        txn_max]``)."""
        mops = torch.stack([fs, ks, vs], dim=-1).flatten(-2)
        return torch.cat([ln[..., None], mops], dim=-1).to(_I32)

    # --- client side --------------------------------------------------------

    def sample_op(self, keys, uniq, cfg, params=None):
        """JAX's ``kf, kk, kl = split(key, 3)``, ``randint(kl, (), 1,
        T + 1)``, ``uniform(kf, (T,))`` and ``randint(kk, (T,), 0,
        n_keys)`` for keys ``[I, C, 2]``, in three threefry calls."""
        T = self.txn_max
        ks = rng.split(keys, 3)                           # [I, C, 3, 2]
        halves = rng.split(ks[..., 1:, :], 2)             # [I, C, 2, 2, 2]
        bits = rng.random_bits(torch.cat(
            [ks[..., :1, :], halves.flatten(-3, -2)], dim=-2), (T,))
        # bits [I, C, 5, T]: kf, kk's halves, kl's halves
        ln = rng.randint_from_bits(bits[..., 3, 0], bits[..., 4, 0], 1,
                                   T + 1)
        fs = sel(rng.uniform_from_bits(bits[..., 0, :])
                 < xla_math.f32(self.read_prob), MF_R, self.write_f)
        kk = rng.randint_from_bits(bits[..., 1, :], bits[..., 2, :], 0,
                                   self.n_keys)
        vs = 1 + uniq[..., None] * T + torch.arange(T, dtype=_I32,
                                                    device=keys.device)
        return self._op_rows(ln, fs, kk, vs)

    def sample_final_op(self, keys, uniq, cfg, params=None):
        """Post-heal phase: all-read txns over random keys (JAX draws
        from ``split(key, 1)[0]``, not from ``key``)."""
        T = self.txn_max
        kk = rng.randint(rng.split(keys, 1)[..., 0, :], (T,), 0,
                         self.n_keys)
        return self._op_rows(torch.full_like(uniq, T),
                             torch.full_like(kk, MF_R), kk,
                             torch.zeros_like(kk))

    def encode_request(self, op, msg_id, client_idx, keys, cfg,
                       params=None):
        dest = rng.randint(keys, (), 0, cfg.n_nodes)
        m = wire.make_msg(src=0, dest=dest, type_=T_TXN, msg_id=msg_id,
                          body_lanes=self.body_lanes, netid=cfg.netid,
                          batch_shape=op.shape[:-1], device=op.device)
        m[..., wire.BODY:wire.BODY + op.shape[-1]] = op
        return m

    def decode_reply_wide(self, op, msg, cfg, params=None):
        etype = torch.where(msg[..., wire.TYPE] == T_TXN_OK, EV_OK,
                            EV_INFO).to(_I32)
        return etype, msg[..., wire.BODY:wire.BODY + self.ev_vals]

    def _reply_rows(self, do, ok, client, cmsg, body, row, cfg):
        """The leader's reply rows ``[B, L]`` for body rows ``[B,
        ev_vals]`` (the runtime stamps SRC and ORIGIN)."""
        out = torch.zeros((body.shape[0], cfg.lanes), dtype=_I32,
                          device=body.device)
        out[:, wire.VALID] = (do & (row.role == 2)).to(_I32)
        out[:, wire.DEST] = client
        out[:, wire.TYPE] = sel(ok, T_TXN_OK, TYPE_ERROR)
        out[:, wire.REPLYTO] = cmsg
        out[:, wire.BODY:wire.BODY + self.ev_vals] = body
        return out

    def _echo(self, entry):
        """The reply row's echo of a txn entry ``[B, E]``: ``[B,
        ev_vals]`` holding the length and the micro-op lanes."""
        reply = torch.zeros((entry.shape[0], self.ev_vals), dtype=_I32,
                            device=entry.device)
        reply[:, :1 + 3 * self.txn_max] = entry[:, :1 + 3 * self.txn_max]
        return reply

    # --- host-side decoding -------------------------------------------------

    def _micro_ops(self, vals):
        ln = max(0, min(int(vals[0]), self.txn_max))
        return [(int(vals[1 + 3 * i]), int(vals[2 + 3 * i]),
                 int(vals[3 + 3 * i])) for i in range(ln)]

    def invoke_record(self, *vals):
        txn = []
        for f, k, v in self._micro_ops(vals):
            if f == MF_R:
                txn.append(["r", k, None])
            else:
                txn.append([self.write_f_name, k, v])
        return {"f": "txn", "value": txn}


class TxnListAppendModel(_TxnRaftBase):
    """txn-list-append: reads return the full per-key append list."""

    name = "txn-list-append"
    checker_name = "elle-list-append"
    write_f_name = "append"
    write_f = MF_APPEND

    def _reply_width(self):
        # request echo + txn_max read-result blocks of list_cap values
        return 1 + 3 * self.txn_max + self.txn_max * self.list_cap

    def _init_kv(self, device=None):
        # [n_keys, 1 + list_cap]: lane 0 = length, 1.. = appended values
        return torch.zeros((self.n_keys, 1 + self.list_cap), dtype=_I32,
                           device=device)

    def apply_entry(self, row, do, entry, cfg):
        """The micro-op chain of one entry per node: a read snapshots
        the key's list as of that micro-op (earlier appends of the same
        txn included); an append that overflows ``list_cap`` aborts the
        whole txn (kv unchanged, reply ``[30, 0, ...]`` as an error)."""
        T, Lc = self.txn_max, self.list_cap
        ln, client, cmsg = entry[:, 0], entry[:, -2], entry[:, -1]
        reply = self._echo(entry)
        rbase = 1 + 3 * T
        kv = row.kv                                       # [B, KEYS, 1+Lc]
        overflow = torch.zeros_like(do)
        for i in range(T):
            f, k, v = (entry[:, 1 + 3 * i], entry[:, 2 + 3 * i],
                       entry[:, 3 + 3 * i])
            active = i < ln
            is_rd = active & (f == MF_R)
            is_app = active & (f == MF_APPEND)
            rk = tget(kv, k)                              # [B, 1+Lc]
            reply[:, rbase + i * Lc:rbase + (i + 1) * Lc] = torch.where(
                is_rd[:, None], rk[:, 1:], 0)
            lk = rk[:, 0]
            fits = lk < Lc
            overflow = overflow | (is_app & ~fits)
            new_rk = rk.scatter(1, (1 + lk.clamp(0, Lc - 1)).long()[:, None],
                                v[:, None])
            new_rk[:, 0] += 1
            kv = torch.where((is_app & fits)[:, None, None],
                             set_drop(kv, k, new_rk), kv)
        ok = ~overflow
        row = row._replace(kv=torch.where((do & ok)[:, None, None], kv,
                                          row.kv))
        abort = torch.zeros_like(reply)
        abort[:, 0] = 30                                  # txn-conflict
        body = torch.where(ok[:, None], reply, abort)
        return row, self._reply_rows(do, ok, client, cmsg, body, row, cfg)

    def complete_record(self, *vals_etype):
        vals, etype = vals_etype[:-1], vals_etype[-1]
        if etype != EV_OK:
            return self.invoke_record(*vals)
        rbase = 1 + 3 * self.txn_max
        txn = []
        for i, (f, k, v) in enumerate(self._micro_ops(vals)):
            if f == MF_R:
                block = vals[rbase + i * self.list_cap:
                             rbase + (i + 1) * self.list_cap]
                lst = []
                for x in block:
                    if x == 0:
                        break
                    lst.append(int(x))
                txn.append(["r", k, lst])
            else:
                txn.append(["append", k, v])
        return {"f": "txn", "value": txn}

    def checker(self):
        from ..checkers.elle import check_list_append
        return lambda history, opts: check_list_append(
            history, (opts or {}).get("consistency_models")
            or "strict-serializable")


class TxnRwRegisterModel(_TxnRaftBase):
    """txn-rw-register: read/write register micro-ops; reads fold their
    value into the echoed ``v`` lane (0 = unwritten)."""

    name = "txn-rw-register"
    checker_name = "elle-rw-register"
    write_f_name = "w"
    write_f = MF_W

    def _reply_width(self):
        return 1 + 3 * self.txn_max

    def _init_kv(self, device=None):
        return torch.zeros((self.n_keys,), dtype=_I32, device=device)

    def apply_entry(self, row, do, entry, cfg):
        """Register micro-ops of one entry per node; a read replaces the
        echoed ``v`` lane of its slot."""
        T = self.txn_max
        ln, client, cmsg = entry[:, 0], entry[:, -2], entry[:, -1]
        reply = self._echo(entry)
        kv = row.kv                                       # [B, KEYS]
        for i in range(T):
            f, k, v = (entry[:, 1 + 3 * i], entry[:, 2 + 3 * i],
                       entry[:, 3 + 3 * i])
            active = i < ln
            is_rd = active & (f == MF_R)
            is_wr = active & (f == MF_W)
            vlane = 3 + 3 * i
            reply[:, vlane] = torch.where(is_rd, tget(kv, k), reply[:, vlane])
            kv = torch.where(is_wr[:, None], set_drop(kv, k, v), kv)
        row = row._replace(kv=torch.where(do[:, None], kv, row.kv))
        return row, self._reply_rows(do, torch.ones_like(do), client, cmsg,
                                     reply, row, cfg)

    def complete_record(self, *vals_etype):
        vals, etype = vals_etype[:-1], vals_etype[-1]
        if etype != EV_OK:
            return self.invoke_record(*vals)
        txn = []
        for f, k, v in self._micro_ops(vals):
            if f == MF_R:
                txn.append(["r", k, None if v == 0 else v])
            else:
                txn.append(["w", k, v])
        return {"f": "txn", "value": txn}

    def checker(self):
        from ..checkers.elle import check_rw_register
        return lambda history, opts: check_rw_register(
            history, (opts or {}).get("consistency_models")
            or "strict-serializable")


class TxnDirtyApply(TxnListAppendModel):
    """BUG: apply + reply at append time instead of commit — a leader
    change truncates acked txns (lost appends / fractured reads)."""
    name = "txn-list-append-bug-dirty-apply"
    apply_uncommitted = True


class TxnRwDirtyApply(TxnRwRegisterModel):
    """BUG: the same dirty apply on the rw-register workload — stale
    reads of truncated acked writes, seen as G-single cycles."""
    name = "txn-rw-register-bug-dirty-apply"
    apply_uncommitted = True


TXN_BUGGY_MODELS = {
    "dirty-apply": TxnDirtyApply,
    "rw-dirty-apply": TxnRwDirtyApply,
}
