"""Vectorized Raft: the linearizable KV store (lin-kv), batched.

Counterpart of ``maelstrom_tpu/models/raft.py`` (the correct variant):
leader election with randomized timeouts, log replication one entry
per AppendEntries, commit at the quorum match index guarded to the
current term, every client op through the log, replies at apply time,
and non-leaders rejecting with error 11 or proxying to the known
leader. State is one :class:`RaftRow` of tensors with a leading node
batch; the node step lives in :mod:`.raft_core`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import rng, wire, xla_math
from ..runtime import EV_INFO, EV_OK, Model
from . import raft_core
from .raft_core import (ENTRY_LANES, F_CAS, F_READ, F_WRITE, NIL,  # noqa: F401
                        T_CAS, T_CAS_OK, T_READ, T_READ_OK, T_WRITE,
                        T_WRITE_OK, TYPE_ERROR, full_member_mask, sel, tget,
                        set_drop)

_I32 = torch.int32


class RaftRow(NamedTuple):
    """Per-node Raft state; every leaf has the node batch leading."""
    term: torch.Tensor
    voted_for: torch.Tensor
    role: torch.Tensor            # 0 follower / 1 candidate / 2 leader
    votes: torch.Tensor           # bitmask of granted votes
    commit_idx: torch.Tensor
    last_applied: torch.Tensor
    log_term: torch.Tensor        # [..., LOGN]
    log_body: torch.Tensor        # [..., LOGN, ENTRY_LANES]
    log_len: torch.Tensor
    kv: torch.Tensor              # [..., KEYS] (list-append: [..., KEYS,
                                  # 1 + list_cap])
    next_idx: torch.Tensor        # [..., N]
    match_idx: torch.Tensor       # [..., N]
    election_deadline: torch.Tensor
    last_hb: torch.Tensor
    leader_hint: torch.Tensor
    truncated_committed: torch.Tensor
    cfg_boot: torch.Tensor
    caught_up: torch.Tensor


class RaftModel(Model):
    name = "lin-kv"
    checker_name = "linearizable-kv"
    body_lanes = 12           # AppendEntries header (6) + entry lanes
    entry_lanes = ENTRY_LANES
    idempotent_fs = (F_READ,)
    proxy_hops_lane = 3
    fused_node = True

    # the correct protocol (the JAX package's planted-bug variants flip
    # these and recovers_snapshot below; the port carries only the
    # correct one)
    vote_check_voted_for = True
    vote_check_log = True
    vote_check_log_index = True
    serve_reads_locally = False
    commit_term_guard = True
    commit_quorum = True
    apply_uncommitted = False
    joint_dual_quorum = True
    join_requires_catchup = True

    def __init__(self, n_nodes_hint: int = 5, log_cap: int = 96,
                 n_keys: int = 8, n_vals: int = 8,
                 elect_min: int = 60, elect_jitter: int = 60,
                 heartbeat: int = 15, apply_max: int = 2):
        self.n_nodes_hint = n_nodes_hint
        self.log_cap = log_cap
        self.n_keys = n_keys
        self.n_vals = n_vals
        self.elect_min = elect_min
        self.elect_jitter = elect_jitter
        self.heartbeat = heartbeat
        self.apply_max = apply_max

    def init_state(self, n_nodes: int, keys: torch.Tensor) -> RaftRow:
        """Rows for node keys ``[I, N, 2]``; leaves ``[I, N, ...]``."""
        if n_nodes != self.n_nodes_hint:
            raise ValueError(f"RaftModel built for {self.n_nodes_hint} "
                             f"nodes, run has {n_nodes}")
        I, N = keys.shape[:2]
        dev = keys.device
        jitter = rng.randint(keys, (), 0, self.elect_jitter)
        z = lambda *s: torch.zeros((I, N) + s, dtype=_I32, device=dev)
        full = lambda v: torch.full((I, N), v, dtype=_I32, device=dev)
        kv = self._init_kv(dev)
        return RaftRow(
            term=z(), voted_for=full(-1), role=z(), votes=z(),
            commit_idx=z(), last_applied=z(),
            log_term=z(self.log_cap),
            log_body=z(self.log_cap, self.entry_lanes),
            log_len=z(),
            kv=kv.expand((I, N) + kv.shape).clone(),
            next_idx=z(n_nodes), match_idx=z(n_nodes),
            election_deadline=(self.elect_min + jitter).to(_I32),
            last_hb=z(), leader_hint=full(-1),
            truncated_committed=z(),
            cfg_boot=full(full_member_mask(n_nodes)),
            caught_up=full(1),
        )

    # --- replicated-state-machine hooks (overridden by the txn models) -----

    def _init_kv(self, device=None) -> torch.Tensor:
        """One node's applied state, the tensor in ``RaftRow.kv``."""
        return torch.full((self.n_keys,), NIL, dtype=_I32, device=device)

    def _is_client_request(self, mtype):
        return (mtype >= T_READ) & (mtype <= T_CAS)

    def _encode_entry(self, msg, src):
        """Client request -> log entry (f, the three op lanes, src, msg id)."""
        return torch.cat([msg[:, wire.TYPE:wire.TYPE + 1],
                          msg[:, wire.BODY:wire.BODY + 3], src[:, None],
                          msg[:, wire.MSGID:wire.MSGID + 1]], dim=1)

    # --- the fused node step (models/raft_core.py) --------------------------

    def node_rng(self, mkeys):
        return raft_core.node_rng(self, mkeys)

    def inbox_step(self, row, node_idx, msg, jitter, t, cfg):
        return raft_core.inbox_step(self, row, node_idx, msg, jitter, t, cfg)

    def fused_tick(self, row, node_idx, t, jitter, cfg, m_bits=None):
        return raft_core.fused_tick(self, row, node_idx, t, jitter, cfg,
                                    m_bits=m_bits)

    # --- crash-restart recovery and membership (faults/) --------------------
    #
    # Raft persists term/votedFor and the log synchronously and rebuilds
    # the state machine from the log on restart, so the applied KV and
    # its cursors count as durable: the snapshot slab holds exactly
    # these lanes, and a restart rebuilds the row as a follower with
    # every volatile field (role, votes, replication cursors, leader
    # hint, timers) reset. caught_up is durable so that a joining
    # learner that crashes before catching up restarts as a learner.

    DURABLE_LANES = ("term", "voted_for", "log_term", "log_body",
                     "log_len", "kv", "commit_idx", "last_applied",
                     "truncated_committed", "cfg_boot", "caught_up")

    recovers_snapshot = True   # False: restart ignores durable storage

    def snapshot_row(self, row: RaftRow):
        """The durable subset, a dict of lanes (pure field selection)."""
        return {k: getattr(row, k) for k in self.DURABLE_LANES}

    def restart_row(self, keys, snap, t):
        """Restart rows for node keys ``[I, N, 2]``: the init row with its
        timers re-based on the restart tick ``t`` (the node-local clock
        ``[I, N]`` under the skew lane, else the global tick), then the
        slab's durable lanes ``snap`` (leaves ``[I, N, ...]``)."""
        fresh = self.init_state(keys.shape[1], keys)
        fresh = fresh._replace(
            election_deadline=(fresh.election_deadline + t).to(_I32),
            last_hb=(fresh.last_hb + t).to(_I32))
        if not self.recovers_snapshot:
            return fresh
        return fresh._replace(**{k: snap[k] for k in self.DURABLE_LANES})

    def boot_config(self, node_state: RaftRow, m_bits: int) -> RaftRow:
        """Stamp the initial (phase-0) member bitmask as every node's
        provisioning config."""
        return node_state._replace(
            cfg_boot=torch.full_like(node_state.cfg_boot, m_bits))

    def join_row(self, row: RaftRow, m_bits: torch.Tensor) -> RaftRow:
        """A joining node from its restart rows ``row`` (leaves ``[I, N,
        ...]``): the current target bitmask ``m_bits [I]`` becomes its
        provisioning config, and a node with an empty log starts as a
        non-voting learner (``caught_up = 0``) until an AppendEntries
        shows it holds the committed prefix."""
        caught = (row.log_len > 0).to(_I32)
        if not self.join_requires_catchup:
            caught = torch.ones_like(caught)
        return row._replace(
            cfg_boot=m_bits.to(_I32)[:, None].expand_as(row.cfg_boot),
            caught_up=caught)

    def apply_entry(self, row, do, entry, cfg):
        """Apply one committed entry per node to the KV state machine and
        build the leader's client reply row ``[B, L]``."""
        f, k = entry[:, 0], entry[:, 1]
        a, b = entry[:, 2], entry[:, 3]
        client, cmsg = entry[:, 4], entry[:, 5]
        k = k.clamp(0, self.n_keys - 1)
        cur = tget(row.kv, k)
        cas_ok = cur == a
        new_val = sel(f == F_WRITE, a, sel((f == F_CAS) & cas_ok, b, cur))
        row = row._replace(kv=torch.where(do[:, None],
                                          set_drop(row.kv, k, new_val),
                                          row.kv))
        reply_type = sel(f == F_READ, T_READ_OK,
                         sel(f == F_WRITE, T_WRITE_OK,
                             sel(cas_ok, T_CAS_OK, TYPE_ERROR)))
        err_code = sel(cur == NIL, 20, 22)
        out = torch.zeros((entry.shape[0], cfg.lanes), dtype=_I32,
                          device=entry.device)
        out[:, wire.VALID] = (do & (row.role == 2)).to(_I32)
        out[:, wire.DEST] = client
        out[:, wire.TYPE] = reply_type
        out[:, wire.REPLYTO] = cmsg
        out[:, wire.BODY] = sel(reply_type == TYPE_ERROR, err_code, k)
        out[:, wire.BODY + 1] = cur
        return row, out

    # --- on-device invariants ----------------------------------------------

    def invariants(self, ns: RaftRow, cfg, params=None) -> torch.Tensor:
        """Per instance: at most one leader per term, committed prefixes
        agree (against the max-commit node), no committed entry ever
        overwritten. ``ns`` leaves ``[I, N, ...]``; returns bool ``[I]``."""
        n = cfg.n_nodes
        leaders = ns.role == 2
        same_term = ns.term[:, :, None] == ns.term[:, None, :]
        eye = torch.eye(n, dtype=torch.bool, device=ns.role.device)
        pair = leaders[:, :, None] & leaders[:, None, :] & same_term & ~eye
        two_leaders = pair.flatten(1).any(dim=1)
        commit = ns.commit_idx
        ref = commit.argmax(dim=1)                             # [I]
        ref_lt = tget(ns.log_term, ref)                        # [I, LOGN]
        ref_lb = tget(ns.log_body, ref)                        # [I, LOGN, E]
        in_prefix = (torch.arange(self.log_cap, device=commit.device)
                     [None, None, :] < commit[:, :, None])
        diff = ((ns.log_term != ref_lt[:, None])
                | (ns.log_body != ref_lb[:, None]).any(dim=-1))
        log_mismatch = (diff & in_prefix).flatten(1).any(dim=1)
        overwrote = (ns.truncated_committed > 0).any(dim=1)
        return two_leaders | log_mismatch | overwrote

    # --- client side --------------------------------------------------------

    def sample_op(self, keys, uniq, cfg, params=None):
        """Ops ``[I, C, 4]`` (f, key, v1, v2) from keys ``[I, C, 2]``."""
        ks = rng.split(keys, 4)                      # [I, C, 4, 2]
        # uniform(ks[0]) and randint(ks[1..3]) draw from ks[0] and the
        # split halves of ks[1..3]: seven keys, one batched call
        halves = rng.split(ks[..., 1:, :], 2)         # [I, C, 3, 2, 2]
        bits = rng.random_bits(torch.cat(
            [ks[..., :1, :], halves.flatten(-3, -2)], dim=-2))  # [I, C, 7]
        r = rng.uniform_from_bits(bits[..., 0])
        kk = rng.randint_from_bits(bits[..., 1], bits[..., 2], 0,
                                   self.n_keys)
        v1 = rng.randint_from_bits(bits[..., 3], bits[..., 4], 0,
                                   self.n_vals)
        v2 = rng.randint_from_bits(bits[..., 5], bits[..., 6], 0,
                                   self.n_vals)
        f = sel(r < xla_math.f32(1 / 3), F_READ,
                sel(r < xla_math.f32(2 / 3), F_WRITE, F_CAS))
        return torch.stack([f, kk, v1, v2], dim=-1)

    def encode_request(self, op, msg_id, client_idx, keys, cfg,
                       params=None):
        dest = rng.randint(keys, (), 0, cfg.n_nodes)
        mtype = sel(op[..., 0] == F_READ, T_READ,
                    sel(op[..., 0] == F_WRITE, T_WRITE, T_CAS))
        return wire.make_msg(src=0, dest=dest, type_=mtype, msg_id=msg_id,
                             body=(op[..., 1], op[..., 2], op[..., 3]),
                             body_lanes=self.body_lanes,
                             batch_shape=op.shape[:-1], device=op.device)

    def decode_reply(self, op, msg, cfg, params=None):
        mtype = msg[..., wire.TYPE]
        ok = (mtype == T_READ_OK) | (mtype == T_WRITE_OK) | (mtype == T_CAS_OK)
        etype = sel(ok, EV_OK, EV_INFO)
        value = torch.stack([op[..., 1],
                             torch.where(mtype == T_READ_OK,
                                         msg[..., wire.BODY + 1],
                                         op[..., 2]),
                             op[..., 3]], dim=-1)
        return etype, value

    # --- host-side decoding -------------------------------------------------

    def invoke_record(self, f, a, b, c):
        if f == F_READ:
            return {"f": "read", "value": [a, None]}
        if f == F_WRITE:
            return {"f": "write", "value": [a, b]}
        return {"f": "cas", "value": [a, [b, c]]}

    def complete_record(self, f, a, b, c, etype):
        if etype != EV_OK:
            return self.invoke_record(f, a, b, c)
        if f == F_READ:
            return {"f": "read", "value": [a, None if b == NIL else b]}
        if f == F_WRITE:
            return {"f": "write", "value": [a, b]}
        return {"f": "cas", "value": [a, [b, c]]}

    def checker(self):
        from ..checkers.linearizable import linearizable_kv_checker
        return lambda history, opts: linearizable_kv_checker(history)
