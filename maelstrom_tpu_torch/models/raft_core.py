"""The Raft node step over a flat batch of nodes.

Counterpart of ``maelstrom_tpu/models/raft_core.py``: the same
compartments (batched RNG, the per-slot sequential core, the per-tick
hook with its apply loop, the peer-send table), written over a leading
batch axis ``B = instances * nodes`` instead of two ``vmap`` levels.
Every formula mirrors the JAX dataflow value for value, junk lanes of
invalid slots included, so trajectories are bit-identical.

Scalars per node are ``[B]`` int32 tensors; the log is ``[B, cap]`` and
``[B, cap, E]``. Python ints in the helpers broadcast.
"""

from __future__ import annotations

import torch

from .. import rng, wire

# message types (raft protocol + lin-kv client vocabulary)
T_READ = 1
T_WRITE = 2
T_CAS = 3
T_READ_OK = 4
T_WRITE_OK = 5
T_CAS_OK = 6
T_REQ_VOTE = 10
T_VOTE_REPLY = 11
T_APPEND = 12
T_APPEND_REPLY = 13

F_READ = 1
F_WRITE = 2
F_CAS = 3

NIL = -1          # missing KV value
F_CONFIG = -7     # lane-0 marker of a joint-consensus config entry
ENTRY_LANES = 6   # (f, key, a, b, client, client_msg_id)
TYPE_ERROR = 127

_I32 = torch.int32


# --- helpers ---------------------------------------------------------------


def sel(pred: torch.Tensor, on_true, on_false) -> torch.Tensor:
    """``jnp.where`` on int32 values; Python ints enter as scalar
    arguments (no host-to-device copy)."""
    out = torch.where(pred, on_true, on_false)
    return out if out.dtype == _I32 else out.to(_I32)


def tget(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``jnp.take(a, i, axis=1, mode="clip")`` per batch row: ``a [B, n,
    ...]`` with ``i [B]`` -> ``[B, ...]`` or ``i [B, m]`` -> ``[B, m,
    ...]``. Negative indices clip to 0, as in JAX's clip mode."""
    n = a.shape[1]
    squeeze = i.dim() == 1
    idx = i.long().clamp(0, n - 1)
    if squeeze:
        idx = idx[:, None]
    tail = a.shape[2:]
    idx = idx.reshape(idx.shape + (1,) * len(tail)).expand(
        idx.shape + tail)
    out = a.gather(1, idx)
    return out[:, 0] if squeeze else out


def set_drop(a: torch.Tensor, i: torch.Tensor, v) -> torch.Tensor:
    """``a.at[i].set(v, mode="drop")`` per batch row: a negative index
    counts from the end (JAX normalizes it), an index still out of
    range drops the write. ``a [B, n, ...]``, ``i [B]``, ``v [B, ...]``."""
    n = a.shape[1]
    i = i.long()
    i = torch.where(i < 0, i + n, i)
    ok = (i >= 0) & (i < n)
    ic = i.clamp(0, n - 1)
    tail = a.shape[2:]
    if not isinstance(v, torch.Tensor):
        v = torch.full((a.shape[0],) + tail, v, dtype=a.dtype,
                       device=a.device)
    idx = ic.reshape((-1, 1) + (1,) * len(tail)).expand(
        (a.shape[0], 1) + tail)
    cur = a.gather(1, idx)[:, 0]
    okb = ok.reshape((-1,) + (1,) * len(tail))
    return a.scatter(1, idx, torch.where(okb, v, cur)[:, None])


def popcount(x: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Popcount of an ``n_nodes``-bit mask. The JAX table form (up to 8
    nodes) reads its 2^n-entry table at a clipped index, so the mask is
    clipped the same way before the shift/mask sum."""
    if n_nodes <= 8:
        x = x.clamp(0, (1 << n_nodes) - 1)
    sh = torch.arange(n_nodes, dtype=_I32, device=x.device)
    return ((x[..., None] >> sh) & 1).sum(dim=-1).to(_I32)


def full_member_mask(n_nodes: int) -> int:
    return ((1 << n_nodes) - 1) if n_nodes < 32 else -1


def has_quorum(vbits, mask, n_nodes: int) -> torch.Tensor:
    cnt = popcount(vbits & mask, n_nodes)
    maj = torch.div(popcount(mask, n_nodes), 2, rounding_mode="floor") + 1
    return cnt >= maj


def quorum_match(match: torch.Tensor, mask: torch.Tensor, n_nodes: int
                 ) -> torch.Tensor:
    """Highest index replicated on a strict majority of ``mask``'s
    members: ``match [B, n]``, ``mask [B]`` -> ``[B]``."""
    sh = torch.arange(n_nodes, dtype=_I32, device=match.device)
    member = ((mask[:, None] >> sh) & 1) == 1
    vals = torch.where(member, match, -1)
    maj = torch.div(popcount(mask, n_nodes), 2, rounding_mode="floor") + 1
    srt = torch.sort(vals, dim=1).values
    return tget(srt, n_nodes - maj)


def config_view(model, row):
    """(c_old, c_new, cfg_idx, has_cfg): the latest config entry in the
    log, else the provisioning mask ``cfg_boot``."""
    cap = model.log_cap
    idxs = torch.arange(cap, dtype=_I32, device=row.term.device)
    is_cfg = (row.log_body[:, :, 0] == F_CONFIG) \
        & (idxs[None, :] < row.log_len[:, None])
    has = is_cfg.any(dim=1)
    cfg_idx = torch.where(is_cfg, idxs[None, :], -1).max(dim=1).values
    crow = tget(row.log_body, cfg_idx.clamp(0, cap - 1))
    c_old = sel(has, crow[:, 1], row.cfg_boot)
    c_new = sel(has, crow[:, 2], row.cfg_boot)
    return c_old, c_new, cfg_idx, has


# --- batched RNG compartment -------------------------------------------------


def node_rng(model, mkeys: torch.Tensor):
    """Every draw of a node's tick from its ``[..., K+1, 2]`` slot keys:
    slot jitters ``randint(mkeys[i])`` and the tick jitter
    ``randint(split(mkeys[K])[1])``. Returns ``([..., K], [...])``."""
    K = mkeys.shape[-2] - 1
    k_jit = rng.fold_in(mkeys[..., K, :], 1)
    jkeys = torch.cat([mkeys[..., :K, :], k_jit[..., None, :]], dim=-2)
    jit_all = rng.randint(jkeys, (), 0, model.elect_jitter)
    return jit_all[..., :K], jit_all[..., K]


# --- the sequential core ---------------------------------------------------


def inbox_step(model, row, node_idx, msg, jitter, t, cfg):
    """One inbox slot for every node of the batch: ``(row', reply
    [B, L])`` from ``msg [B, L]``. Self-gates on invalid (all-zero)
    slots like the JAX core. ``t`` is the global tick (an int) or each
    row's local clock ``[B]`` under the clock-skew lane."""
    n = cfg.n_nodes
    cap = model.log_cap
    mtype = msg[:, wire.TYPE]
    src = msg[:, wire.SRC]
    msgid = msg[:, wire.MSGID]
    b0 = msg[:, wire.BODY]
    b1 = msg[:, wire.BODY + 1]
    b2 = msg[:, wire.BODY + 2]
    nid = node_idx
    is_vote = mtype == T_REQ_VOTE
    is_vrep = mtype == T_VOTE_REPLY
    is_ae = mtype == T_APPEND
    is_arep = mtype == T_APPEND_REPLY
    is_cli = model._is_client_request(mtype)
    is_proto = is_vote | is_vrep | is_ae | is_arep
    b1_is_1 = b1 == 1

    # term adoption / step-down
    higher = is_proto & (b0 > row.term)
    term = sel(higher, b0, row.term)
    role = sel(higher, 0, row.role)
    voted_for = sel(higher, -1, row.voted_for)
    votes = sel(higher, 0, row.votes)

    prev_idx = b1
    ae_widx = prev_idx.clamp(0, cap - 1)

    # RequestVote
    c_lli, c_llt = b1, b2
    my_llt = sel(row.log_len > 0, tget(row.log_term, row.log_len - 1), 0)
    if model.vote_check_log_index:
        log_ok = (c_llt > my_llt) | ((c_llt == my_llt)
                                     & (c_lli >= row.log_len))
    else:
        log_ok = c_llt >= my_llt
    cur_term = b0 == term
    grant = is_vote & cur_term
    if model.vote_check_voted_for:
        grant = grant & ((voted_for == -1) | (voted_for == src))
    if model.vote_check_log:
        grant = grant & log_ok
    if model.join_requires_catchup:
        grant = grant & (row.caught_up > 0)
    voted_for = sel(grant, src, voted_for)

    # VoteReply
    count_it = (role == 1) & cur_term & (is_vrep & b1_is_1)
    votes = sel(count_it, votes | (torch.ones_like(src)
                                     << src.clamp(0, n - 1)), votes)
    c_old, c_new, _, _ = config_view(model, row)
    vbits = votes | (torch.ones_like(nid) << nid.clamp(0, n - 1))
    if model.joint_dual_quorum:
        win = count_it & has_quorum(vbits, c_old, n) \
            & has_quorum(vbits, c_new, n)
    else:
        win = count_it & has_quorum(vbits, c_new, n)
    role = sel(win, 2, role)

    # AppendEntries
    prev_term = b2
    l_commit = msg[:, wire.BODY + 3]
    n_entries = msg[:, wire.BODY + 4]
    e_term = msg[:, wire.BODY + 5]
    ae_current = is_ae & cur_term
    role = sel(ae_current & (role == 1), 0, role)
    leader_hint = sel(ae_current, src, row.leader_hint)
    prev_ok = (prev_idx == 0) | (
        (prev_idx <= row.log_len)
        & (tget(row.log_term, prev_idx - 1) == prev_term))
    fits = prev_idx < cap
    accept = ae_current & prev_ok & ((n_entries == 0) | fits)
    ae_write = accept & (n_entries == 1)
    same = (row.log_len > prev_idx) & (tget(row.log_term, prev_idx)
                                        == e_term)
    conflict = ae_write & ~same
    ae_len = sel(conflict, ae_widx + 1, row.log_len)
    match_ack = sel(accept, (prev_idx + n_entries).clamp(0, cap), 0)
    caught_up = row.caught_up | (accept & (l_commit <= match_ack)).to(_I32)

    # client request: append as leader, else proxy
    is_leader = role == 2
    cli_accept = is_cli & is_leader & (row.log_len < cap)
    if model.serve_reads_locally:
        is_stale = is_cli & (mtype == T_READ)
        cli_accept = cli_accept & ~is_stale
    forward = (is_cli & ~cli_accept & (row.leader_hint >= 0)
               & (row.leader_hint != nid)
               & (msg[:, wire.BODY + model.proxy_hops_lane] < 3))
    if model.serve_reads_locally:
        forward = forward & ~is_stale

    # the single log write (AE entry or client append)
    slot = sel(ae_write, ae_widx, sel(cli_accept, row.log_len, cap))
    w_term = sel(ae_write, e_term, term)
    e_body = msg[:, wire.BODY + 6:wire.BODY + 6 + model.entry_lanes]
    w_body = torch.where(ae_write[:, None], e_body,
                         model._encode_entry(msg, src))
    log_term = set_drop(row.log_term, slot, w_term)
    log_body = set_drop(row.log_body, slot, w_body)
    log_len = sel(cli_accept, row.log_len + 1, ae_len)

    truncated_committed = row.truncated_committed | (
        conflict & (ae_widx < row.commit_idx)).to(_I32)

    commit_idx = torch.maximum(row.commit_idx,
                               torch.minimum(l_commit, match_ack))

    # AppendEntriesReply bookkeeping (leader side)
    r_success = b1_is_1
    r_match = b2.clamp(0, cap)
    mine = is_arep & is_leader & cur_term
    nxt = tget(row.next_idx, src)
    nxt = sel(mine,
              sel(r_success, torch.maximum(nxt, r_match),
                  (nxt - 1).clamp(min=0)),
              nxt)
    next_idx = set_drop(row.next_idx, src, nxt)
    next_idx = torch.where(win[:, None], row.log_len[:, None].expand(-1, n),
                           next_idx)
    mtch_old = tget(row.match_idx, src)
    mtch = sel(mine & r_success, torch.maximum(mtch_old, r_match), mtch_old)
    match_idx = set_drop(row.match_idx, src, mtch)
    match_idx = torch.where(win[:, None], 0, match_idx)
    match_idx = set_drop(
        match_idx, nid,
        sel(cli_accept, row.log_len + 1,
            sel(win, row.log_len, tget(match_idx, nid))))
    last_hb = sel(win, t - model.heartbeat, row.last_hb)

    election_deadline = sel(grant | ae_current,
                            t + model.elect_min + jitter,
                            row.election_deadline)

    row = row._replace(
        term=term, voted_for=voted_for, role=role, votes=votes,
        commit_idx=commit_idx, log_term=log_term, log_body=log_body,
        log_len=log_len, next_idx=next_idx, match_idx=match_idx,
        election_deadline=election_deadline, last_hb=last_hb,
        leader_hint=leader_hint, caught_up=caught_up,
        truncated_committed=truncated_committed)

    # the slot's reply row (junk lanes of invalid slots included)
    bl = model.body_lanes
    is_req = is_vote | is_ae
    valid = is_req | (is_cli & ~cli_accept)
    dest = sel(forward, leader_hint, src)
    type_ = sel(is_req, mtype + 1, sel(forward, mtype, TYPE_ERROR))
    reply_to = sel(forward, -1, msgid)
    msgid_out = sel(forward, msgid, -1)
    src_out = sel(forward, src, nid)
    fwd_body = msg[:, wire.BODY:wire.BODY + bl].clone()
    fwd_body[:, model.proxy_hops_lane] += 1
    proto_body = torch.zeros_like(fwd_body)
    proto_body[:, 0] = sel(is_req, term, 11)
    proto_body[:, 1] = (grant | accept).to(_I32)
    proto_body[:, 2] = match_ack
    body = torch.where(forward[:, None], fwd_body, proto_body)
    if model.serve_reads_locally:
        stale = is_stale
        kk = b0.clamp(0, model.n_keys - 1)
        valid = valid | stale
        dest = sel(stale, src, dest)
        type_ = sel(stale, T_READ_OK, type_)
        reply_to = sel(stale, msgid, reply_to)
        msgid_out = sel(stale, -1, msgid_out)
        src_out = sel(stale, nid, src_out)
        stale_body = torch.zeros_like(fwd_body)
        stale_body[:, 0] = kk
        stale_body[:, 1] = tget(row.kv, kk)
        body = torch.where(stale[:, None], stale_body, body)
    out = torch.zeros((msg.shape[0], cfg.lanes), dtype=_I32,
                      device=msg.device)
    out[:, wire.VALID] = valid.to(_I32)
    out[:, wire.SRC] = src_out
    out[:, wire.DEST] = dest
    out[:, wire.TYPE] = type_
    out[:, wire.MSGID] = msgid_out
    out[:, wire.REPLYTO] = reply_to
    out[:, wire.ORIGIN] = nid
    out[:, wire.BODY:wire.BODY + bl] = body
    return row, out


# --- the per-tick hook -------------------------------------------------------


def apply_frontier(model, row):
    """(do, entry) for the next entry to apply."""
    frontier = row.log_len if model.apply_uncommitted else row.commit_idx
    do = row.last_applied < frontier
    return do, tget(row.log_body, row.last_applied)


def fused_tick(model, row, node_idx, t, jitter, cfg, m_bits=None):
    """Election timer, leader commit advance, ``apply_max`` applies and
    the peer-send table, for every node of the batch. ``t`` is the
    global tick (an int) or each row's local clock ``[B]``; ``m_bits
    [B]`` is the membership lane's target member bitmask, the full
    cluster when ``None``. Returns ``(row', outs [B, apply_max + n - 1,
    L])``."""
    n = cfg.n_nodes
    nid = node_idx

    # 1) election timeout -> candidacy
    timeout = (row.role != 2) & (row.election_deadline <= t)
    if model.join_requires_catchup:
        timeout = timeout & (row.caught_up > 0)
    row = row._replace(
        term=sel(timeout, row.term + 1, row.term),
        role=sel(timeout, 1, row.role),
        voted_for=sel(timeout, nid, row.voted_for),
        votes=sel(timeout, 0, row.votes),
        last_hb=sel(timeout, t - model.heartbeat, row.last_hb),
        leader_hint=sel(timeout, -1, row.leader_hint),
        election_deadline=sel(timeout, t + model.elect_min + jitter,
                              row.election_deadline),
    )

    # 2) leader commit advance over the current configuration
    c_old, c_new, cfg_idx, has_cfg = config_view(model, row)
    joint = c_old != c_new
    is_leader = row.role == 2
    match = set_drop(row.match_idx, nid, row.log_len)
    if model.commit_quorum:
        if model.joint_dual_quorum:
            majority_match = torch.minimum(quorum_match(match, c_old, n),
                                           quorum_match(match, c_new, n))
        else:
            majority_match = quorum_match(match, c_new, n)
    else:
        majority_match = match.max(dim=1).values
    if model.commit_term_guard:
        current_term_ok = tget(row.log_term, majority_match - 1) == row.term
    else:
        current_term_ok = torch.ones_like(is_leader)
    new_commit = sel(
        is_leader & (majority_match > row.commit_idx) & current_term_ok,
        majority_match, row.commit_idx)
    row = row._replace(commit_idx=new_commit, match_idx=match)

    pending = has_cfg & (cfg_idx >= row.commit_idx)
    self_in_new = ((c_new >> nid.clamp(0, n - 1)) & 1) == 1
    deposed = is_leader & ~joint & ~pending & ~self_in_new
    row = row._replace(role=sel(deposed, 0, row.role))

    # 3) apply up to apply_max committed entries; the leader replies
    replies = []
    for _ in range(model.apply_max):
        do, entry = apply_frontier(model, row)
        is_cfg_entry = entry[:, 0] == F_CONFIG
        row, out = model.apply_entry(row, do & ~is_cfg_entry, entry, cfg)
        row = row._replace(last_applied=sel(do, row.last_applied + 1,
                                            row.last_applied))
        out[:, wire.SRC] = nid
        out[:, wire.ORIGIN] = nid
        replies.append(out)

    # 3b) the reconfiguration driver: a leader whose configuration
    # differs from the target appends one C_old,new entry, then C_new
    # once it commits
    cap = model.log_cap
    m_tgt = full_member_mask(n) if m_bits is None else m_bits
    is_leader_now = row.role == 2
    want_joint = (is_leader_now & ~joint & (c_new != m_tgt) & ~pending
                  & (row.log_len < cap))
    want_final = is_leader_now & joint & ~pending & (row.log_len < cap)
    app = want_joint | want_final
    cfg_body = torch.zeros((row.term.shape[0], model.entry_lanes),
                           dtype=_I32, device=row.term.device)
    cfg_body[:, 0] = F_CONFIG
    cfg_body[:, 1] = c_new
    cfg_body[:, 2] = sel(want_joint, m_tgt, c_new)
    cslot = sel(app, row.log_len, cap)
    row = row._replace(
        log_term=set_drop(row.log_term, cslot, row.term),
        log_body=set_drop(row.log_body, cslot, cfg_body),
        log_len=sel(app, row.log_len + 1, row.log_len))

    # 4) peer sends on the heartbeat cadence
    due = (t - row.last_hb) >= model.heartbeat
    solicit = (row.role == 1) & due
    hb_due = (row.role == 2) & due
    row = row._replace(last_hb=sel(hb_due | solicit, t, row.last_hb))
    peers = peer_sends(model, row, nid, solicit, hb_due, cfg)
    return row, torch.cat([torch.stack(replies, dim=1), peers], dim=1)


def peer_sends(model, row, node_idx, solicit, hb_due, cfg):
    """One row per peer slot ``[B, n-1, L]``: RequestVote from a
    soliciting candidate, AppendEntries on the leader's cadence."""
    n = cfg.n_nodes
    B = row.term.shape[0]
    dev = row.term.device
    valid = (solicit | hb_due).to(_I32)
    type_ = sel(solicit, T_REQ_VOTE, T_APPEND)
    my_llt = sel(row.log_len > 0, tget(row.log_term, row.log_len - 1), 0)
    slots = torch.arange(n - 1, dtype=_I32, device=dev)[None, :]
    peers = torch.where(slots >= node_idx[:, None], slots + 1,
                        slots.expand(B, -1))                   # [B, n-1]
    prev_idx = tget(row.next_idx, peers)                       # [B, n-1]
    has_entry = (row.log_len[:, None] > prev_idx).to(_I32)
    sol = solicit[:, None]
    b4 = torch.where(sol, 0, has_entry)
    entry = tget(row.log_body, prev_idx) * b4[..., None]       # [B, n-1, E]
    out = torch.zeros((B, n - 1, cfg.lanes), dtype=_I32, device=dev)
    out[..., wire.VALID] = valid[:, None]
    out[..., wire.SRC] = node_idx[:, None]
    out[..., wire.DEST] = peers
    out[..., wire.TYPE] = type_[:, None]
    out[..., wire.ORIGIN] = node_idx[:, None]
    out[..., wire.BODY] = row.term[:, None]
    out[..., wire.BODY + 1] = torch.where(sol, row.log_len[:, None],
                                          prev_idx)
    prev_term = torch.where(prev_idx > 0, tget(row.log_term, prev_idx - 1),
                            0)
    out[..., wire.BODY + 2] = torch.where(sol, my_llt[:, None], prev_term)
    out[..., wire.BODY + 3] = torch.where(sol, 0, row.commit_idx[:, None])
    out[..., wire.BODY + 4] = b4
    out[..., wire.BODY + 5] = torch.where(sol, 0,
                                          tget(row.log_term, prev_idx))
    out[..., wire.BODY + 6:wire.BODY + 6 + model.entry_lanes] = entry
    return out
