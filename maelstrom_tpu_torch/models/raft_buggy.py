"""Deliberately broken Raft variants — the bug-injection corpus.

Counterpart of ``maelstrom_tpu/models/raft_buggy.py``: each mutant flips
one of :class:`~.raft.RaftModel`'s correctness switches (read by the
node step in :mod:`.raft_core` and by the restart and join hooks of
:mod:`.raft`), or, for the fixed-timeout mutant, its election jitter.
The checkers, the on-device invariants and the availability checker
are what catch them; the JAX package's tests name the configuration
that catches each one.

- :class:`RaftDoubleVote` — votes ignore ``voted_for`` and log recency:
  two leaders per term.
- :class:`RaftStaleRead` — any node answers reads from its local KV.
- :class:`RaftNoTermGuard` — commit without the current-term guard (the
  Raft §5.4.2 Figure-8 trap; caught under the scripted
  rotating-majorities schedule).
- :class:`RaftShortLogWins` — vote recency compares last-log terms only.
- :class:`RaftEagerCommit` — the leader commits at the max match index.
- :class:`RaftForgetsSnapshot` — crash-restart ignores the snapshot slab.
- :class:`RaftFixedTimeout` — election timeouts without jitter: nodes
  time out in lockstep and no leader is elected (the availability
  checker flags the livelock).
- :class:`RaftSingleQuorumReconfig` — joint-consensus elections and
  commits count only the new configuration's quorum.
- :class:`RaftVotesBeforeCatchup` — a joining node votes with an empty
  log instead of waiting for catch-up.
"""

from __future__ import annotations

from .raft import RaftModel


class RaftDoubleVote(RaftModel):
    """Election safety broken: voted_for / log recency never consulted."""
    name = "lin-kv-bug-double-vote"
    vote_check_voted_for = False
    vote_check_log = False


class RaftStaleRead(RaftModel):
    """Linearizable reads broken: any node answers reads locally."""
    name = "lin-kv-bug-stale-read"
    serve_reads_locally = True


class RaftNoTermGuard(RaftModel):
    """Commit safety broken: no current-term guard on the median commit."""
    name = "lin-kv-bug-no-term-guard"
    commit_term_guard = False


class RaftShortLogWins(RaftModel):
    """Vote recency broken: candidates are judged on last-log term only,
    never log length."""
    name = "lin-kv-bug-short-log-wins"
    vote_check_log_index = False


class RaftForgetsSnapshot(RaftModel):
    """Crash-restart durability broken: restart cold-boots with term 0,
    no vote, an empty log and a blank KV."""
    name = "lin-kv-bug-forget-snapshot"
    recovers_snapshot = False


class RaftFixedTimeout(RaftModel):
    """Randomized election timeouts removed: every node draws a zero
    jitter, so election deadlines collide forever."""
    name = "lin-kv-bug-fixed-timeout"

    def __init__(self, n_nodes_hint: int = 5, **kw):
        kw["elect_jitter"] = 1   # randint(0, 1) == 0 always
        super().__init__(n_nodes_hint=n_nodes_hint, **kw)


class RaftEagerCommit(RaftModel):
    """Commit quorum broken: the leader advances commit_idx to the max
    match index instead of the majority median."""
    name = "lin-kv-bug-eager-commit"
    commit_quorum = False


class RaftSingleQuorumReconfig(RaftModel):
    """Joint consensus broken: during a C_old,new phase, elections and
    commits count only the new configuration's quorum."""
    name = "lin-kv-bug-single-quorum-reconfig"
    joint_dual_quorum = False


class RaftVotesBeforeCatchup(RaftModel):
    """Join catch-up broken: a joining node grants votes and stands for
    election with an empty log."""
    name = "lin-kv-bug-votes-before-catchup"
    join_requires_catchup = False


BUGGY_MODELS = {
    "double-vote": RaftDoubleVote,
    "stale-read": RaftStaleRead,
    "no-term-guard": RaftNoTermGuard,
    "short-log-wins": RaftShortLogWins,
    "eager-commit": RaftEagerCommit,
    "forget-snapshot": RaftForgetsSnapshot,
    "fixed-timeout": RaftFixedTimeout,
    "single-quorum-reconfig": RaftSingleQuorumReconfig,
    "votes-before-catchup": RaftVotesBeforeCatchup,
}
