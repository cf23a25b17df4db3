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

import torch

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


# --- trace-hygiene lint fixtures -------------------------------------------
#
# The mutants above are PROTOCOL bugs: shape-correct torch that encodes a
# wrong algorithm — the checkers' prey. The class below is the OTHER bug
# family, the one `lint` (analysis/trace_lint.py) exists to catch before
# a card run: host syncs and Python control flow on device values, hidden
# mutable state, data-dependent shapes and draws from a global generator
# inside the tick, one per TRC rule. It is NOT in BUGGY_MODELS and must
# never be registered; tests/test_torch_lint.py asserts the linter flags
# every hazard, and analysis/baseline.json carries the findings as
# status="expected" (visible, never silently baselined).

_GOSSIP_LOG = []    # module state the tick must not touch


class RaftTracedHazards(RaftModel):
    """LINT FIXTURE (do not register): every TRC-rule hazard in one tick."""
    name = "lin-kv-lint-fixture-traced-hazards"
    # STATICALLY-LINTED-ONLY: the raft family speaks the fused protocol,
    # so a run never calls this legacy tick hook; fused_node=False keeps
    # the override on the linter's surface, as in the JAX fixture.
    fused_node = False

    def tick(self, row, node_idx, t, keys, cfg, params):
        if (row.term > 0).any():                       # TRC101 branch
            row = row._replace(
                term=row.term + int(row.commit_idx[0]))   # TRC104 host sync
        while row.log_len.max() > 0:                   # TRC102 while
            break
        assert (row.commit_idx >= 0).all()             # TRC103 assert
        _GOSSIP_LOG.append(t)                          # TRC105 capture
        jitter = torch.randint(0, 3, (1,))             # TRC107 global rng
        hot = torch.nonzero(row.match_idx)             # TRC106 data-dep
        del jitter, hot
        return super().tick(row, node_idx, t, keys, cfg, params)


LINT_FIXTURE_MODELS = {"traced-hazards": RaftTracedHazards}
