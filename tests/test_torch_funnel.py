"""The run around the tick against the JAX harness: the invariant-trip
funnel, fail-fast and checker errors.

- The membership mutants give the JAX harness's results and funnel
  histories exactly.
- Fail-fast on a multi-chunk horizon stops at JAX's tick: one chunk
  past the chunk whose end-of-chunk scan first shows a trip.
- A checker that raises is counted in ``checker-errors`` as JAX counts
  it (the same raising checker patched into both packages).

Tolerance: exact."""

import pytest

from maelstrom_tpu.models.raft import RaftModel as JRaftModel
from maelstrom_tpu_torch.models.raft import RaftModel

from torch_mutant_cases import (CASES, DOUBLE_VOTE,
                                assert_funnel_histories_equal,
                                assert_results_equal, run_both)
from torch_mutant_cases import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("kind", ["single-quorum-reconfig",
                                  "votes-before-catchup"])
def test_mutant_matches_jax_harness(kind, tmp_path):
    n, opts = CASES[kind]
    jres, tres = run_both(f"lin-kv-bug-{kind}", n, opts, tmp_path)
    assert jres["valid?"] is False
    assert_results_equal(jres, tres, kind)
    ids = assert_funnel_histories_equal(jres, tres, kind)
    # the replay tripped the same instances again
    assert tres["funnel"]["replayed-violating"] == len(ids) > 0
    assert len(ids) == min(opts["funnel_max"],
                           tres["invariants"]["violating-instances"])


def test_fail_fast_stops_at_jax_tick(tmp_path):
    """300 ticks in 50-tick chunks: the stop comes one chunk after the
    chunk holding the earliest trip, the funnel still replays the full
    planned horizon, and perf counts the ticks that ran."""
    opts = dict(DOUBLE_VOTE, time_limit=0.3, chunk_ticks=50,
                fail_fast=True, funnel_max=3)
    jres, tres = run_both("lin-kv-bug-double-vote", 3, opts, tmp_path)
    assert_results_equal(jres, tres, "fail-fast")
    assert_funnel_histories_equal(jres, tres, "fail-fast")
    ff = tres["fail-fast"]
    assert ff["stopped"] is True and ff["ticks-planned"] == 300
    first = ff["first-violation"]["tick"]
    assert ff["ticks-dispatched"] == min(300, (first // 50 + 2) * 50) < 300
    assert tres["perf"]["ticks"] == ff["ticks-dispatched"]
    assert tres["perf"]["phases"]["pipeline"]["stopped-early"] is True
    assert [v["tick"] for v in ff["violations"]] == sorted(
        v["tick"] for v in ff["violations"])


def test_checker_errors_match_jax(tmp_path, monkeypatch):
    """The same checker, raising on every history of an even number of
    records, patched into both packages' Raft model."""
    from maelstrom_tpu.checkers.linearizable import linearizable_kv_checker

    def flaky(history, opts):
        if len(history) % 2 == 0:
            raise RuntimeError(f"checker blew up on {len(history)} records")
        return linearizable_kv_checker(history)

    for cls in (JRaftModel, RaftModel):
        monkeypatch.setattr(cls, "checker", lambda self: flaky)
    opts = dict(DOUBLE_VOTE, time_limit=0.2, record_instances=6,
                funnel_max=2)
    jres, tres = run_both("lin-kv-bug-double-vote", 3, opts, tmp_path)
    assert_results_equal(jres, tres, "checker-errors")
    assert 0 < tres["checker-errors"] == sum(
        1 for r in tres["instances"] if "traceback" in r)
    assert tres["checker-errors"] < tres["checked-instances"]
