"""The nine lin-kv Raft mutants of the port against the JAX package's.

The registry builds every mutant as the JAX registry does (same name,
same correctness switches, same election jitter), and each mutant run
under the JAX tests' configuration that catches it gives the JAX
harness's results exactly: verdicts, invariants, availability, funnel,
fail-fast and telemetry blocks, and byte-equal funnel histories. The
membership mutants, fail-fast and checker errors are in
``test_torch_funnel.py``, the Figure-8 mutants and the carries tick by
tick in ``test_torch_mutant_carry.py``, double-vote's store in
``test_torch_store.py``."""

import pytest

from maelstrom_tpu.models import get_model as jget_model
from maelstrom_tpu.models.raft_buggy import BUGGY_MODELS as JBUGGY
from maelstrom_tpu_torch.models import MUTANTS, get_model
from maelstrom_tpu_torch.models.raft_buggy import BUGGY_MODELS

from torch_mutant_cases import (CASES, assert_funnel_histories_equal,
                                assert_results_equal, run_both)
from torch_mutant_cases import one_torch_thread  # noqa: F401 (autouse)

SWITCHES = ("vote_check_voted_for", "vote_check_log",
            "vote_check_log_index", "serve_reads_locally",
            "commit_term_guard", "commit_quorum", "apply_uncommitted",
            "joint_dual_quorum", "join_requires_catchup",
            "recovers_snapshot", "elect_min", "elect_jitter", "heartbeat",
            "log_cap", "n_keys", "n_vals", "apply_max", "n_nodes_hint")


@pytest.mark.parametrize("kind", list(JBUGGY))
def test_registry_builds_each_mutant_as_jax_does(kind):
    name = f"lin-kv-bug-{kind}"
    for n in (3, 5):
        jm, m = jget_model(name, n), get_model(name, n)
        assert type(m) is BUGGY_MODELS[kind]
        assert m.name == jm.name == name
        for s in SWITCHES:
            assert getattr(m, s) == getattr(jm, s), (name, s)
    assert name in MUTANTS


def test_mutant_corpus_is_jax_corpus():
    assert tuple(BUGGY_MODELS) == tuple(JBUGGY)
    assert get_model("lin-kv-bug-fixed-timeout", 3).elect_jitter == 1
    # the lint fixture of the JAX corpus is never registered
    with pytest.raises(ValueError, match="not ported"):
        get_model("lin-kv-lint-fixture-traced-hazards", 3)


@pytest.mark.parametrize("kind", ["stale-read", "short-log-wins",
                                  "forget-snapshot", "fixed-timeout"])
def test_mutant_matches_jax_harness(kind, tmp_path):
    n, opts = CASES[kind]
    jres, tres = run_both(f"lin-kv-bug-{kind}", n, opts, tmp_path)
    # the configuration catches the mutant
    assert jres["valid?"] is False
    assert_results_equal(jres, tres, kind)
    ids = assert_funnel_histories_equal(jres, tres, kind)
    if "funnel" in jres:
        assert tres["funnel"]["replayed-violating"] == len(ids) > 0
    if kind == "fixed-timeout":
        assert tres["availability"]["valid?"] is False
        assert tres["availability"]["ok-count"] == 0
    if kind == "stale-read":
        assert tres["valid-instances"] < tres["checked-instances"]
