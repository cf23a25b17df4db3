"""The Figure-8 mutants against the JAX runtime: the carry tick by tick,
and both harnesses on the scripted rotating-majorities schedule.

- The port's carry and events equal JAX's ``canonical_carry`` and events
  after every tick for double-vote (``BUG_OPTS``) and for no-term-guard
  under the scripted rotating-majorities schedule; halfway, a JAX carry
  handed to the port steps on identically.
- no-term-guard and eager-commit on the shortened Figure-8 schedule give
  the JAX harness's results and funnel histories exactly.

Tolerance: exact."""

import pytest

from maelstrom_tpu_torch.fleets import rotating_majorities

from torch_mutant_cases import (CASES, DOUBLE_VOTE, FIGURE8,
                                assert_funnel_histories_equal,
                                assert_results_equal, run_both)
from torch_mutant_cases import one_torch_thread  # noqa: F401 (autouse)
from torch_txn_cases import carry_matches_jax_every_tick

# 200 ticks each; double-vote trips at ticks 86 and 118 in instances 4
# and 5 of these 16
CARRY_CASES = {
    "double-vote": ("lin-kv-bug-double-vote", {},
                    dict(DOUBLE_VOTE, n_instances=16, time_limit=0.2)),
    # the rotating majorities in 40-tick phases until tick 160
    "no-term-guard-figure8": (
        "lin-kv-bug-no-term-guard", {},
        dict(FIGURE8, n_instances=16, time_limit=0.2, recovery_time=0.03,
             nemesis_schedule=rotating_majorities(5, 40, 160))),
}


@pytest.mark.parametrize("name", list(CARRY_CASES))
def test_carry_matches_jax_every_tick(name):
    carry = carry_matches_jax_every_tick(name, CARRY_CASES[name])
    if name == "double-vote":
        assert int((carry.violations > 0).sum()) > 0
    else:
        assert int(carry.stats.dropped_partition) > 0


@pytest.mark.parametrize("kind", ["no-term-guard", "eager-commit"])
def test_mutant_matches_jax_harness(kind, tmp_path):
    n, opts = CASES[kind]
    jres, tres = run_both(f"lin-kv-bug-{kind}", n, opts, tmp_path)
    assert jres["valid?"] is False
    assert_results_equal(jres, tres, kind)
    ids = assert_funnel_histories_equal(jres, tres, kind)
    assert tres["funnel"]["replayed-violating"] == len(ids) > 0
