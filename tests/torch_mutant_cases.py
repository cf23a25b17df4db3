"""The configurations and comparisons shared by ``test_torch_mutants.py``,
``test_torch_funnel.py`` and ``test_torch_store.py``: each lin-kv Raft
mutant under the JAX package's own configuration that catches it, cut in
depth where the tier-1 budget needs it, and both harnesses run on it.

Tolerance: exact. The results blocks (verdicts, invariants, checker
errors, fail-fast, availability, telemetry, funnel) must be equal, and
the stored histories and funnel histories byte-equal."""

import os

from maelstrom_tpu.models import get_model as jget_model
from maelstrom_tpu.tpu.harness import run_tpu_test
from maelstrom_tpu_torch import harness
from maelstrom_tpu_torch.fleets import rotating_majorities
from maelstrom_tpu_torch.models import get_model

from test_faults import CRASH_OPTS, LINK_OPTS, SKEW_OPTS
from test_membership import SQ_OPTS, VBC_OPTS
from test_tpu_raft import BUG_OPTS
from torch_tutorial_cases import JAX_RUN
from torch_tutorial_cases import one_torch_thread  # noqa: F401 (re-exported)


# test_tpu_raft.FIGURE8_OPTS (64 instances, its schedule in 200-tick
# phases, 3.5 s) cut to 32 instances and 0.6 s with 100-tick phases
# (healed at tick 500), and the fault tests' small pool and inbox (24
# slots, inbox_k 2)
FIGURE8 = dict(node_count=5, concurrency=4, n_instances=32,
               record_instances=4, time_limit=0.6, rate=60.0, latency=5.0,
               rpc_timeout=0.8, nemesis=["partition"],
               nemesis_kind="scripted",
               nemesis_schedule=rotating_majorities(), recovery_time=0.1,
               seed=11, funnel_max=4, inbox_k=2, pool_slots=24)
# BUG_OPTS at 32 instances, 4 recorded, cut from 2.5 s to 0.4 s
DOUBLE_VOTE = dict(BUG_OPTS, n_instances=32, record_instances=4,
                   time_limit=0.4)

# mutant -> (node count, options): the JAX tests' catching configs
CASES = {
    "double-vote": (3, DOUBLE_VOTE),
    # test_faults.LINK_OPTS: every server edge slow and lossy; WGL
    # catches the stale reads
    "stale-read": (3, LINK_OPTS),
    "no-term-guard": (5, FIGURE8),
    # test_tpu_raft's short-log-wins run (BUG_OPTS at 48 instances, 3 s,
    # seed 5) cut to 32 instances and 0.6 s, seed 2, the small pool
    "short-log-wins": (3, dict(BUG_OPTS, n_instances=32,
                               record_instances=4, time_limit=0.6,
                               seed=2, funnel_max=4, inbox_k=2,
                               pool_slots=24)),
    # 0.4 s with 60-tick phases (healed at tick 300)
    "eager-commit": (5, dict(FIGURE8, time_limit=0.4,
                             nemesis_schedule=rotating_majorities(
                                 5, 60, 300))),
    # test_faults.CRASH_OPTS: a crashed majority reboots amnesiac
    "forget-snapshot": (3, CRASH_OPTS),
    # test_faults.SKEW_OPTS: lockstep election timeouts, no leader; the
    # availability checker flags it
    "fixed-timeout": (3, SKEW_OPTS),
    "single-quorum-reconfig": (3, SQ_OPTS),
    "votes-before-catchup": (5, VBC_OPTS),
}

# the JAX results' keys the port must equal (all but perf and the store
# directory), in the JAX harness's order
COMPARED = ("valid?", "invariants", "instance-count", "checked-instances",
            "valid-instances", "checker-errors", "instances", "net",
            "fail-fast", "telemetry", "availability", "funnel")


def run_both(workload, node_count, opts, tmp_path):
    """``run_tpu_test`` and ``run_torch_test(device="cpu")`` on one
    configuration, each storing under ``tmp_path``; the heartbeat as
    the options say (on by default in both harnesses)."""
    jres = run_tpu_test(jget_model(workload, node_count),
                        {**opts, **JAX_RUN,
                         "heartbeat": opts.get("heartbeat", True),
                         "store_root": str(tmp_path / "jax")})
    tres = harness.run_torch_test(
        get_model(workload, node_count),
        dict(opts, store_root=str(tmp_path / "torch")), device="cpu")
    return jres, tres


def assert_results_equal(jres, tres, name=""):
    """Every compared block equal, in the JAX harness's key order."""
    jkeys = [k for k in jres if k not in ("perf", "store-dir")]
    assert set(jkeys) <= set(COMPARED), set(jkeys) - set(COMPARED)
    assert [k for k in tres if k in COMPARED] == jkeys, name
    for k in jkeys:
        assert tres[k] == jres[k], f"{name}: {k} differs"


def read(run_dir, name):
    with open(os.path.join(run_dir, name), "rb") as f:
        return f.read()


def assert_funnel_histories_equal(jres, tres, name=""):
    """Each replayed instance's stored history byte-equal."""
    ids = jres.get("funnel", {}).get("ids", [])
    for iid in ids:
        f = f"funnel-history-{iid}.jsonl"
        assert read(tres["store-dir"], f) == read(jres["store-dir"], f), \
            f"{name}: {f}"
    listed = lambda d: sorted(f for f in os.listdir(d)
                              if f.startswith("funnel-history-"))
    assert listed(tres["store-dir"]) == listed(jres["store-dir"])
    return ids
