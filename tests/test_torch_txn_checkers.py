"""The transactional workloads through both harnesses and the CLI.

``run_torch_test(device="cpu")`` against ``run_tpu_test`` on the cases
of ``torch_txn_cases.py`` (txn-list-append and txn-rw-register over
Raft, under a crash and links plan, both dirty-apply mutants) and under
the ``read-uncommitted`` model: identical histories, Elle reports
(``anomaly-types``, ``anomalies``, ``txn-count``,
``consistency-model``), verdicts, invariants and network counters. The
CLI runs both workloads with ``--key-count``, ``--consistency-models``
and ``--txn-dirty-apply``, and refuses flags of other workloads.
``slow``: the dirty-apply mutants caught under the JAX tests'
leader-isolation schedule with the JAX run's anomaly kinds, the correct
models valid on it."""

import json
import os

import pytest

from maelstrom_tpu.tpu.harness import run_tpu_test
from maelstrom_tpu_torch import harness

from torch_txn_cases import JAX_RUN, TXN, TXN_CASES, models
from torch_tutorial_cases import one_torch_thread  # noqa: F401 (autouse)

HARNESS_CASES = dict(TXN_CASES, **{
    "txn-list-append-read-uncommitted": (
        "txn-list-append", {}, dict(TXN, consistency_models=
                                    "read-uncommitted"))})


@pytest.mark.parametrize("name", list(HARNESS_CASES))
def test_run_matches_jax_harness(name, tmp_path):
    case = HARNESS_CASES[name]
    jmodel, model = models(case)
    opts = case[2]
    jres = run_tpu_test(jmodel, dict(opts, **JAX_RUN,
                                     store_root=str(tmp_path / "jax")))
    tres = harness.run_torch_test(model, dict(
        opts, store_root=str(tmp_path / "torch")), device="cpu")
    assert tres["net"] == {k: jres["net"][k] for k in tres["net"]}
    assert tres["valid?"] == jres["valid?"]
    assert {k: tres["invariants"][k] for k in jres["invariants"]} == \
        jres["invariants"]
    for i in range(opts["record_instances"]):
        with open(os.path.join(jres["store-dir"], f"history-{i}.jsonl")) \
                as f:
            jh = f.read()
        with open(os.path.join(tres["store-dir"], f"history-{i}.jsonl")) \
                as f:
            assert f.read() == jh, f"{name}: history {i}"
    strip = lambda r: {k: v for k, v in r.items() if k != "instance"}
    assert [strip(r) for r in tres["instances"]] == \
        [strip(r) for r in jres["instances"]]
    want = opts.get("consistency_models", "strict-serializable")
    for r in tres["instances"]:
        assert {"anomaly-types", "anomalies", "txn-count"} <= set(r), r
        assert r["consistency-model"] == want
    assert sum(r["txn-count"] for r in tres["instances"]) > 0
    # the copied checker on the recorded histories, beside the JAX one
    jcheck, tcheck = jmodel.checker(), model.checker()
    for i in range(opts["record_instances"]):
        with open(os.path.join(tres["store-dir"], f"history-{i}.jsonl")) \
                as f:
            h = [json.loads(line) for line in f]
        assert tcheck(h, opts) == jcheck(h, opts)


# --- the CLI -----------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["-w", "txn-list-append"],
    ["-w", "txn-rw-register", "--key-count", "4"],
    ["-w", "txn-list-append", "--consistency-models", "read-committed"],
])
def test_cli_runs_txn_workloads(argv, tmp_path, capsys):
    from maelstrom_tpu_torch.__main__ import main
    rc = main(["test", *argv, "--node-count", "3", "--n-instances", "2",
               "--record-instances", "1", "--time-limit", "0.15",
               "--recovery-time", "0.05", "--store", str(tmp_path),
               "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out["valid?"] is True, out
    with open(os.path.join(out["store-dir"], "results.json")) as f:
        inst = json.load(f)["instances"][0]
    assert inst["consistency-model"] == (
        "read-committed" if "--consistency-models" in argv
        else "strict-serializable")


def test_cli_txn_dirty_apply_flag(tmp_path, capsys):
    """The flag selects the mutant, which carries its own name."""
    from maelstrom_tpu_torch.__main__ import main
    main(["test", "-w", "txn-list-append", "--txn-dirty-apply",
          "--node-count", "3", "--n-instances", "2", "--record-instances",
          "1", "--time-limit", "0.15", "--recovery-time", "0.05", "--store",
          str(tmp_path), "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert "txn-list-append-bug-dirty-apply-torch" in out["store-dir"]
    assert out["net"]["delivered"] > 0


@pytest.mark.parametrize("argv,err", [
    (["-w", "txn-list-append", "--crash-clients"], "kafka option"),
    (["-w", "lin-kv", "--txn-dirty-apply"], "dirty-apply mutant"),
])
def test_cli_refuses_flags_of_other_workloads(argv, err):
    from maelstrom_tpu_torch.__main__ import main
    with pytest.raises(ValueError, match=err):
        main(["test", *argv, "--device", "cpu"])


# --- slow: the mutants caught, at the JAX tests' sizes ----------------------


def _isolation_opts():
    from test_tpu_txn import _leader_isolation_schedule
    sched, horizon = _leader_isolation_schedule()
    return dict(node_count=3, concurrency=4, n_instances=8,
                record_instances=8, time_limit=horizon, rate=60.0,
                latency=5.0, rpc_timeout=0.8, nemesis=["partition"],
                nemesis_kind="scripted", nemesis_schedule=sched,
                recovery_time=0.5, seed=3)


def _kinds(res):
    return set().union(*(set(r.get("anomaly-types") or [])
                         for r in res["instances"]))


@pytest.mark.slow
@pytest.mark.parametrize("workload,caught", [
    ("txn-list-append", {"lost-append", "incompatible-order"}),
    ("txn-rw-register", None)])
def test_dirty_apply_caught_like_jax(workload, caught):
    """The dirty-apply mutant under the leader-isolation schedule: not
    valid, with the JAX run's anomaly kinds; the correct model valid on
    the same schedule."""
    from maelstrom_tpu.models import get_model as jget_model
    from maelstrom_tpu_torch.models import get_model
    opts = _isolation_opts()
    for dirty in (True, False):
        mopts = {"txn_dirty_apply": dirty}
        jres = run_tpu_test(jget_model(workload, 3, opts=mopts),
                            dict(opts, **JAX_RUN))
        tres = harness.run_torch_test(get_model(workload, 3, opts=mopts),
                                      dict(opts, txn_dirty_apply=dirty),
                                      device="cpu")
        assert tres["valid?"] is (not dirty) and jres["valid?"] is \
            (not dirty)
        assert tres["net"] == {k: jres["net"][k] for k in tres["net"]}
        assert _kinds(tres) == _kinds(jres)
        if dirty and caught:
            assert _kinds(tres) & caught, _kinds(tres)
