"""kafka of the port against the JAX package: the model with and without
``crash_clients``, both mutants, the copied kafka checker and the CLI.

At the bench's kafka settings cut to test size (1 node, 6 clients, 8
instances, 150 ticks, 5% loss; ``torch_txn_cases.py``): the port's
carry equals the JAX ``make_tick_fn`` carry after every tick, every
leaf, and so do the recorded events (tolerance 0). The wide
client-event path (4-lane op rows, 25 value lanes) equals JAX's
``client_step`` on a reply, an error reply, a timeout and an
invocation. ``run_torch_test(device="cpu")`` gives ``run_tpu_test``'s
histories, checker reports, verdicts, invariants and network counters.
The copied checker gives the JAX checker's report on hand-made
histories that reach each rule, and ``mark_reassigned_after_crashes``
the JAX one's history. The CLI runs kafka with ``--crash-clients`` and
refuses ``--txn``, ``--crash-clients`` on lin-kv and more clients than
the model's cursors. ``slow``: the mutants caught at the JAX tests'
sizes."""

import json
import os

import numpy as np
import pytest

from maelstrom_tpu.tpu.harness import run_tpu_test
from maelstrom_tpu_torch import harness
from maelstrom_tpu_torch.models import get_model

from torch_txn_cases import (JAX_RUN, KAFKA_CASES,
                             carry_matches_jax_every_tick, client_step_pair,
                             models)
from torch_tutorial_cases import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("name", list(KAFKA_CASES))
def test_carry_matches_jax_every_tick(name):
    carry = carry_matches_jax_every_tick(name, KAFKA_CASES[name])
    assert int(carry.node_state.log_len.sum()) > 0


@pytest.mark.parametrize("name,reply_types,etypes", [
    ("kafka", (31, 33), [2, 2]), ("kafka-crash-clients", (35, 39), [2, 4])])
def test_client_step_wide_matches_jax(name, reply_types, etypes):
    """send_ok and poll_ok, then commit_ok and crash_ok (not an ok type:
    info), error replies, a timeout and an invocation."""
    case = KAFKA_CASES[name]
    jmodel, model = models(case)
    assert model.ev_vals == 25 and model.op_lanes == 4
    (jcs, jreqs, jev), (cs, reqs, ev) = client_step_pair(
        jmodel, model, case[2], reply_types, seed=1)
    np.testing.assert_array_equal(jev, ev)
    np.testing.assert_array_equal(jreqs, reqs)
    for a, b in zip(jcs, cs):
        np.testing.assert_array_equal(a, b)
    # a timed-out completion pads the 4-lane op row with 21 zeros
    assert (ev[:, 2, 0, 5:1 + 25] == 0).all()
    assert ev[:, 0, 0, 0].tolist() == etypes


@pytest.mark.parametrize("name", list(KAFKA_CASES))
def test_run_matches_jax_harness(name, tmp_path):
    case = KAFKA_CASES[name]
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
    hist = []
    for i in range(opts["record_instances"]):
        with open(os.path.join(jres["store-dir"], f"history-{i}.jsonl")) \
                as f:
            jh = f.read()
        with open(os.path.join(tres["store-dir"], f"history-{i}.jsonl")) \
                as f:
            assert f.read() == jh, f"{name}: history {i}"
        hist.append([json.loads(line) for line in jh.splitlines()])
    strip = lambda r: {k: v for k, v in r.items() if k != "instance"}
    assert [strip(r) for r in tres["instances"]] == \
        [strip(r) for r in jres["instances"]]
    assert sum(r["send-count"] for r in tres["instances"]) > 0
    fs = {r["f"] for h in hist for r in h}
    assert ("crash" in fs) == bool(opts.get("crash_clients"))
    jcheck, tcheck = jmodel.checker(), model.checker()
    for h in hist:
        assert tcheck(h, opts) == jcheck(h, opts)


# --- the copied checker on hand-made histories -------------------------------


def _ops(*rows):
    """History records from ``(process, type, f, value)`` rows."""
    return [{"process": p, "type": typ, "f": f, "value": v, "index": i,
             "time": i} for i, (p, typ, f, v) in enumerate(rows)]


def _poll(p, msgs):
    return ((p, "invoke", "poll", None), (p, "ok", "poll", msgs))


def _send(p, k, v, off):
    return ((p, "invoke", "send", [k, v]), (p, "ok", "send", [k, v, off]))


HISTORIES = {
    "clean": _ops(*_send(0, 0, 1, 0), *_send(0, 0, 2, 1),
                  *_poll(1, {0: [[0, 1], [1, 2]]})),
    "duplicate-offset": _ops(*_send(0, 0, 1, 0), *_send(1, 0, 2, 0)),
    "inconsistent-offset": _ops(*_poll(0, {0: [[0, 7]]}),
                                *_poll(1, {0: [[0, 8]]})),
    "lost-write": _ops(*_send(0, 0, 1, 0), *_send(0, 0, 2, 1),
                       *_poll(1, {0: [[1, 2]]})),
    "internal-nonmonotonic": _ops(*_poll(1, {0: [[3, 5], [2, 4]]})),
    "external-nonmonotonic": _ops(*_poll(1, {0: [[0, 5], [1, 6]]}),
                                  *_poll(1, {0: [[0, 5]]})),
    "commit-regression": _ops(
        (0, "invoke", "list_committed_offsets", [0]),
        (0, "ok", "list_committed_offsets", {0: 4}),
        (1, "invoke", "list_committed_offsets", [0]),
        (1, "ok", "list_committed_offsets", {0: 2})),
    "aborted-read": _ops((0, "invoke", "send", [0, 9]),
                         (0, "fail", "send", [0, 9]),
                         *_poll(1, {0: [[0, 9]]})),
    # a crash, then a poll that jumps back to the committed offsets
    "crash-then-backwards-poll": _ops(
        *_poll(1, {0: [[0, 5], [1, 6], [2, 7]]}),
        (1, "invoke", "crash", None), (1, "info", "crash", None),
        *_poll(1, {0: [[1, 6]]})),
}


@pytest.mark.parametrize("mark", [False, True])
@pytest.mark.parametrize("name", list(HISTORIES))
def test_kafka_checker_matches_jax(name, mark):
    from maelstrom_tpu.checkers.kafka import kafka_checker as jcheck
    from maelstrom_tpu.checkers.kafka import \
        mark_reassigned_after_crashes as jmark
    from maelstrom_tpu_torch.checkers.kafka import (
        kafka_checker, mark_reassigned_after_crashes)
    h = HISTORIES[name]
    if mark:
        marked = mark_reassigned_after_crashes(h)
        assert marked == jmark(h)
        assert h == HISTORIES[name]     # records copied, not mutated
        h = marked
    got = kafka_checker(h)
    assert got == jcheck(h)
    if name == "crash-then-backwards-poll":
        assert got["valid?"] is mark
        assert mark or got["anomaly-types"] == ["external-nonmonotonic"]
    else:
        assert got["valid?"] is (name == "clean")
        if name != "clean":
            assert got["anomaly-types"] == [name]


# --- the CLI -----------------------------------------------------------------


@pytest.mark.parametrize("flags", [[], ["--crash-clients"]])
def test_cli_runs_kafka(flags, tmp_path, capsys):
    from maelstrom_tpu_torch.__main__ import main
    rc = main(["test", "-w", "kafka", *flags, "--node-count", "1",
               "--concurrency", "4", "--n-instances", "2",
               "--record-instances", "2", "--time-limit", "0.15",
               "--rpc-timeout", "0.25", "--store", str(tmp_path),
               "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out["valid?"] is True, out
    with open(os.path.join(out["store-dir"], "history-0.jsonl")) as f:
        fs = {json.loads(line)["f"] for line in f}
    assert {"send", "poll"} <= fs


# a small run both CLIs take with the same options
CLI_RUN = ["--concurrency", "4", "--n-instances", "2",
           "--record-instances", "2", "--time-limit", "0.15", "--rate",
           "100", "--latency", "5", "--rpc-timeout", "0.25",
           "--nemesis-interval", "0.5", "--recovery-time", "0.05",
           "--seed", "3", "--no-heartbeat"]


def cli_matches_jax(argv, note, tmp_path, capsys):
    """``test ARGV`` on the port's CLI and on the JAX CLI's device
    runtime: both print ``note`` to standard error, run, and exit 0 with
    the same verdict and network counters."""
    from maelstrom_tpu.cli import main as jmain
    from maelstrom_tpu_torch.__main__ import main
    rc = main(["test", *argv, *CLI_RUN, "--store", str(tmp_path / "t"),
               "--device", "cpu"])
    cap = capsys.readouterr()
    jrc = jmain(["test", "--runtime", "tpu", *argv, *CLI_RUN,
                 "--device-profile", "off", "--store",
                 str(tmp_path / "j")])
    jcap = capsys.readouterr()
    assert note in cap.err and note in jcap.err
    out = json.loads(cap.out)
    jout = json.loads(jcap.out.split("\n\n")[0])
    assert rc == jrc == 0
    assert out["valid?"] is jout["valid?"] is True
    assert out["net"] == jout["net"] and out["net"]["delivered"] > 0


@pytest.mark.parametrize("argv,err", [
    pytest.param(["-w", "kafka", "--node-count", "1", "--txn"],
                 "note: --txn has no effect on the TPU runtime yet "
                 "(kafka transactions are process/native-runtime "
                 "features; use --runtime native)",
                 id="argv0-kafka transactions"),
    pytest.param(["-w", "lin-kv", "--node-count", "3", "--crash-clients"],
                 "note: --crash-clients has no effect on the TPU lin-kv "
                 "runtime (kafka-only)", id="argv1-kafka option"),
    pytest.param(["-w", "kafka", "--node-count", "1", "--concurrency", "9"],
                 "MAX_CLIENTS=8", id="argv2-MAX_CLIENTS=8"),
])
def test_cli_refuses(argv, err, tmp_path, capsys):
    """What the JAX package refuses the port refuses (nine kafka
    clients); a flag the JAX device runtime notes and ignores (kafka's
    ``--txn``, ``--crash-clients`` on lin-kv) gets JAX's note, and the
    run goes on without it and exits as the JAX CLI does."""
    from maelstrom_tpu_torch.__main__ import main
    if not err.startswith("note:"):
        with pytest.raises(ValueError, match=err):
            main(["test", *argv, "--device", "cpu"])
        return
    cli_matches_jax(argv, err, tmp_path, capsys)
    with pytest.raises(ValueError, match="kafka option"):
        # the harness keeps its refusal: the CLI drops the flag first
        harness.run_torch_test(get_model("lin-kv", 3),
                               {"crash_clients": True}, device="cpu")


# --- slow: the mutants caught, at the JAX tests' sizes ----------------------

KAFKA_OPTS = dict(node_count=1, concurrency=4, n_instances=8,
                  record_instances=8, time_limit=3.0, rate=40.0,
                  latency=5.0, rpc_timeout=0.8, p_loss=0.05,
                  recovery_time=0.3, seed=4)


def _kinds(res):
    return set().union(*(set(r.get("anomaly-types") or [])
                         for r in res["instances"]))


@pytest.mark.slow
@pytest.mark.parametrize("workload,instances,kind", [
    ("kafka-bug-offset-reuse", 8, "duplicate-offset"),
    ("kafka-bug-commit-regression", 32, "commit-regression"),
    ("kafka", 8, None)])
def test_kafka_mutants_caught_like_jax(workload, instances, kind):
    from maelstrom_tpu.models import get_model as jget_model
    from maelstrom_tpu_torch.models import get_model
    opts = dict(KAFKA_OPTS, n_instances=instances,
                record_instances=instances)
    jres = run_tpu_test(jget_model(workload, 1), dict(opts, **JAX_RUN))
    tres = harness.run_torch_test(get_model(workload, 1), opts,
                                  device="cpu")
    assert tres["net"] == {k: jres["net"][k] for k in tres["net"]}
    assert tres["valid?"] is jres["valid?"] is (kind is None)
    assert _kinds(tres) == _kinds(jres)
    if kind is not None:
        assert kind in _kinds(tres)
