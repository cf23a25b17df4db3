"""The tutorial workloads through both harnesses, their checkers, the
CLI, and the port's import rule.

``run_torch_test(device="cpu")`` against ``run_tpu_test`` on the cases
of ``torch_tutorial_cases.py`` (every tutorial workload, the guide's
25-node tree4 broadcast, cold restarts under a crash and links plan):
identical histories, checker reports, verdicts, invariants and network
counters. Each copied checker gives the JAX checker's report on the
recorded histories and on hand-made bad ones (a lost element, a
duplicate id, a wrong echo, an out-of-bounds counter read). The CLI
runs the tutorial workloads and refuses the others; no module of the
port imports JAX or the JAX package. The guide's broadcast at 8
instances for 2 simulated seconds (2,000 eager ticks) is ``slow``."""

import ast
import json
import os
import subprocess
import sys

import pytest

from maelstrom_tpu.models import get_model as jget_model
from maelstrom_tpu.tpu.harness import run_tpu_test
from maelstrom_tpu_torch import harness
from maelstrom_tpu_torch.models import get_model

from torch_tutorial_cases import CASES, JAX_RUN
from torch_tutorial_cases import one_thread_env
from torch_tutorial_cases import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    workload, topology, opts = CASES[request.param]
    jmodel = jget_model(workload, opts["node_count"], topology)
    model = get_model(workload, opts["node_count"], topology)
    return request.param, jmodel, model, opts


def test_run_matches_jax_harness(case, tmp_path):
    name, jmodel, model, opts = case
    jres = run_tpu_test(jmodel, dict(opts, **JAX_RUN,
                                     store_root=str(tmp_path / "jax")))
    tres = harness.run_torch_test(model, dict(
        opts, store_root=str(tmp_path / "torch")), device="cpu")
    assert tres["net"] == {k: jres["net"][k] for k in tres["net"]}
    assert tres["valid?"] == jres["valid?"]
    assert [r["valid?"] for r in tres["instances"]] == \
        [r["valid?"] for r in jres["instances"]]
    assert {k: tres["invariants"][k] for k in jres["invariants"]} == \
        jres["invariants"]
    for i in range(opts["record_instances"]):
        with open(os.path.join(jres["store-dir"], f"history-{i}.jsonl")) \
                as f:
            jh = f.read()
        with open(os.path.join(tres["store-dir"], f"history-{i}.jsonl")) \
                as f:
            assert f.read() == jh, f"{name}: history {i}"
        assert len(jh.splitlines()) > 10
    # the checker's own report, not only its verdict
    strip = lambda r: {k: v for k, v in r.items() if k != "instance"}
    assert [strip(r) for r in tres["instances"]] == \
        [strip(r) for r in jres["instances"]]
    # the copied checker on the recorded histories, beside the JAX one
    jcheck, tcheck = jmodel.checker(), model.checker()
    for i in range(opts["record_instances"]):
        with open(os.path.join(tres["store-dir"], f"history-{i}.jsonl")) \
                as f:
            h = [json.loads(line) for line in f]
        assert tcheck(h, opts) == jcheck(h, opts)


def test_cli_runs_tutorial_workloads(tmp_path):
    cmd = [sys.executable, "-m", "maelstrom_tpu_torch", "test", "-w",
           "broadcast", "--topology", "tree4", "--node-count", "5",
           "--concurrency", "1n", "--rate", "100", "--latency", "10",
           "--n-instances", "2",
           "--record-instances", "1", "--time-limit", "0.1", "--nemesis",
           "partition", "--nemesis-interval", "0.03", "--store",
           str(tmp_path), "--device", "cpu"]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=300, env=one_thread_env())
    assert out.returncode == 0, out.stderr[-2000:]
    assert '"valid?": true' in out.stdout
    assert os.path.exists(tmp_path / "broadcast-torch" / "latest"
                          / "results.json")


@pytest.mark.parametrize("workload", ["echo", "unique-ids", "broadcast",
                                      "g-set", "g-counter", "pn-counter"])
def test_cli_main_runs_each_workload(workload, tmp_path, capsys):
    from maelstrom_tpu_torch.__main__ import main
    rc = main(["test", "-w", workload, "--node-count", "3",
               "--concurrency", "2", "--rate", "100", "--latency", "10",
               "--n-instances", "2", "--record-instances", "1",
               "--time-limit", "0.1", "--recovery-time", "0.05",
               "--store", str(tmp_path), "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out["valid?"] is True, out
    assert out["net"]["delivered"] > 0
    assert os.path.exists(tmp_path / f"{workload}-torch" / "latest"
                          / "results.json")


@pytest.mark.parametrize("argv,err", [
    pytest.param(["-w", "lin-kv-lint-fixture-traced-hazards"], "not ported",
                 id="argv0-not ported"),
    pytest.param(["-w", "kafka", "--node-count", "1", "--txn"],
                 "note: --txn has no effect on the TPU runtime yet",
                 id="argv1-kafka transactions"),
    pytest.param(["-w", "g-set", "--log-cap", "32"], "lin-kv only",
                 id="argv2-lin-kv only"),
])
def test_cli_refuses_what_is_not_ported(argv, err, tmp_path, capsys):
    """A workload or flag the JAX package refuses too raises; kafka's
    ``--txn``, which the JAX device runtime notes and ignores, gets
    JAX's note and runs as the JAX CLI does."""
    from maelstrom_tpu_torch.__main__ import main
    if err.startswith("note:"):
        from test_torch_kafka import cli_matches_jax
        cli_matches_jax(argv, err, tmp_path, capsys)
        return
    with pytest.raises(ValueError, match=err):
        main(["test", *argv, "--device", "cpu"])


def _port_modules():
    pkg = os.path.join(REPO, "maelstrom_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_neither_jax_nor_the_jax_package():
    bad = []
    for path in _port_modules():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "maelstrom_tpu"):
                    bad.append(f"{os.path.relpath(path, REPO)}:"
                               f"{node.lineno} imports {n}")
    assert not bad, bad
    assert len(list(_port_modules())) > 30


@pytest.mark.slow
def test_broadcast_25_two_seconds_matches_jax():
    """The guide's broadcast at the fleet's widths: 25 nodes, tree4, 25
    clients, 256 pool slots, 8 instances for 2 simulated seconds."""
    opts = dict(node_count=25, concurrency=25, n_instances=8,
                record_instances=4, time_limit=2.0, rate=100.0,
                nemesis=["partition"], nemesis_interval=0.4,
                recovery_time=0.3, seed=7, pool_slots=256, inbox_k=8,
                layout="lead")
    jres = run_tpu_test(jget_model("broadcast", 25, "tree4"),
                        dict(opts, **JAX_RUN))
    tres = harness.run_torch_test(get_model("broadcast", 25, "tree4"),
                                  opts, device="cpu")
    assert jres["net"]["sent"] == 203384 and \
        jres["net"]["dropped-overflow"] == 0
    assert tres["net"] == {k: jres["net"][k] for k in tres["net"]}
    assert tres["net"] == {"sent": 203384, "delivered": 161580,
                           "dropped-partition": 40737, "dropped-loss": 0,
                           "dropped-overflow": 0}
    assert tres["valid?"] is True and jres["valid?"] is True
    assert [r["lost-count"] for r in tres["instances"]] == [0] * 4


# --- the copied checkers on hand-made histories ----------------------------


def _ops(*rows):
    """History records from ``(process, type, f, value, time, extra)``
    rows, indexed in order."""
    out = []
    for i, (p, typ, f, v, t, *extra) in enumerate(rows):
        r = {"process": p, "type": typ, "f": f, "value": v, "time": t,
             "index": i}
        if extra:
            r.update(extra[0])
        out.append(r)
    return out


SET_HISTORIES = {
    "lost": _ops((0, "invoke", "add", 3, 0), (0, "ok", "add", 3, 10),
                 (1, "invoke", "read", None, 20),
                 (1, "ok", "read", [1, 2], 30)),
    "seen-then-lost": _ops((0, "invoke", "add", 3, 0),
                           (0, "ok", "add", 3, 10),
                           (1, "invoke", "read", None, 20),
                           (1, "ok", "read", [3], 30),
                           (1, "invoke", "read", None, 40),
                           (1, "ok", "read", [], 50)),
    "stale": _ops((0, "invoke", "add", 3, 0), (0, "ok", "add", 3, 10),
                  (1, "invoke", "read", None, 20),
                  (1, "ok", "read", [], 30),
                  (1, "invoke", "read", None, 40),
                  (1, "ok", "read", [3], 50)),
    "info-add-absent": _ops((0, "invoke", "add", 4, 0),
                            (0, "info", "add", 4, 10),
                            (1, "invoke", "read", None, 20),
                            (1, "ok", "read", [], 30)),
    "never-read": _ops((0, "invoke", "add", 5, 0), (0, "ok", "add", 5, 10)),
}


@pytest.mark.parametrize("name", list(SET_HISTORIES))
@pytest.mark.parametrize("add_f", ["add", "broadcast"])
def test_set_full_checker_matches_jax(name, add_f):
    from maelstrom_tpu.checkers.set_full import set_full_checker as jcheck
    from maelstrom_tpu_torch.checkers.set_full import set_full_checker
    h = [dict(r, f=add_f if r["f"] == "add" else r["f"])
         for r in SET_HISTORIES[name]]
    got = set_full_checker(h, add_f=add_f)
    assert got == jcheck(h, add_f=add_f)
    assert got["valid?"] is {"lost": False, "seen-then-lost": False,
                             "stale": True, "info-add-absent": True,
                             "never-read": "unknown"}[name]


PN_HISTORIES = {
    "in-bounds": _ops((0, "invoke", "add", 3, 0), (0, "ok", "add", 3, 1),
                      (1, "invoke", "add", -2, 2), (1, "info", "add", -2, 3),
                      (0, "invoke", "read", None, 4, {"final": True}),
                      (0, "ok", "read", 1, 5)),
    "out-of-bounds": _ops((0, "invoke", "add", 3, 0),
                          (0, "ok", "add", 3, 1),
                          (1, "invoke", "add", -2, 2),
                          (1, "info", "add", -2, 3),
                          (0, "invoke", "read", None, 4, {"final": True}),
                          (0, "ok", "read", 2, 5)),
    "untagged-last-read": _ops((0, "invoke", "add", 5, 0),
                               (0, "ok", "add", 5, 1),
                               (1, "invoke", "read", None, 2),
                               (1, "ok", "read", 4, 3)),
    "no-reads": _ops((0, "invoke", "add", 5, 0), (0, "fail", "add", 5, 1)),
}


@pytest.mark.parametrize("name", list(PN_HISTORIES))
def test_pn_counter_checker_matches_jax(name):
    from maelstrom_tpu.checkers.pn_counter import pn_counter_checker as jc
    from maelstrom_tpu_torch.checkers.pn_counter import pn_counter_checker
    h = PN_HISTORIES[name]
    got = pn_counter_checker(h)
    assert got == jc(h)
    assert got["valid?"] is {"in-bounds": True, "out-of-bounds": False,
                             "untagged-last-read": False,
                             "no-reads": "unknown"}[name]


ID_HISTORIES = {
    "unique": _ops((0, "invoke", "generate", None, 0),
                   (0, "ok", "generate", 33554433, 1),
                   (1, "invoke", "generate", None, 2),
                   (1, "ok", "generate", 1, 3)),
    "duplicate": _ops((0, "invoke", "generate", None, 0),
                      (0, "ok", "generate", 7, 1),
                      (1, "invoke", "generate", None, 2),
                      (1, "ok", "generate", 7, 3),
                      (1, "invoke", "generate", None, 4),
                      (1, "info", "generate", None, 5)),
}


@pytest.mark.parametrize("name", list(ID_HISTORIES))
def test_unique_ids_checker_matches_jax(name):
    from maelstrom_tpu.checkers.unique_ids import unique_ids_checker as jc
    from maelstrom_tpu_torch.checkers.unique_ids import unique_ids_checker
    h = ID_HISTORIES[name]
    got = unique_ids_checker(h)
    assert got == jc(h)
    assert got["valid?"] is (name == "unique")


ECHO_HISTORIES = {
    "echoed": _ops((0, "invoke", "echo", 17, 0),
                   (0, "ok", "echo", 17, 1, {"echo": 17})),
    "wrong-echo": _ops((0, "invoke", "echo", 17, 0),
                       (0, "ok", "echo", 17, 1, {"echo": 18}),
                       (1, "invoke", "echo", 4, 2),
                       (1, "info", "echo", None, 3)),
}


@pytest.mark.parametrize("name", list(ECHO_HISTORIES))
def test_echo_checker_matches_jax(name):
    from maelstrom_tpu.workloads.echo import echo_checker as jc
    from maelstrom_tpu_torch.checkers.echo import echo_checker
    h = ECHO_HISTORIES[name]
    got = echo_checker(h, {})
    assert got == jc(h, {})
    assert got["valid?"] is (name == "echoed")
