"""The port's native C++ engine (``maelstrom_tpu_torch/native/``) against
the live JAX package's (``maelstrom_tpu/native/``) on the CPU.

- **Engine.** For each of the ten ``NATIVE_WORKLOADS`` at a small size,
  and for the lin-kv mutant flags, the txn and g-set family flags,
  kafka's ``txn`` and ``crash_clients``, a broadcast topology, a
  scripted schedule, ``instance_base`` and ``wide=True``: the port's
  ``run_native_sim`` gives JAX's ``stats``, ``violations``,
  ``truncated-per-instance``, width facts and every history record;
  ``replay_native_instances`` gives JAX's replays.
- **Harness.** ``run_native_test``'s results equal JAX's with the wall
  and time fields removed, serially and with two check workers (in a
  script process, where the pool spawns), with and without the funnel;
  the store files under ``<workload>-native`` are equal.
- **CLI.** ``test --runtime native`` hands ``run_native_test`` the
  options the JAX CLI hands it, for every native workload, at the
  defaults and with every flag, with JAX's notes, refusals, results
  print and exit codes; each workload runs end to end in one process
  that imports neither ``jax`` nor ``maelstrom_tpu`` and initialises
  no CUDA, equal to the JAX CLI's run.
- **Demo.** The demo's six native entries print JAX's verdicts.
- **LNE610.** ``native_width_findings`` equals JAX's with and without
  the fixture, on a doctored source and on a doctored table.
- **Build.** A missing compiler, source or symbol raises by name; a
  second build reuses the hashed library without compiling.

Tolerance: exact (the engine is one C++ program, built from the same
source with the same flags for both packages).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from maelstrom_tpu import cli as jcli
from maelstrom_tpu.analysis import lane_liveness as jlanes
from maelstrom_tpu.native import engine as jengine
from maelstrom_tpu.native import harness as jharness
from maelstrom_tpu_torch import __main__ as tcli
from maelstrom_tpu_torch.analysis import lane_liveness as tlanes
from maelstrom_tpu_torch.native import engine, harness, wire

from torch_tutorial_cases import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMALL = dict(n_instances=32, record_instances=4, time_limit=1.0,
             nemesis=["partition"], nemesis_interval=0.3, p_loss=0.05,
             recovery_time=0.3, seed=3, threads=1)
CASES = {
    **{wl: dict(workload=wl) for wl in engine.NATIVE_WORKLOADS},
    "lin-kv-stale-read": dict(stale_read=True, time_limit=1.5),
    "lin-kv-eager-commit": dict(eager_commit=True, time_limit=1.5),
    "lin-kv-no-term-guard": dict(no_term_guard=True, time_limit=1.5),
    "txn-list-append-dirty-apply": dict(workload="txn-list-append",
                                        txn_dirty_apply=True),
    "txn-rw-register-dirty-apply": dict(workload="txn-rw-register",
                                        txn_dirty_apply=True),
    "g-set-no-gossip": dict(workload="g-set", gset_no_gossip=True),
    "unique-ids-collision": dict(workload="unique-ids",
                                 gset_no_gossip=True),
    "kafka-poll-skip": dict(workload="kafka", node_count=1, nemesis=[],
                            gset_no_gossip=True),
    "kafka-txn": dict(workload="kafka", node_count=1, nemesis=[],
                      txn=True),
    "kafka-crash-clients": dict(workload="kafka", node_count=1,
                                nemesis=[], crash_clients=True,
                                time_limit=2.0),
    "kafka-txn-crash-clients": dict(workload="kafka", node_count=1,
                                    nemesis=[], txn=True,
                                    crash_clients=True, time_limit=2.0),
    "broadcast-tree2": dict(workload="broadcast", node_count=5,
                            topology="tree2", read_prob=0.1),
    "lin-kv-scripted": dict(nemesis_schedule=(
        (300, ((0, 1), (1, 0), (0, 2), (2, 0))), (700, ((1, 2), (2, 1))))),
    "lin-kv-instance-base": dict(instance_base=100),
    "txn-list-append-wide": dict(workload="txn-list-append", wide=True),
    "lin-kv-wide": dict(wide=True),
}
# what the engine's output holds besides its wall-clock fields
PERF_FACTS = ("ticks", "instances", "threads", "msg-lanes",
              "bytes-per-msg-row", "wide")
# fields of a run's results that time the run
TIMING = {"wall-s", "harness-wall-s", "msgs-per-sec", "check-s",
          "store-dir"}


def _untimed(x):
    if isinstance(x, dict):
        return {k: _untimed(v) for k, v in x.items() if k not in TIMING}
    if isinstance(x, list):
        return [_untimed(v) for v in x]
    return x


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_native_sim_equals_jax(case):
    opts = dict(SMALL, **CASES[case])
    got, want = engine.run_native_sim(opts), jengine.run_native_sim(opts)
    for key in ("stats", "truncated-per-instance", "violating-instances",
                "events-truncated", "engine"):
        assert got[key] == want[key], key
    assert np.array_equal(got["violations"], want["violations"])
    assert got["violations"].dtype == want["violations"].dtype
    assert {k: got["perf"][k] for k in PERF_FACTS} == \
        {k: want["perf"][k] for k in PERF_FACTS}
    assert len(got["histories"]) == len(want["histories"]) == 4
    for h, jh in zip(got["histories"], want["histories"]):
        assert h == jh
    assert sum(len(h) for h in got["histories"]) > 0


def test_replay_and_instance_base_equal_jax():
    """The funnel's replays: one single-instance run per global id,
    equal to JAX's and to the batch's recorded instances."""
    opts = dict(SMALL, eager_commit=True, time_limit=1.5)
    ids = [1, 2, 17, 30]
    got = engine.replay_native_instances(opts, ids)
    assert got == jengine.replay_native_instances(opts, ids)
    batch = engine.run_native_sim(opts)
    assert got["histories"][1] == batch["histories"][1]
    assert got["violations"] == {i: int(batch["violations"][i])
                                 for i in ids}


def test_refusal_and_unknown_names_are_jax_s():
    """The engine's own refusal (rc != 0) is None; unknown names and a
    scripted schedule past 8 nodes raise JAX's errors."""
    big = dict(SMALL, node_count=31, time_limit=0.1)
    assert engine.run_native_sim(big) is None
    assert jengine.run_native_sim(big) is None
    for bad in (dict(workload="nope"), dict(workload="broadcast",
                                            topology="ring"),
                dict(node_count=9, nemesis_schedule=((5, ((0, 1),)),))):
        with pytest.raises(ValueError) as e:
            engine.run_native_sim(dict(SMALL, **bad))
        with pytest.raises(ValueError) as je:
            jengine.run_native_sim(dict(SMALL, **bad))
        assert str(e.value) == str(je.value)
    with pytest.raises(ValueError) as e:
        harness.run_native_test(big)
    with pytest.raises(ValueError) as je:
        jharness.run_native_test(big)
    assert str(e.value) == str(je.value)


# --- the harness and the store ----------------------------------------------


HARNESS_CASES = {
    "lin-kv": dict(SMALL, record_instances=8),
    # dirty-apply: Elle catches it; 16 recorded instances
    "txn-list-append-dirty-apply": dict(
        SMALL, workload="txn-list-append", txn_dirty_apply=True,
        n_instances=16, record_instances=16, time_limit=1.5),
    # eager-commit trips invariants beyond the two recorded instances:
    # the funnel replays them
    "lin-kv-eager-commit-funnel": dict(
        SMALL, eager_commit=True, n_instances=128, record_instances=2,
        time_limit=2.0, funnel_max=6),
    "lin-kv-eager-commit-no-funnel": dict(
        SMALL, eager_commit=True, n_instances=128, record_instances=2,
        time_limit=2.0, funnel=False),
    "broadcast": dict(SMALL, workload="broadcast", node_count=5,
                      read_prob=0.1),
}


def _store_files(run_dir):
    out = {}
    for name in sorted(os.listdir(run_dir)):
        with open(os.path.join(run_dir, name), "rb") as f:
            data = f.read()
        if name == "results.json":
            data = _untimed(json.loads(data))
        out[name] = data
    return out


@pytest.mark.parametrize("case", sorted(HARNESS_CASES))
def test_run_native_test_and_store_equal_jax(case, tmp_path):
    opts = HARNESS_CASES[case]
    got = harness.run_native_test(dict(opts, store_root=str(tmp_path / "t")))
    want = jharness.run_native_test(dict(opts,
                                         store_root=str(tmp_path / "j")))
    assert _untimed(got) == _untimed(want)
    funnel = case == "lin-kv-eager-commit-funnel"
    assert ("funnel" in got) == funnel
    wl = opts.get("workload", "lin-kv")
    assert got["store-dir"].startswith(str(tmp_path / "t" / f"{wl}-native"))
    files = _store_files(got["store-dir"])
    assert files == _store_files(want["store-dir"])
    assert {"results.json", "history-0.jsonl", "history-0.txt",
            "timeline.html"} <= set(files)
    if funnel:
        # tripped instances past the two recorded ones were replayed
        assert max(got["funnel"]["ids"]) >= 2
        assert got["funnel"]["replayed-violating"] == len(
            got["funnel"]["ids"])
        assert {f"funnel-history-{i}.jsonl" for i in got["funnel"]["ids"]
                } <= set(files)
    latest = os.path.join(str(tmp_path / "t"), f"{wl}-native", "latest")
    assert os.path.realpath(latest) == os.path.realpath(got["store-dir"])


POOL_SCRIPT = '''\
import json
import sys

from maelstrom_tpu_torch.checkers import pool
from maelstrom_tpu_torch.native.harness import run_native_test


def main():
    real = pool.CheckerPool.finalize
    pooled = []

    def finalize(self, instances, timeout=600.0):
        out = real(self, instances, timeout)
        pooled.append(out is not None)
        return out

    pool.CheckerPool.finalize = finalize
    res = run_native_test(json.loads(sys.argv[1]))
    print(json.dumps({"pooled": pooled, "results": res}))


if __name__ == "__main__":
    main()
'''


def test_pooled_verdicts_equal_serial_and_jax(tmp_path):
    """Two check workers in a script process (the pool spawns there):
    the farm ran, and the verdicts equal the serial path's and JAX's
    byte for byte."""
    opts = HARNESS_CASES["txn-list-append-dirty-apply"]
    script = tmp_path / "pooled.py"
    script.write_text(POOL_SCRIPT)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run(
        [sys.executable, str(script), json.dumps(dict(opts,
                                                      check_workers=2))],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["pooled"] == [True]
    assert out["results"]["perf"]["check"]["workers"] == 2
    serial = harness.run_native_test(dict(opts, check_workers=0))
    want = jharness.run_native_test(dict(opts, check_workers=0))
    assert serial["valid?"] is False
    untimed = _untimed(json.loads(json.dumps(serial, default=repr)))
    assert _untimed(out["results"])["instances"] == untimed["instances"]
    assert _untimed(serial) == _untimed(want)


def test_check_native_histories_error_shape(monkeypatch):
    """A checker that raises is a failing verdict of JAX's shape."""
    from maelstrom_tpu.checkers import pool as jpool
    from maelstrom_tpu_torch.checkers import pool
    histories = [[{"process": 0, "type": t, "f": "add", "value": "x",
                   "index": i, "time": i}
                  for i, t in enumerate(("invoke", "ok"))]]
    got = pool.check_native_histories("pn-counter", histories)
    assert got == jpool.check_native_histories("pn-counter", histories)
    assert got[0]["valid?"] is False and "error" in got[0]


# --- the CLI ------------------------------------------------------------------


NATIVE_FLAGS = ["--node-count", "3", "--concurrency", "2n", "--rate", "50",
                "--time-limit", "1.5", "--latency", "4", "--p-loss", "0.1",
                "--nemesis", "partition", "--nemesis-interval", "0.5",
                "--recovery-time", "0.25", "--topology", "line",
                "--availability", "0.9", "--latency-dist", "uniform",
                "--consistency-models", "serializable", "--crash-clients",
                "--txn", "--n-instances", "32", "--record-instances", "4",
                "--check-workers", "2", "--seed", "5"]


@pytest.fixture
def native_tests(monkeypatch):
    from maelstrom_tpu.native import harness as jh
    got = {}

    def capture(name):
        def run_native_test(opts):
            got.setdefault(name, []).append(dict(opts))
            return {"valid?": True, "engine": "native-cpp"}
        return run_native_test

    monkeypatch.setattr(jh, "run_native_test", capture("jax"))
    monkeypatch.setattr(harness, "run_native_test", capture("port"))
    return got


@pytest.mark.parametrize("flags", [[], NATIVE_FLAGS],
                         ids=["defaults", "every-flag"])
@pytest.mark.parametrize("workload", sorted(engine.NATIVE_WORKLOADS))
def test_native_runtime_hands_run_native_test_jax_s_options(
        workload, flags, native_tests, tmp_path, capsys):
    argv = ["test", "-w", workload, "--runtime", "native", *flags,
            "--store", str(tmp_path)]
    assert jcli.main(argv) == 0
    jout = capsys.readouterr()
    assert tcli.main(argv) == 0
    tout = capsys.readouterr()
    assert native_tests["port"] == native_tests["jax"]
    assert tout.out == jout.out
    assert tout.err == jout.err
    assert ("note:" in jout.err) == bool(flags)


def test_schedule_file_and_refusals_are_jax_s(native_tests, tmp_path,
                                              capsys):
    sched = tmp_path / "sched.json"
    sched.write_text(json.dumps([[200, [[0, 1], [2]]], [500, [[0], [1, 2]]]]))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps([[200, [[0, 7]]]]))
    base = ["test", "-w", "lin-kv", "--runtime", "native", "--node-count",
            "3", "--store", str(tmp_path)]
    cases = [(["--nemesis-schedule-file", str(sched)], 0),
             (["--nemesis-schedule-file", str(bad)], 2),
             (["--nemesis-kind", "scripted"], 2),
             (["-w", "lin-kv-bug-double-vote"], 2),
             (["--nemesis", "crash-restart"], 2)]
    for extra, rc in cases:
        assert jcli.main(base + extra) == rc, extra
        jout = capsys.readouterr()
        assert tcli.main(base + extra) == rc, extra
        tout = capsys.readouterr()
        assert (tout.out, tout.err) == (jout.out, jout.err), extra
        if rc:
            assert tout.err.startswith("error: "), extra
    assert native_tests["port"] == native_tests["jax"]
    assert len(native_tests["port"]) == 1
    assert native_tests["port"][0]["nemesis"] == ["partition"]
    assert len(native_tests["port"][0]["nemesis_schedule"]) == 2


def test_device_flag_noted_on_the_native_runtime(native_tests, tmp_path,
                                                 capsys):
    argv = ["test", "-w", "echo", "--runtime", "native", "--store",
            str(tmp_path)]
    assert tcli.main([*argv, "--device", "cpu"]) == 0
    assert capsys.readouterr().err == (
        "note: --device has no effect on the native runtime (a C++ engine "
        "on the host)\n")
    assert tcli.main(argv) == 0
    assert capsys.readouterr().err == ""
    assert native_tests["port"][0] == native_tests["port"][1]


RUN_FLAGS = ["--node-count", "3", "--concurrency", "2n", "--rate", "100",
             "--latency", "5", "--time-limit", "1", "--nemesis",
             "partition", "--nemesis-interval", "0.3", "--p-loss", "0.05",
             "--n-instances", "16", "--record-instances", "2", "--seed",
             "3"]
CLI_CHILD = """
import json, sys
from maelstrom_tpu_torch.__main__ import main
argv, store = json.loads(sys.argv[1]), sys.argv[2]
rcs = [main(["test", "-w", wl, "--runtime", "native", *argv, "--store",
             store]) for wl in json.loads(sys.argv[3])]
import torch
print(json.dumps({"rcs": rcs, "jax": "jax" in sys.modules,
                  "maelstrom_tpu": "maelstrom_tpu" in sys.modules,
                  "cuda": torch.cuda.is_initialized()}))
"""


def _cli_runs(out):
    """The JSON results blocks a run of CLI calls printed, and their
    verdict lines."""
    blocks, verdicts, cur = [], [], []
    for line in out.splitlines():
        if line == "{":
            cur = [line]
        elif cur:
            cur.append(line)
            if line == "}":
                blocks.append(json.loads("\n".join(cur)))
                cur = []
        elif line.strip():
            verdicts.append(line)
    return blocks, verdicts


def test_every_native_workload_end_to_end_without_jax(tmp_path, capsys):
    """All ten workloads through the port's CLI in one child process
    (no ``jax``, no ``maelstrom_tpu``, no CUDA context) against the JAX
    CLI's runs: results, verdict lines, exit codes and store files."""
    wls = sorted(engine.NATIVE_WORKLOADS)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", CLI_CHILD, json.dumps(RUN_FLAGS),
         str(tmp_path / "t"), json.dumps(wls)], cwd=tmp_path, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        jrcs = [jcli.main(["test", "-w", wl, "--runtime", "native",
                           *RUN_FLAGS, "--store", str(tmp_path / "j")])
                for wl in wls]
        jout = capsys.readouterr().out
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    lines = out.strip().splitlines()
    child = json.loads(lines[-1])
    assert child == {"rcs": jrcs, "jax": False, "maelstrom_tpu": False,
                     "cuda": False}
    tblocks, tverdicts = _cli_runs("\n".join(lines[:-1]))
    jblocks, jverdicts = _cli_runs(jout)
    assert len(tblocks) == len(jblocks) == len(wls)
    assert tverdicts == jverdicts
    assert [_untimed(b) for b in tblocks] == [_untimed(b) for b in jblocks]
    for wl, tb, jb in zip(wls, tblocks, jblocks):
        assert tb["store-dir"].startswith(str(tmp_path / "t" /
                                              f"{wl}-native"))
        assert _store_files(tb["store-dir"]) == _store_files(jb["store-dir"])


# --- the demo's native entries ------------------------------------------------


def test_demo_native_entries_give_jax_s_verdicts(monkeypatch, tmp_path,
                                                 capsys):
    native = [e for e in jcli.DEMOS if e[2].get("runtime") == "native"]
    assert len(native) == 6
    monkeypatch.setattr(jcli, "DEMOS", native)
    monkeypatch.setattr(tcli, "DEMOS", native)
    assert jcli.main(["demo", "--time-limit", "1", "--store",
                      str(tmp_path / "j")]) == 0
    jout = capsys.readouterr().out
    assert tcli.main(["demo", "--time-limit", "1", "--store",
                      str(tmp_path / "t")]) == 0
    tout = capsys.readouterr().out
    assert tout == jout
    assert tout.count("caught (mutant flagged invalid)") == 3
    assert tout.count("valid!") == 3
    assert tout.splitlines()[-1] == "All 6 demos passed. ヽ(‘ー`)ノ"


# --- LNE610 -------------------------------------------------------------------


def _lne610(findings):
    return [(f.rule, f.name, f.severity, f.pass_name,
             f.path.replace("maelstrom_tpu_torch/", "maelstrom_tpu/"),
             f.line, f.symbol, f.message) for f in findings]


with open(wire._CPP_PATH) as _f:
    _SRC = _f.read()
DOCTORED = {
    "tree": (None, None),
    "source-w-linkv": (_SRC.replace("constexpr int W_LINKV = ",
                                    "constexpr int W_LINKV = 1 + "), None),
    "source-moved": (_SRC.replace("constexpr int L_HOPS", "int L_HOPS"),
                     None),
    "source-dispatch": (_SRC.replace("workload == 7", "workload == 6"),
                        None),
    "table-wide-kafka": (None, dict(wire.NATIVE_BODY_LANES, kafka=21)),
    "table-missing": (None, {k: v for k, v in
                             wire.NATIVE_BODY_LANES.items()
                             if k != "echo"}),
}


@pytest.mark.parametrize("include_fixture", [True, False],
                         ids=["fixture", "no-fixture"])
@pytest.mark.parametrize("case", sorted(DOCTORED))
def test_native_width_findings_equal_jax(case, include_fixture):
    cpp_src, table = DOCTORED[case]
    got = tlanes.native_width_findings(cpp_src, table, include_fixture)
    want = jlanes.native_width_findings(cpp_src, table, include_fixture)
    assert _lne610(got) == _lne610(want)
    assert bool(got) == (case != "tree" or (include_fixture
                                            and table is None))
    if case == "tree" and include_fixture:
        assert {f.fingerprint for f in got} == {
            "LNE610:maelstrom_tpu_torch/native/wire.py:"
            "FIXTURE_DIVERGENT_WIDTHS"}


def test_registry_facts_and_compiled_widths_equal_jax():
    from maelstrom_tpu.native import wire as jwire
    assert wire.registry_width_facts() == jwire.registry_width_facts()
    for wl in engine.NATIVE_WORKLOADS:
        for wide in (False, True):
            assert engine.native_msg_lanes(wl, wide) == \
                jengine.native_msg_lanes(wl, wide)
            assert engine.native_msg_row_bytes(wl, wide) == \
                jengine.native_msg_row_bytes(wl, wide)
    # the compiled library against the table: a stale one is named
    compiled = {wl: engine.native_msg_lanes(wl)
                for wl in wire.NATIVE_BODY_LANES}
    assert wire.check_native_widths(compiled_lanes=compiled) == []
    stale = dict(compiled, **{"lin-kv": 21})
    assert wire.check_native_widths(compiled_lanes=stale) == \
        jwire.check_native_widths(compiled_lanes=stale) != []


# --- the build ------------------------------------------------------------------


def test_build_raises_by_name_and_reuses_the_library(monkeypatch, tmp_path):
    monkeypatch.setenv("CXX", "no-such-compiler-xyz")
    with pytest.raises(RuntimeError, match="'no-such-compiler-xyz' was "
                                           "not found"):
        engine.build_library(str(tmp_path))
    monkeypatch.delenv("CXX")
    monkeypatch.setattr(engine, "SOURCE", str(tmp_path / "sim.cpp"))
    with pytest.raises(RuntimeError, match="sim.cpp is missing"):
        engine.build_library(str(tmp_path))
    monkeypatch.undo()
    # the built library is reused: a second build compiles nothing
    path = engine.build_library()
    calls = []
    real = subprocess.run

    def spy(cmd, *a, **kw):
        calls.append(cmd)
        return real(cmd, *a, **kw)

    monkeypatch.setattr(engine.subprocess, "run", spy)
    assert engine.build_library() == path
    assert all("--version" in cmd for cmd in calls)
    assert os.path.basename(path).startswith("libsim-")
    assert os.path.dirname(path) == os.path.join(REPO, "build", "engine")


def test_load_raises_on_a_missing_symbol(monkeypatch):
    monkeypatch.setattr(engine, "_lib", None)
    monkeypatch.setattr(engine, "build_library", lambda: "libm.so.6")
    with pytest.raises(RuntimeError, match="has no symbol "
                                           "native_sim_run_sched"):
        engine.native_available()
