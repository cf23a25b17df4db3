"""The port's ``test`` command line against the JAX CLI's.

- With ``--runtime tpu`` and no other flag, the port's ``test`` hands
  ``run_torch_test`` the options the JAX CLI hands ``run_tpu_test`` for
  ``test --runtime tpu``: every option both hand over is equal, for
  every workload (both harnesses patched to capture their options).
- With no ``--runtime``, and with ``--runtime process --bin X``, the
  port hands its ``runner.run_test`` the options the JAX CLI hands its
  own, for every workload of ``workloads.WORKLOADS``, at the defaults
  and with every process flag set (both ``run_test``s patched).
- The process runtime's refusals, in the JAX CLI's words and exit code
  2: a missing ``--bin``, and a fault-plan kind, ``--fault-plan`` or
  ``--fault-fuzz``. ``--device`` on the process runtime prints one note
  and the run goes on.
- A run whose verdict is ``"unknown"`` (a WGL state budget of 0) exits 2
  in both CLIs.
"""

import json

import pytest

from maelstrom_tpu import cli as jcli
from maelstrom_tpu import runner as jrunner
from maelstrom_tpu.checkers import linearizable as jlinearizable
from maelstrom_tpu.tpu import harness as jharness
from maelstrom_tpu_torch import harness, runner
from maelstrom_tpu_torch.__main__ import main
from maelstrom_tpu_torch.checkers import linearizable
from maelstrom_tpu_torch.models import WORKLOADS
from maelstrom_tpu_torch.workloads import WORKLOADS as PROCESS_WORKLOADS

from torch_tutorial_cases import one_torch_thread  # noqa: F401

# what the JAX CLI's defaults set (maelstrom_tpu/cli.py:76-272)
JAX_DEFAULTS = {"node_count": 1, "concurrency": 1, "rate": 10.0,
                "time_limit": 20.0, "latency": 0.0,
                "latency_dist": "exponential", "p_loss": 0.0,
                "nemesis": [], "nemesis_interval": 10.0,
                "nemesis_kind": "random-halves", "n_instances": 64,
                "record_instances": 8, "journal_instances": 0,
                "ms_per_tick": 1, "seed": 0}

FAKE_RESULT = {"valid?": True, "instance-count": 0, "checked-instances": 0,
               "valid-instances": 0, "invariants": {}, "net": {},
               "device": "cpu",
               "perf": {"wall-s": 0.0, "ticks": 0, "ticks-per-sec": 0.0,
                        "msgs-per-sec": 0.0, "phases": {"check": {}}}}


@pytest.fixture
def captured(monkeypatch):
    got = {}

    def jax_test(model, opts):
        got["jax"] = dict(opts)
        return {"valid?": True}

    def port_test(model, opts, device=None):
        got.setdefault("port", []).append(dict(opts))
        return FAKE_RESULT

    monkeypatch.setattr(jharness, "run_tpu_test", jax_test)
    monkeypatch.setattr(harness, "run_torch_test", port_test)
    return got


@pytest.mark.parametrize("workload", WORKLOADS)
def test_unset_flags_hand_the_harness_jax_s_options(workload, captured,
                                                    tmp_path, capsys):
    store = ["--store", str(tmp_path)]
    assert jcli.main(["test", "-w", workload, "--runtime", "tpu",
                      *store]) == 0
    assert main(["test", "-w", workload, "--runtime", "tpu", *store,
                 "--device", "cpu"]) == 0
    assert main(["test", "-w", workload, "--runtime", "tpu", *store,
                 "--device", "cpu"]) == 0
    capsys.readouterr()
    want = captured["jax"]
    assert {k: want[k] for k in JAX_DEFAULTS} == JAX_DEFAULTS
    for got in captured["port"]:
        shared = sorted(set(got) & set(want))
        assert set(JAX_DEFAULTS) <= set(shared)
        assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
    assert captured["port"][0] == captured["port"][1]


@pytest.mark.parametrize("runtime", ["process"])
def test_unported_runtime_exits_2_by_name(runtime, captured, capsys):
    """``process`` without ``--bin`` exits 2 with the JAX CLI's error
    (``native``, ported since, is held to the JAX CLI in
    ``tests/test_torch_native.py``)."""
    argv = ["test", "-w", "lin-kv", "--runtime", runtime]
    assert main([*argv, "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "port" not in captured
    assert err == "error: --bin is required for the process runtime\n"
    assert jcli.main(argv) == 2
    assert capsys.readouterr().err == err


# the JAX CLI's process options, each set away from its default
PROCESS_FLAGS = ["--node-count", "3", "--concurrency", "2n", "--rate", "7",
                 "--time-limit", "1.5", "--latency", "4", "--latency-dist",
                 "uniform", "--p-loss", "0.1", "--nemesis", "partition",
                 "--nemesis-interval", "0.5", "--recovery-time", "0.25",
                 "--topology", "line", "--availability", "0.9",
                 "--key-count", "4", "--max-txn-length", "3",
                 "--max-writes-per-key", "2", "--consistency-models",
                 "serializable", "--crash-clients", "--txn",
                 "--log-stderr", "--log-net-send", "--log-net-recv",
                 "--seed", "5"]


@pytest.fixture
def run_tests(monkeypatch):
    got = {}

    def capture(name):
        def run_test(workload, opts):
            got.setdefault(name, []).append((workload, dict(opts)))
            return {"valid?": True}
        return run_test

    monkeypatch.setattr(jrunner, "run_test", capture("jax"))
    monkeypatch.setattr(runner, "run_test", capture("port"))
    return got


@pytest.mark.parametrize("flags", [[], PROCESS_FLAGS],
                         ids=["defaults", "every-flag"])
@pytest.mark.parametrize("workload", PROCESS_WORKLOADS)
def test_process_runtime_hands_run_test_jax_s_options(workload, flags,
                                                      run_tests, tmp_path,
                                                      capsys):
    argv = ["test", "-w", workload, "--bin", "examples/python/echo.py",
            *flags, "--store", str(tmp_path)]
    assert jcli.main(argv) == 0
    jout = capsys.readouterr()
    assert main(argv) == 0
    assert main(argv[:3] + ["--runtime", "process"] + argv[3:]) == 0
    tout = capsys.readouterr()
    want = run_tests["jax"]
    assert len(want) == 1 and want[0][0] == workload
    assert run_tests["port"] == want * 2
    # the results print and the verdict line, once for each run
    assert tout.out == jout.out * 2
    assert tout.err == jout.err * 2 == ""


@pytest.mark.parametrize("fault", [["--nemesis", "crash-restart"],
                                   ["--nemesis", "partition", "--nemesis",
                                    "membership"],
                                   ["--fault-plan", "plan.json"],
                                   ["--fault-fuzz", "dist.json"]],
                         ids=["crash-restart", "membership", "plan",
                              "fuzz"])
def test_fault_kinds_refused_on_the_process_runtime(fault, run_tests,
                                                    captured, capsys):
    argv = ["test", "-w", "lin-kv", "--bin", "examples/python/raft.py",
            *fault]
    assert jcli.main(argv) == 2
    jerr = capsys.readouterr().err
    assert main(argv) == 2
    assert capsys.readouterr().err == jerr
    assert jerr.startswith("error: the fault-plan engine (--fault-plan, ")
    assert not run_tests and not captured


def test_device_flag_noted_on_the_process_runtime(run_tests, tmp_path,
                                                  capsys):
    argv = ["test", "-w", "echo", "--bin", "examples/python/echo.py",
            "--store", str(tmp_path)]
    assert main([*argv, "--device", "cpu"]) == 0
    assert capsys.readouterr().err == (
        "note: --device has no effect on the process runtime (no device "
        "state)\n")
    assert main(argv) == 0
    assert capsys.readouterr().err == ""
    assert run_tests["port"][0] == run_tests["port"][1]


# a small lin-kv run both CLIs take with the same flags
UNKNOWN_RUN = ["-w", "lin-kv", "--node-count", "3", "--concurrency", "2",
               "--rate", "100", "--latency", "5", "--n-instances", "2",
               "--record-instances", "2", "--time-limit", "0.2",
               "--recovery-time", "0.05", "--no-heartbeat"]


def test_unknown_verdict_exits_2(monkeypatch, tmp_path, capsys):
    """With a WGL state budget of 0 every key that needs a search is
    indeterminate: the verdict is ``"unknown"`` and both CLIs exit 2."""
    for mod in (jlinearizable, linearizable):
        f = mod.linearizable_kv_checker
        monkeypatch.setattr(f, "__defaults__", (f.__defaults__[0], 0))
    rc = main(["test", "--runtime", "tpu", *UNKNOWN_RUN, "--store",
               str(tmp_path / "t"), "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    jrc = jcli.main(["test", "--runtime", "tpu", *UNKNOWN_RUN,
                     "--device-profile", "off", "--store",
                     str(tmp_path / "j")])
    jout = json.loads(capsys.readouterr().out.split("\n\n")[0])
    assert out["valid?"] == jout["valid?"] == "unknown"
    assert rc == jrc == 2
