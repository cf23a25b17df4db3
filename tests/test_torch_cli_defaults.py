"""The port's ``test`` command line against the JAX CLI's device runtime.

- With no flags, and with ``--runtime tpu``, the port's ``test`` hands
  ``run_torch_test`` the options the JAX CLI hands ``run_tpu_test`` for
  ``test --runtime tpu``: every option both hand over is equal, for
  every workload (both harnesses patched to capture their options).
- ``--runtime process`` and ``--runtime native`` are not ported: exit 2,
  naming the runtime.
- A run whose verdict is ``"unknown"`` (a WGL state budget of 0) exits 2
  in both CLIs.
"""

import json

import pytest

from maelstrom_tpu import cli as jcli
from maelstrom_tpu.checkers import linearizable as jlinearizable
from maelstrom_tpu.tpu import harness as jharness
from maelstrom_tpu_torch import harness
from maelstrom_tpu_torch.__main__ import main
from maelstrom_tpu_torch.checkers import linearizable
from maelstrom_tpu_torch.models import WORKLOADS

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
    assert main(["test", "-w", workload, *store, "--device", "cpu"]) == 0
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


@pytest.mark.parametrize("runtime", ["process", "native"])
def test_unported_runtime_exits_2_by_name(runtime, captured, capsys):
    assert main(["test", "-w", "lin-kv", "--runtime", runtime,
                 "--device", "cpu"]) == 2
    assert f"--runtime {runtime}" in capsys.readouterr().err
    assert "port" not in captured


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
    rc = main(["test", *UNKNOWN_RUN, "--store", str(tmp_path / "t"),
               "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    jrc = jcli.main(["test", "--runtime", "tpu", *UNKNOWN_RUN,
                     "--device-profile", "off", "--store",
                     str(tmp_path / "j")])
    jout = json.loads(capsys.readouterr().out.split("\n\n")[0])
    assert out["valid?"] == jout["valid?"] == "unknown"
    assert rc == jrc == 2
