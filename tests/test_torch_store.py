"""The port's store and results block against the JAX harness's, and the
copied host modules and CLI flags of the bug-hunt path.

A double-vote fleet (``test_tpu_raft.BUG_OPTS`` at 32 instances, cut to
0.4 s) stored by both harnesses: both hold the same files, and every
file of the JAX store layout is byte-equal — ``fleet-metrics.json``, the
fleet SVGs, the perf SVGs, ``timeline.html``, ``history-<i>.jsonl``,
``history-<i>.txt`` and ``funnel-history-<id>.jsonl`` (the run journals
nothing, so it has no ``messages.svg``; ``heartbeat.jsonl``, whose
records carry wall-clock times, is held record by record in
``test_torch_forensics.py``) — and ``results["telemetry"]`` is JAX's
condensed fleet summary. Tolerance: exact."""

import json
import os

import numpy as np
import pytest

from maelstrom_tpu import cli as jcli
from maelstrom_tpu.checkers.availability import availability_checker as \
    javailability
from maelstrom_tpu.gen.history import pairs as jpairs
from maelstrom_tpu.gen.history import write_txt as jwrite_txt
from maelstrom_tpu.telemetry import stream as jstream
from maelstrom_tpu.tpu.runtime import scripted_isolate_groups as jsig
from maelstrom_tpu_torch import runtime
from maelstrom_tpu_torch.__main__ import _parse_schedule_file, main
from maelstrom_tpu_torch.checkers.availability import availability_checker
from maelstrom_tpu_torch.gen.history import pairs, write_txt
from maelstrom_tpu_torch.models import RAFT_MUTANTS
from maelstrom_tpu_torch.telemetry import stream

from torch_mutant_cases import (DOUBLE_VOTE, assert_funnel_histories_equal,
                                assert_results_equal, read, run_both)
from torch_mutant_cases import one_torch_thread  # noqa: F401 (autouse)

STORE_FILES = ("fleet-metrics.json", "fleet-rate.svg", "fleet-drops.svg",
               "fleet-latency.svg", "latency-raw.svg",
               "latency-quantiles.svg", "rate.svg", "timeline.html")


@pytest.fixture(scope="module")
def both_stores(tmp_path_factory):
    return run_both("lin-kv-bug-double-vote", 3, DOUBLE_VOTE,
                    tmp_path_factory.mktemp("stores"))


def test_store_files_byte_equal(both_stores):
    jres, tres = both_stores
    jd, td = jres["store-dir"], tres["store-dir"]
    assert sorted(os.listdir(td)) == sorted(os.listdir(jd))
    names = list(STORE_FILES)
    for i in range(DOUBLE_VOTE["record_instances"]):
        names += [f"history-{i}.jsonl", f"history-{i}.txt"]
    for name in names:
        assert read(td, name) == read(jd, name), name
    assert len(assert_funnel_histories_equal(jres, tres)) > 0
    with open(os.path.join(td, "fleet-metrics.json")) as f:
        fleet = json.load(f)
    assert fleet["invariants"]["tripped-instances"] > 0
    with open(os.path.join(td, "results.json")) as f:
        assert json.load(f)["funnel"] == tres["funnel"]


def test_results_block_and_telemetry_match_jax(both_stores):
    jres, tres = both_stores
    assert_results_equal(jres, tres, "double-vote store")
    assert tres["telemetry"] == jres["telemetry"]
    assert set(tres["telemetry"]) == {
        "schema", "instances", "ticks", "ms-per-tick", "totals", "rates",
        "msgs-per-op", "acks-per-invoke", "latency-ticks", "high-water",
        "nemesis", "invariants"}
    assert tres["valid?"] is False
    assert tres["funnel"]["replayed-violating"] == len(tres["funnel"]["ids"])


def _history():
    t = lambda ms: ms * 1_000_000
    return [
        {"index": 0, "time": t(1), "process": 0, "type": "invoke",
         "f": "write", "value": [1, 3]},
        {"index": 1, "time": t(2), "process": 1, "type": "invoke",
         "f": "read", "value": [1, None]},
        {"index": 2, "time": t(9), "process": 0, "type": "ok",
         "f": "write", "value": [1, 3]},
        {"index": 3, "time": t(1400), "process": 1, "type": "info",
         "f": "read", "value": [1, None], "error": "timeout"},
        {"index": 4, "time": t(1500), "process": 0, "type": "invoke",
         "f": "cas", "value": [1, [3, 4]]},
        {"index": 5, "time": t(1502), "process": 0, "type": "fail",
         "f": "cas", "value": [1, [3, 4]], "error": [22, "mismatch"]}]


@pytest.mark.parametrize("mode", [None, "total", 0.5, 0.2])
def test_host_copies_match_jax(mode, tmp_path):
    h = _history()
    assert availability_checker(h, mode) == javailability(h, mode)
    assert availability_checker([], mode) == javailability([], mode)
    assert pairs(h) == jpairs(h)
    write_txt(h, str(tmp_path / "t.txt"))
    jwrite_txt(h, str(tmp_path / "j.txt"))
    assert read(tmp_path, "t.txt") == read(tmp_path, "j.txt")


@pytest.mark.parametrize("k", [1, 3, 8])
def test_scan_decoders_match_jax(k):
    rs = np.random.RandomState(k)
    tripped = np.zeros((k, 3), np.int32) - 1
    tripped[:, 0] = 5
    tripped[: min(k, 5), 1] = np.sort(rs.randint(0, 300, min(k, 5)))
    tripped[: min(k, 5), 2] = rs.randint(0, 64, min(k, 5))
    clean = np.zeros((k, 3), np.int32) - 1
    clean[:, 0] = 0
    for scan in (tripped, clean, tripped[0]):
        assert stream.scan_to_violation(scan) == \
            jstream.scan_to_violation(scan)
        assert stream.scan_to_violations(scan) == \
            jstream.scan_to_violations(scan)


def test_scripted_isolate_groups_matches_jax():
    for groups, n in ((({0, 1, 2},), 5), (({0}, {1, 2}), 3),
                      (({0, 1}, {3, 4}), 5)):
        assert runtime.scripted_isolate_groups(120, groups, n) == \
            jsig(120, groups, n)


def test_cli_schedule_file(tmp_path, capsys):
    """A member that is no node index is refused with exit 2 and the
    JAX CLI's message; a Figure-8 file parses as the JAX CLI parses it
    and runs the scripted partitions."""
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps([[100, [[0, 1, 7]]]]))
    rc = main(["test", "-w", "lin-kv-bug-no-term-guard", "--node-count",
               "5", "--nemesis-schedule-file", str(bad), "--device", "cpu"])
    err = capsys.readouterr().err
    assert rc == 2
    assert err.strip() == jcli._parse_schedule_file(str(bad), 5)[0]
    assert main(["test", "-w", "lin-kv", "--nemesis-kind", "scripted",
                 "--device", "cpu"]) == 2
    capsys.readouterr()

    fig8 = tmp_path / "figure8.json"
    fig8.write_text(json.dumps([[40, [[0, 1, 2]]], [80, [[2, 3, 4]]],
                                [120, [[4, 0, 1]]], [160, [[1, 2, 3]]]]))
    assert _parse_schedule_file(str(fig8), 5) == \
        jcli._parse_schedule_file(str(fig8), 5)
    rc = main(["test", "-w", "lin-kv-bug-no-term-guard", "--node-count",
               "5", "--concurrency", "4", "--n-instances", "4",
               "--record-instances", "2", "--time-limit", "0.2",
               "--recovery-time", "0.03", "--nemesis-schedule-file",
               str(fig8), "--availability", "0.1", "--store",
               str(tmp_path), "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert rc == (0 if out["valid?"] is True else 1)
    assert out["net"]["dropped-partition"] > 0
    assert "availability" in out


def test_cli_double_vote_exits_1(tmp_path, capsys):
    """The bug hunt from the command line: the mutant is caught, the run
    stops early, and the funnel replays the trippers."""
    rc = main(["test", "-w", "lin-kv-bug-double-vote", "--node-count", "3",
               "--concurrency", "3", "--rate", "40", "--latency", "10",
               "--rpc-timeout", "0.8", "--p-loss", "0.05", "--nemesis",
               "partition", "--nemesis-interval", "0.25",
               "--recovery-time", "0.3", "--seed", "2", "--n-instances",
               "32", "--record-instances", "2", "--time-limit", "0.3",
               "--chunk-ticks", "50", "--fail-fast", "--scan-top-k", "2",
               "--store", str(tmp_path), "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1 and out["valid?"] is False
    assert out["fail-fast"]["stopped"] is True
    assert len(out["fail-fast"]["violations"]) <= 2
    assert out["funnel"]["replayed-violating"] == len(out["funnel"]["ids"])
    run_dir = out["store-dir"]
    assert os.path.exists(os.path.join(
        run_dir, f"funnel-history-{out['funnel']['ids'][0]}.jsonl"))


@pytest.mark.parametrize("kind", list(RAFT_MUTANTS))
def test_cli_runs_each_mutant(kind, tmp_path, capsys):
    """Every lin-kv mutant through the command line on the CPU: the exit
    code follows the verdict."""
    rc = main(["test", "-w", f"lin-kv-bug-{kind}", "--node-count", "3",
               "--n-instances", "2", "--record-instances", "1",
               "--time-limit", "0.1", "--recovery-time", "0.05",
               "--store", str(tmp_path), "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert rc == (0 if out["valid?"] is True else 1)
    assert out["instance-count"] == 2 and out["checked-instances"] == 1
    assert os.path.exists(tmp_path / f"lin-kv-bug-{kind}-torch" / "latest"
                          / "timeline.html")
