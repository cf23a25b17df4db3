"""The port's store commands (``check``, ``export``, ``fleet-stats``) and
EDN functions against the JAX package's, and the ``test`` flags the JAX
device runtime notes or ignores.

- **The same run dir.** Each case stores one small run with the port
  (``<workload>-torch``) and hands the JAX CLI a copy under the JAX
  package's store name (``<workload>-tpu``): the port's CLI and the JAX
  CLI print the same standard output, write the same files and exit
  with the same code. ``check`` covers lin-kv, a lin-kv mutant (checked
  by its base workload's checker), g-set, kafka and txn-list-append;
  ``export`` the EDN vectors into a directory and next to the input, the
  line-delimited maps on standard output, and the refusals of one file
  or standard output for several histories; ``fleet-stats`` the text
  report alone and with its SVG dashboards. A store command leaves
  CUDA uninitialised.
- **EDN.** ``loads``, ``op_to_edn_map``, ``edn_map_to_op`` and the two
  history writers equal JAX's on the stored histories and on the JAX
  tests' cases (``tests/test_edn_export.py``), and ``loads(dumps(x))``
  is ``x``.
- **The test flags.** ``--log-stderr`` and its two siblings,
  ``--max-txn-length``, ``--max-writes-per-key``, ``--telemetry-stride``,
  ``--event-capacity``, ``--compile-cache`` and ``--aot-store`` are
  taken, with JAX's notes where JAX prints one.

Sizes: 2 instances, both recorded, 50-80 ticks. Tolerance: exact."""

import contextlib
import filecmp
import io
import json
import os
import shutil

import pytest
import torch

from maelstrom_tpu import cli as jcli
from maelstrom_tpu.utils import edn as jedn
from maelstrom_tpu_torch import harness
from maelstrom_tpu_torch.__main__ import main
from maelstrom_tpu_torch.models import get_model
from maelstrom_tpu_torch.utils import edn

from test_edn_export import JEPSEN_GOLDEN
from torch_tutorial_cases import one_torch_thread  # noqa: F401 (autouse)

SMALL = dict(concurrency=2, n_instances=2, record_instances=2,
             time_limit=0.08, rate=200.0, latency=5.0, chunk_ticks=40,
             check_workers=0, seed=4)
# workload -> (node count, options)
RUNS = {
    "lin-kv": (3, SMALL),
    "lin-kv-bug-double-vote": (3, dict(SMALL, time_limit=0.05)),
    "g-set": (3, SMALL),
    "kafka": (1, SMALL),
    "txn-list-append": (3, SMALL),
}


def _cli(fn, *argv):
    """A CLI's exit code, standard output and standard error."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(list(argv))
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def stored(tmp_path_factory):
    """``stored(workload) -> (port run dir, the JAX copy)``, each run
    made once, on demand."""
    runs = {}

    def get(workload):
        if workload not in runs:
            n, opts = RUNS[workload]
            root = tmp_path_factory.mktemp(workload)
            res = harness.run_torch_test(
                get_model(workload, n),
                dict(opts, node_count=n, store_root=str(root / "torch")),
                device="cpu")
            run_dir = res["store-dir"]
            copy = str(root / "jax" / f"{workload}-tpu"
                       / os.path.basename(run_dir))
            shutil.copytree(run_dir, copy)
            runs[workload] = (run_dir, copy)
        return runs[workload]
    return get


def _same_output(got, want, run_dir, copy):
    rc, out, err = got
    jrc, jout, jerr = want
    assert rc == jrc
    assert out.replace(run_dir, "RUN") == jout.replace(copy, "RUN")
    assert err.replace(run_dir, "RUN") == jerr.replace(copy, "RUN")


@pytest.mark.parametrize("workload", list(RUNS))
def test_check_matches_jax(stored, workload):
    run_dir, copy = stored(workload)
    got = _cli(main, "check", run_dir)
    _same_output(got, _cli(jcli.main, "check", copy), run_dir, copy)
    out = json.loads(got[1])
    assert out["workload-name"] == workload.split("-bug-")[0]
    assert sorted(out["instances"]) == ["history-0.jsonl",
                                        "history-1.jsonl"]
    assert got[0] == {True: 0, False: 1}.get(out["valid?"], 2)
    # a bare history file: the composed single-history checkers
    hist = os.path.join(run_dir, "history-0.jsonl")
    jhist = os.path.join(copy, "history-0.jsonl")
    w = workload.split("-bug-")[0]
    _same_output(_cli(main, "check", hist, "-w", w),
                 _cli(jcli.main, "check", jhist, "-w", w), run_dir, copy)
    assert not torch.cuda.is_initialized()


def test_check_refusals_match_jax(stored, tmp_path):
    run_dir, copy = stored("lin-kv")
    hist = os.path.join(run_dir, "history-0.jsonl")
    for argv in ([str(tmp_path)], [hist]):
        rc, out, err = _cli(main, "check", *argv)
        jrc, jout, jerr = _cli(jcli.main, "check", *argv)
        assert rc == jrc == 2 and out == jout == ""
        assert err == jerr


def _tree(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


def _same_tree(a, b):
    assert _tree(a) == _tree(b)
    for name in _tree(a):
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name),
                           shallow=False), name


@pytest.mark.parametrize("workload", ["lin-kv", "txn-list-append",
                                      "kafka"])
def test_export_matches_jax(stored, workload, tmp_path):
    run_dir, copy = stored(workload)
    # EDN vectors into a directory
    got = _cli(main, "export", run_dir, "-o", str(tmp_path / "port"))
    want = _cli(jcli.main, "export", copy, "-o", str(tmp_path / "jax"))
    assert got[0] == want[0] == 0
    assert got[2].replace(str(tmp_path / "port"), "OUT") == \
        want[2].replace(str(tmp_path / "jax"), "OUT")
    _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    # line-delimited maps on standard output
    _same_output(_cli(main, "export", run_dir, "--maps", "-o", "-"),
                 _cli(jcli.main, "export", copy, "--maps", "-o", "-"),
                 run_dir, copy)
    # several histories cannot share stdout as vectors, nor one file
    for argv in (["-o", "-"], ["-o", str(tmp_path / "one.edn")]):
        got = _cli(main, "export", run_dir, *argv)
        _same_output(got, _cli(jcli.main, "export", copy, *argv),
                     run_dir, copy)
        assert got[0] == 2
    assert not torch.cuda.is_initialized()


def test_export_next_to_input_matches_jax(stored):
    run_dir, copy = stored("g-set")
    _same_output(_cli(main, "export", run_dir),
                 _cli(jcli.main, "export", copy), run_dir, copy)
    for name in ("history-0.edn", "history-1.edn"):
        assert filecmp.cmp(os.path.join(run_dir, name),
                           os.path.join(copy, name), shallow=False)


@pytest.mark.parametrize("svg", [False, True])
def test_fleet_stats_matches_jax(stored, svg, tmp_path):
    run_dir, copy = stored("lin-kv")
    flags = (["-o", str(tmp_path / "port")] if svg else ["--no-svg"])
    jflags = (["-o", str(tmp_path / "jax")] if svg else ["--no-svg"])
    got = _cli(main, "fleet-stats", run_dir, *flags)
    want = _cli(jcli.main, "fleet-stats", copy, *jflags)
    assert got[0] == want[0] == 0
    assert got[1] == want[1] and "fleet:" in got[1]
    if svg:
        assert got[2].replace(str(tmp_path / "port"), "OUT") == \
            want[2].replace(str(tmp_path / "jax"), "OUT")
        _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
        assert len(_tree(str(tmp_path / "port"))) == 3
    # no fleet metrics: exit 2 with JAX's message
    missing = os.path.join(run_dir, "nope")
    rc, _, err = _cli(main, "fleet-stats", missing)
    jrc, _, jerr = _cli(jcli.main, "fleet-stats", missing)
    assert rc == jrc == 2 and err == jerr
    assert not torch.cuda.is_initialized()


# --- EDN ---------------------------------------------------------------------

def _records(run_dir):
    with open(os.path.join(run_dir, "history-0.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.mark.parametrize("workload", ["txn-list-append", "kafka",
                                      "lin-kv"])
def test_edn_matches_jax(stored, workload):
    records = _records(stored(workload)[0])
    assert records
    assert list(edn.history_to_edn_lines(records, workload)) == \
        list(jedn.history_to_edn_lines(records, workload))
    lines = list(edn.history_to_edn_vector_lines(records, workload))
    assert lines == list(jedn.history_to_edn_vector_lines(records,
                                                          workload))
    parsed = edn.loads("\n".join(lines))
    assert parsed == jedn.loads("\n".join(lines))
    for op, m in zip(records, parsed):
        assert m == edn.op_to_edn_map(op, workload)
        assert json.loads(json.dumps(edn.edn_map_to_op(m))) == op
        assert edn.edn_map_to_op(m) == jedn.edn_map_to_op(m)


@pytest.mark.parametrize("line,workload", JEPSEN_GOLDEN)
def test_edn_jepsen_cases_match_jax(line, workload):
    parsed = edn.loads(line)
    assert parsed == jedn.loads(line)
    op = json.loads(json.dumps(edn.edn_map_to_op(parsed)))
    assert edn.dumps(edn.op_to_edn_map(op, workload)) == \
        jedn.dumps(jedn.op_to_edn_map(op, workload))
    assert edn.loads(edn.dumps(edn.op_to_edn_map(op, workload))) == parsed

    def values(K):
        return [None, True, False, 0, -7, 3.5, "plain", 'q"\\b\nn',
                K("append"), [1, [2, None], {"k": K("r")}],
                {K("f"): K("txn"), "s": [1, 2]}, float("inf")]

    for v, jv in zip(values(edn.Keyword), values(jedn.Keyword)):
        assert edn.loads(edn.dumps(v)) == v
        assert edn.dumps(v) == jedn.dumps(jv)
    with pytest.raises(ValueError):
        edn.loads("{:a 1} trailing")


# --- the test flags ------------------------------------------------------------

def test_test_flags_taken(tmp_path, capsys):
    """The JAX CLI's flags the port's ``test`` lacked: the log flags with
    JAX's note, the process-runtime generator knobs and the lifecycle
    options ignored, the telemetry stride and event capacity taken."""
    rc = main(["test", "-w", "echo", "--node-count", "2",
               "--concurrency", "2", "--rate", "100", "--latency", "10",
               "--n-instances", "2", "--record-instances", "1",
               "--time-limit", "0.05", "--log-stderr", "--log-net-send",
               "--log-net-recv", "--max-txn-length", "3",
               "--max-writes-per-key", "4", "--telemetry-stride", "5",
               "--event-capacity", "256", "--compile-cache", "x",
               "--aot-store", "off", "--device-profile", "off",
               "--store", str(tmp_path), "--device", "cpu"])
    cap = capsys.readouterr()
    assert rc == 0 and json.loads(cap.out)["valid?"] is True
    for flag in ("--log-stderr", "--log-net-send", "--log-net-recv"):
        assert (f"note: {flag} has no effect on the TPU runtime (no node "
                f"processes / host wire log)") in cap.err
    run = os.path.join(str(tmp_path), "echo-torch", "latest")
    with open(os.path.join(run, "fleet-metrics.json")) as f:
        assert json.load(f)["series"]["stride-ticks"] == 5
    with open(os.path.join(run, "results.json")) as f:
        res = json.load(f)
    assert "device" not in res["perf"]["phases"]
