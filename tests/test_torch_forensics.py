"""The forensics of a stored run against the JAX package: the streaming
heartbeat, ``watch``, ``triage`` and ``shrink``, and the fuzz helpers
they rest on.

- **Heartbeat.** On the same options each package's ``heartbeat.jsonl``
  holds the same records, less the wall and device clocks (``wall-s``,
  ``device-s``), the verdict stage's timings and the run directory; the
  run-start record whole, its repro options ``checkpoint_every``
  included. Cases: a complete bare run, a fault-plan run, a fuzz run and
  a fail-fast stop.
- **Triage.** The double-vote fail-fast run of the JAX triage tests
  (``test_stream_triage.BUGGY_OPTS``), stored by each package and
  triaged by each package's ``triage_run``: the flagged ids come from
  the live runs, and every bundle file is equal (``history.jsonl``,
  ``journal.edn``, ``messages.svg`` byte for byte; ``summary.json`` and
  ``repro.json`` with the run directories and the two package-name
  strings mapped), also on a partial run dir without results.json.
- **Shrink.** ``shrink_plan``'s reduction (ddmin rounds, greedy
  candidates, halved durations) equals JAX's on multi-phase plans under
  deterministic replay predicates, replay for replay; and
  ``shrink_instance``'s record equals JAX's on every field.
- **CLI.** ``watch``, ``triage`` and ``shrink`` through the port's
  command line, with their error exits.

Tolerance: exact."""

import json
import os
import shutil

import numpy as np
import pytest

from maelstrom_tpu.checkers.triage import triage_run as jtriage_run
from maelstrom_tpu.faults import fuzz as jfuzz
from maelstrom_tpu.faults.shrink import shrink_instance as jshrink_instance
from maelstrom_tpu.faults.shrink import shrink_plan as jshrink_plan
from maelstrom_tpu.models import get_model as jget_model
from maelstrom_tpu.telemetry import stream as jstream
from maelstrom_tpu.tpu import harness as jharness
from maelstrom_tpu.tpu.harness import run_tpu_test
from maelstrom_tpu_torch import harness
from maelstrom_tpu_torch.__main__ import main
from maelstrom_tpu_torch.checkers.triage import triage_run
from maelstrom_tpu_torch.faults import fuzz
from maelstrom_tpu_torch.faults.shrink import (ShrinkError, shrink_instance,
                                               shrink_plan)
from maelstrom_tpu_torch.models import get_model
from maelstrom_tpu_torch.telemetry import stream

from test_fault_fuzz import HIT_DIST
from test_stream_triage import BUGGY_OPTS, ECHO_OPTS
from torch_mutant_cases import one_torch_thread  # noqa: F401 (autouse)
from torch_mutant_cases import read
from torch_tutorial_cases import CRASH_LINKS_PLAN, JAX_RUN

# options both harnesses record alike in the run-start record: the
# port's defaults for these differ from (or are missing in) the JAX
# harness's, so each run names them
SHARED = dict(JAX_RUN, heartbeat=True, check_mode="farm", layout="lead",
              nemesis_kind="random-halves", nemesis_schedule=(),
              availability=None, funnel=False, funnel_max=32)
# the JAX triage tests' fail-fast run of the double-vote mutant
DOUBLE_VOTE = dict(BUGGY_OPTS, fail_fast=True)
# the forget-snapshot mutant under the JAX fuzz tests' HIT_DIST
# (test_fault_fuzz.HIT_OPTS), cut from 0.8 s to 0.3 s: seed 7 no longer
# trips at that depth on this toolchain, so seeds 0-29 of a 16-instance
# fleet were run through the live JAX package (run_sim_pipelined) at
# 0.3 s, and seed 17 trips instance 0 — a one-instance fleet catches it
FUZZ = dict(node_count=3, concurrency=4, n_instances=1,
            record_instances=1, time_limit=0.3, rate=300.0, latency=5.0,
            rpc_timeout=0.08, recovery_time=0.1, seed=17, inbox_k=2,
            pool_slots=24, fault_fuzz=HIT_DIST, pipeline="on")
FUZZ_MUTANT = "lin-kv-bug-forget-snapshot"

RUNS = {
    "bare": ("echo", 2, ECHO_OPTS),
    "fault-plan": ("echo", 3, dict(ECHO_OPTS, node_count=3,
                                   fault_plan=CRASH_LINKS_PLAN)),
    "fuzz": (FUZZ_MUTANT, 3, FUZZ),
    "fail-fast": ("lin-kv-bug-double-vote", 3, DOUBLE_VOTE),
}


def _models(workload, n):
    if workload == "lin-kv-bug-double-vote":
        # the JAX triage tests' model (test_stream_triage._buggy_model)
        kw = dict(n_nodes_hint=3, log_cap=64, heartbeat=8)
        from maelstrom_tpu.models.raft_buggy import RaftDoubleVote as J
        from maelstrom_tpu_torch.models.raft_buggy import RaftDoubleVote
        return J(**kw), RaftDoubleVote(**kw)
    return jget_model(workload, n), get_model(workload, n)


@pytest.fixture(scope="module")
def stored(tmp_path_factory):
    """Each case of ``RUNS`` stored by both harnesses, run on demand:
    ``stored(case) -> (jax results, port results)``."""
    runs = {}

    def get(case):
        if case not in runs:
            workload, n, opts = RUNS[case]
            root = tmp_path_factory.mktemp(case)
            jmodel, model = _models(workload, n)
            jres = run_tpu_test(jmodel, dict(opts, **SHARED,
                                             store_root=str(root / "jax")))
            tres = harness.run_torch_test(
                model, dict(opts, **SHARED, store_root=str(root / "torch")),
                device="cpu")
            runs[case] = (jres, tres)
        return runs[case]
    return get


def _records(run_dir):
    with open(os.path.join(run_dir, "heartbeat.jsonl")) as f:
        return [json.loads(line) for line in f]


def _comparable(rec):
    rec = {k: v for k, v in rec.items()
           if k not in ("wall-s", "device-s", "store-dir")}
    if "check" in rec:
        rec["check"] = {k: v for k, v in rec["check"].items()
                        if k not in ("decode-s", "check-s",
                                     "verdicts-per-s")}
    return rec


@pytest.mark.parametrize("case", list(RUNS))
def test_heartbeat_matches_jax(stored, case):
    jres, tres = stored(case)
    jrec, trec = _records(jres["store-dir"]), _records(tres["store-dir"])
    assert [r["type"] for r in trec] == [r["type"] for r in jrec]
    assert len(trec) >= 4
    for j, t in zip(jrec, trec):
        assert _comparable(t) == _comparable(j), t["type"]
    assert trec[-1]["store-dir"] == tres["store-dir"]
    hb = stream.read_heartbeat(tres["store-dir"])
    assert stream.render_watch_report(hb) == jstream.render_watch_report(hb)
    # the chunk records: cumulative counters and the lanes of the case
    chunks = [r for r in trec if r["type"] == "chunk"]
    assert chunks[-1]["net"]["sent"] == tres["net"]["sent"]
    if case == "fault-plan":
        assert any(not r["fault"].get("healthy") for r in chunks)
    if case == "fuzz":
        assert any(r["fault-fuzz"]["crash"] for r in chunks)
    if case == "fail-fast":
        assert trec[-1]["status"] == "stopped"
        assert trec[-1]["first-violation"]["instance"] in \
            tres["invariants"]["violating-instance-ids"]
    else:
        assert trec[-1]["status"] == "complete"


def test_heartbeat_reader_and_watch_report_match_jax(stored, tmp_path,
                                                     capsys):
    _, tres = stored("fail-fast")
    run_dir = tres["store-dir"]
    hb = stream.read_heartbeat(run_dir)
    assert hb == jstream.read_heartbeat(run_dir)
    assert stream.render_watch_report(hb, path="p") == \
        jstream.render_watch_report(hb, path="p")
    assert stream.flagged_instances(hb) == jstream.flagged_instances(hb)
    assert stream.first_violation_of(hb) == jstream.first_violation_of(hb)
    # a killed writer: no run-end record, a torn last line
    lines = open(os.path.join(run_dir, "heartbeat.jsonl")).readlines()
    with open(tmp_path / "heartbeat.jsonl", "w") as f:
        f.writelines(lines[:-2])
        f.write(lines[-2][:37])
    torn = stream.read_heartbeat(str(tmp_path))
    assert torn["end"] is None and torn["skipped"] == 1
    assert torn == jstream.read_heartbeat(str(tmp_path))
    assert len(torn["chunks"]) == len(hb["chunks"]) - 1
    # the CLI: 0 for a finished run, 3 without a run-end record, 2
    # without a heartbeat, or with --campaign on a dir that is no
    # campaign (the JAX CLI's message)
    assert main(["watch", run_dir]) == 0
    out = capsys.readouterr().out
    assert out.strip() == stream.render_watch_report(hb, path=run_dir)
    assert "status: stopped" in out and "first violation" in out
    assert main(["watch", run_dir, "--follow", "--interval", "0"]) == 0
    assert "status: stopped" in capsys.readouterr().out
    assert main(["watch", str(tmp_path)]) == 3
    assert "no run-end record" in capsys.readouterr().out
    assert main(["watch", str(tmp_path / "nothing")]) == 2
    assert "no heartbeat" in capsys.readouterr().err
    assert main(["watch", run_dir, "--campaign"]) == 2
    assert capsys.readouterr().err == \
        f"error: not a campaign dir (no campaign.json): {run_dir}\n"


def _mapped(text, jdir, tdir):
    """A JAX bundle file's text with the port's run dir and package."""
    return (text.replace(jdir, tdir)
            .replace("maelstrom_tpu.tpu.harness", "maelstrom_tpu_torch.harness")
            .replace("python -m maelstrom_tpu ",
                     "python -m maelstrom_tpu_torch "))


def _repro(path, jdir=None, tdir=None):
    """A repro.json, the JAX package's mapped."""
    text = read(*os.path.split(path)).decode()
    return json.loads(text if jdir is None else _mapped(text, jdir, tdir))


def _assert_bundles_equal(jsum, tsum, jdir, tdir):
    assert tsum["flagged"] == jsum["flagged"]
    assert [e["instance"] for e in tsum["triaged"]] == \
        [e["instance"] for e in jsum["triaged"]]
    assert tsum["replayed-violating"] == len(tsum["triaged"]) > 0
    assert read(tsum["out-dir"], "summary.json").decode() == _mapped(
        read(jsum["out-dir"], "summary.json").decode(), jdir, tdir)
    for e in jsum["triaged"]:
        sub = f"instance-{e['instance']}"
        jd = os.path.join(jsum["out-dir"], sub)
        td = os.path.join(tsum["out-dir"], sub)
        assert sorted(os.listdir(td)) == sorted(os.listdir(jd))
        for name in ("history.jsonl", "journal.edn", "messages.svg"):
            assert read(td, name) == read(jd, name), (sub, name)
        assert _repro(os.path.join(td, "repro.json")) == _repro(
            os.path.join(jd, "repro.json"), jdir, tdir)


def test_triage_bundles_match_jax(stored, capsys):
    jres, tres = stored("fail-fast")
    jdir, tdir = jres["store-dir"], tres["store-dir"]
    assert tres["invariants"] == jres["invariants"]
    jsum = jtriage_run(jdir)
    assert main(["triage", tdir, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    with open(os.path.join(tdir, "triage", "summary.json")) as f:
        tsum = json.load(f)
    _assert_bundles_equal(jsum, tsum, jdir, tdir)
    assert tsum["flagged"] == jres["invariants"]["violating-instance-ids"]
    for e in tsum["triaged"]:
        assert f"instance {e['instance']}: valid?" in out
    # no heartbeat: a clean error exit
    assert main(["triage", os.path.join(tdir, "triage"),
                 "--device", "cpu"]) == 2
    assert "no heartbeat run-start record" in capsys.readouterr().err


def test_triage_partial_run_matches_jax(stored, tmp_path):
    """A killed run's dir — the heartbeat prefix alone, no run-end
    record, a torn last line — triaged by both packages."""
    _, tres = stored("fail-fast")
    lines = open(os.path.join(tres["store-dir"],
                              "heartbeat.jsonl")).readlines()
    dirs = []
    for pkg in ("jax", "torch"):
        d = str(tmp_path / pkg / "partial-run")
        os.makedirs(d)
        with open(os.path.join(d, "heartbeat.jsonl"), "w") as f:
            f.writelines(lines[:-2])
            f.write(lines[-2][:37])
        dirs.append(d)
    jsum = jtriage_run(dirs[0])
    tsum = triage_run(dirs[1], device="cpu")
    assert tsum["flagged"] == stream.flagged_instances(
        stream.read_heartbeat(dirs[1]))
    assert tsum["ticks"] < tres["perf"]["ticks"]
    _assert_bundles_equal(jsum, tsum, dirs[0], dirs[1])


def test_fuzz_helpers_match_jax():
    """``reconstruct_plan``, ``plan_weight`` and ``span_counters`` over
    many instance ids of an all-lane distribution."""
    dist = dict(HIT_DIST, windows=[1, 3], gap=[20, 120],
                membership={"rate": 0.5, "victims": [1, 1]})
    opts = dict(FUZZ, fault_fuzz=dist, time_limit=0.6)
    jsim = jharness.make_sim_config(jget_model("lin-kv", 3), opts)
    sim = harness.make_sim_config(get_model("lin-kv", 3), opts)
    ids = np.arange(48)
    weights = set()
    for i in ids[:24]:
        plan = fuzz.reconstruct_plan(sim.faults, 3, 5, int(i))
        assert plan == jfuzz.reconstruct_plan(jsim.faults, 3, 5, int(i))
        w = fuzz.plan_weight(plan, 3)
        assert w == jfuzz.plan_weight(plan, 3)
        weights.add(w)
    assert len(weights) > 3
    win = fuzz.fleet_windows(sim.faults, 3, 5, ids)
    jwin = jfuzz.fleet_windows(jsim.faults, 3, 5, ids)
    for t0, n in ((0, 50), (40, 100), (150, 1), (300, 300)):
        got = fuzz.span_counters(win, t0, n)
        assert got == jfuzz.span_counters(jwin, t0, n)
    assert fuzz.span_counters(win, 40, 100)["membership"] > 0


# plans for the shrinker's reduction logic, replayed by predicates on
# the plan alone (no simulation): one fault phase with several victims
# (no ddmin round: the greedy pass alone), eight crash phases of which
# one crashes node 2 (the ddmin rounds' case), and five nodes under
# every lane — crashes, link edges, skew, membership removals with
# their rejoin, an absolute member set and its restore (a heal)
SINGLE_PLAN = {"snapshot_every": 1, "phases": [
    {"until": 181},
    {"until": 265, "crash": [0, 2],
     "links": [{"src": 1, "dst": 2, "delay": 9},
               {"src": 0, "dst": 1, "block": True}]}]}
WIDE_PLAN = {"phases": [{"until": 50 * (i + 1),
                         "crash": [2] if i == 5 else [0]}
                        for i in range(8)]}
MIXED_PLAN = {"snapshot_every": 1, "phases": [
    {"until": 30},
    {"until": 80, "crash": [0, 2], "skew": {"1": 1.5}},
    {"until": 120, "links": [{"src": 0, "dst": 1, "block": True},
                             {"src": 2, "dst": 3, "delay": 6},
                             {"src": 4, "dst": 0, "loss": 0.5}]},
    {"until": 160, "remove": [3, 4]},
    {"until": 200, "add": [3, 4], "crash": [1]},
    {"until": 240, "members": [0, 1, 2], "skew": {"0": 0.75}},
    {"until": 280, "members": [0, 1, 2, 3, 4]},
    {"until": 330, "crash": [2], "links": [{"src": 0, "dst": 1,
                                            "block": True}]}]}


def _trips(pred):
    """``replay(plan)`` for a predicate over the plan's phases, with
    each phase's width; an empty plan never trips."""
    def replay(plan):
        phases = (plan or {}).get("phases", ())
        return any(pred(ph, int(ph["until"]) - (int(phases[i - 1]["until"])
                                                 if i else 0))
                   for i, ph in enumerate(phases))
    return replay


PREDICATES = {
    # node 2 crashed for at least 12 ticks of some phase
    "crash-2": lambda ph, w: 2 in (ph.get("crash") or []) and w >= 12,
    # link 0 -> 1 blocked in some phase
    "block-0-1": lambda ph, w: any(
        e["src"] == 0 and e["dst"] == 1 and e.get("block")
        for e in ph.get("links") or []),
    # node 3 out of the cluster, by a removal or a member set
    "out-3": lambda ph, w: 3 in (ph.get("remove") or [])
    or (ph.get("members") is not None and 3 not in ph["members"]),
    # a crash beside a skewed clock in one phase
    "crash-and-skew": lambda ph, w: bool(ph.get("crash")
                                         and ph.get("skew")),
}


SHRINK_PLANS = {"single": (SINGLE_PLAN, 3), "wide": (WIDE_PLAN, 3),
                "mixed": (MIXED_PLAN, 5)}


@pytest.mark.parametrize("budget", [5, 64])
@pytest.mark.parametrize("plan_name,pred", [
    ("single", "crash-2"), ("single", "block-0-1"), ("wide", "crash-2")]
    + [("mixed", p) for p in PREDICATES])
def test_shrink_plan_matches_jax(plan_name, pred, budget):
    """The same candidates in the same order, the same kept labels and
    the same minimum as JAX's ``shrink_plan``."""
    plan, n_nodes = SHRINK_PLANS[plan_name]
    logs = ([], [])

    def logged(log):
        inner = _trips(PREDICATES[pred])

        def replay(p):
            log.append((p, inner(p)))
            return log[-1][1]
        return replay
    assert _trips(PREDICATES[pred])(plan)
    got = shrink_plan(plan, logged(logs[0]), max_attempts=budget,
                      n_nodes=n_nodes)
    ref = jshrink_plan(plan, logged(logs[1]), max_attempts=budget,
                       n_nodes=n_nodes)
    assert logs[0] == logs[1]
    assert got == ref
    assert got["attempts"] == len(logs[0]) <= budget
    assert len(got["kept"]) == sum(ok for _, ok in logs[0]) > 0
    if plan_name != "single":
        assert got["kept"][0].startswith("ddmin-drop-phases-")
    if budget == 64:
        # a local minimum: one victim in one phase
        assert fuzz.plan_weight(got["plan"], n_nodes)[0] == 1


def test_shrink_matches_jax(stored, capsys):
    """The port's CLI shrink of the stored fuzz run equals JAX's
    ``shrink_instance`` of its hit; one candidate replay (the budget's
    smallest) besides the verifying replay of the reconstruction."""
    _, tres = stored("fuzz")
    assert tres["invariants"]["violating-instance-ids"] == [0]
    jrec = jshrink_instance(jget_model(FUZZ_MUTANT, 3),
                            dict(FUZZ, **SHARED), 0, max_attempts=1)
    run_dir = tres["store-dir"]
    assert main(["shrink", run_dir, "--max-attempts", "1",
                 "--device", "cpu"]) == 0
    assert "instance 0: 1 phase(s)/2 victim(s)" in capsys.readouterr().out
    inst = os.path.join(run_dir, "triage", "instance-0")
    with open(os.path.join(inst, "shrink.json")) as f:
        rec = json.load(f)
    assert rec.pop("shrunk-plan-file") == os.path.join(inst,
                                                       "shrunk-plan.json")
    assert rec == jrec
    assert rec["verified"] is True and rec["attempts"] == 1
    with open(os.path.join(inst, "shrunk-plan.json")) as f:
        assert json.load(f) == rec["shrunk-plan"]


def test_shrink_refuses_fault_free_runs(stored, capsys):
    model = get_model("lin-kv", 3)
    with pytest.raises(ShrinkError, match="not a fault run"):
        shrink_instance(model, dict(ECHO_OPTS, node_count=3), 0,
                        device="cpu")
    _, tres = stored("fail-fast")
    assert main(["shrink", tres["store-dir"], "--device", "cpu"]) == 2
    assert "is not a fault run" in capsys.readouterr().err
    # a run dir without its heartbeat cannot be shrunk either
    empty = os.path.join(tres["store-dir"], "no-heartbeat")
    os.makedirs(empty, exist_ok=True)
    assert main(["shrink", empty, "--device", "cpu"]) == 2
    shutil.rmtree(empty)
