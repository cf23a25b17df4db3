"""Campaigns end to end in the port, against the JAX package: the runner,
``status`` and ``report``, retries with backoff, and the command line
(``test --checkpoint-every``, ``campaign submit|run|status|resume|
report``, ``watch --campaign``) with the JAX CLI's exit codes.

- A two-item campaign (clean echo and the planted double-vote mutant,
  the JAX campaign test's) drains in each package to the same item
  verdicts, histories, status table and trend report.
- ``campaign run`` in a child process is SIGKILLed once its item has
  checkpointed, and ``campaign resume`` finishes the item from the
  checkpoint: done, resumed, one heartbeat seam, and the results and
  history of an uninterrupted run (the CPU rehearsal of
  ``chip_smoke.py`` phase 12).
- A failing item re-queues with exponential backoff; status and report
  count the attempts.

Every test that starts a process gives it its own timeout. Tolerance:
exact."""

import copy
import json
import os
import signal
import subprocess
import sys
import time

import pytest

from maelstrom_tpu.campaign import queue as jqueue
from maelstrom_tpu.campaign.report import campaign_report as jreport
from maelstrom_tpu.campaign.report import campaign_status as jstatus
from maelstrom_tpu.campaign.report import render_report as jrender_report
from maelstrom_tpu.campaign.report import render_status as jrender_status
from maelstrom_tpu.campaign.runner import run_campaign as jrun_campaign
from maelstrom_tpu_torch import harness
from maelstrom_tpu_torch.__main__ import main
from maelstrom_tpu_torch.campaign import queue as cqueue
from maelstrom_tpu_torch.campaign.checkpoint import load_checkpoint
from maelstrom_tpu_torch.campaign.report import (campaign_report,
                                                 campaign_status,
                                                 render_status)
from maelstrom_tpu_torch.campaign.runner import run_campaign
from maelstrom_tpu_torch.models import get_model
from maelstrom_tpu_torch.telemetry.stream import read_heartbeat

from test_campaign import BUGGY_OPTS, ECHO_OPTS
from torch_mutant_cases import read
from torch_tutorial_cases import JAX_RUN, one_thread_env
from torch_tutorial_cases import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX lifecycle options off and the serial farm, in both packages
RUN = dict(JAX_RUN, heartbeat=True)
E2E_SPEC = {"name": "e2e", "items": [
    dict(ECHO_OPTS, workload="echo", **RUN),
    dict(BUGGY_OPTS, workload="lin-kv-bug-double-vote", **RUN)]}
quiet = lambda *a, **k: None   # noqa: E731


def _cli(*argv):
    """The port's CLI in this process: exit code and standard output."""
    import contextlib
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(list(argv))
    return rc, out.getvalue()


def _spawn(args, timeout):
    """``python -m maelstrom_tpu_torch ARGS`` in a child process, one
    torch thread; returns the finished process (killed at ``timeout``
    seconds)."""
    env = dict(one_thread_env(), PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-m", "maelstrom_tpu_torch"] + args, cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, timeout=timeout)


def _item_view(item):
    return {k: v for k, v in item.items()
            if k not in ("_path", "updated", "claimed-by", "run-dir",
                         "wall-s", "msgs-per-sec", "error", "traceback",
                         "not-before")}


def _report_view(summary):
    s = copy.deepcopy(summary)
    s.pop("generated")
    for row in s["items"]:
        for k in ("wall-s", "msgs-per-sec", "run-dir", "error"):
            row.pop(k, None)
    for t in s["trends"].values():
        t.pop("msgs-per-sec-mean")
        t.pop("msgs-per-sec-max")
    return s


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """The JAX campaign test's two items drained by each package."""
    root = tmp_path_factory.mktemp("e2e")
    tdir = cqueue.submit_campaign(E2E_SPEC, str(root / "torch"))
    jdir = jqueue.submit_campaign(E2E_SPEC, str(root / "jax"))
    tsum = run_campaign(tdir, log=quiet, device="cpu")
    jsum = jrun_campaign(jdir, log=quiet)
    return tdir, jdir, tsum, jsum


def test_campaign_end_to_end_with_planted_bug(e2e):
    tdir, jdir, tsum, jsum = e2e
    assert tsum["ran"] == 2 and tsum["done"] == 2
    assert tsum["failed"] == 0 and tsum["invalid"] == 1
    assert {k: v for k, v in tsum.items() if k != "items"} == \
        {k: v for k, v in jsum.items() if k != "items"}
    titems, jitems = cqueue.list_items(tdir), jqueue.list_items(jdir)
    assert [_item_view(i) for i in titems] == \
        [_item_view(i) for i in jitems]
    assert [i["valid?"] for i in titems] == [True, False]
    for t, j in zip(titems, jitems):
        assert os.path.basename(t["run-dir"]).endswith(f"-item{t['id']}")
        assert os.path.dirname(os.path.dirname(t["run-dir"])) == \
            os.path.dirname(os.path.dirname(tdir))
        for name in ("history-0.jsonl", "history-1.jsonl"):
            assert read(t["run-dir"], name) == read(j["run-dir"], name)
        assert load_checkpoint(t["run-dir"])["ticks"] == 200


def test_report_matches_jax(e2e):
    tdir, jdir, _, _ = e2e
    rep = campaign_report(tdir, static_cost=False)
    assert os.path.exists(os.path.join(tdir, "summary.json"))
    assert rep["valid?"] is False
    assert rep["trends"]["echo"]["valid"] == 1
    assert rep["trends"]["lin-kv-bug-double-vote"]["invalid"] == 1
    want = jreport(jdir, static_cost=False, write=False)
    assert _report_view(rep) == {**_report_view(want),
                                 "campaign": os.path.realpath(tdir)}
    # the static-cost column: each item's ir_bytes_est, the port's cost
    # model over its own config (analysis/cost_model.py)
    from maelstrom_tpu_torch.analysis.cost_model import tick_cost
    from maelstrom_tpu_torch.campaign.runner import _run_opts, build_model
    with_cost = campaign_report(tdir, write=False)
    want_est = []
    for item in cqueue.list_items(tdir):
        model = build_model(item["workload"], item["opts"])
        sim = harness.make_sim_config(model, _run_opts(item["opts"]))
        want_est.append(tick_cost(model, sim).hbm_bytes)
    assert [r["ir-bytes-est"] for r in with_cost["items"]] == want_est
    assert all(isinstance(e, int) and e > 0 for e in want_est)
    assert [with_cost["trends"][wl]["ir-bytes-est"] for wl in
            ("echo", "lin-kv-bug-double-vote")] == want_est
    # the JAX package reports the port's campaign dir as the port does
    assert _report_view(jreport(tdir, static_cost=False, write=False)) \
        == _report_view(rep)


def test_status_matches_jax(e2e):
    tdir, _, _, _ = e2e

    def view(st):
        for row in st["items"]:
            row["live"].pop("age-s", None)
        return st

    mine = view(campaign_status(tdir))
    assert mine == view(jstatus(tdir))
    assert mine["counts"] == {"done": 2}
    assert [r["live"]["ticks-done"] for r in mine["items"]] == [300, 300]
    assert all(r["live"]["ended"] for r in mine["items"])


def test_campaign_cli_exit_codes(tmp_path):
    """submit 0; run 1 with an invalid item, 0 when every item is
    valid; status and report 0; a bad spec, a dir that is no campaign,
    and a run dir without a checkpoint 2."""
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"name": "cli", "items": [
        dict(ECHO_OPTS, workload="echo", time_limit=0.1, **RUN),
        dict(BUGGY_OPTS, workload="lin-kv-bug-double-vote", **RUN)]}))
    store = str(tmp_path / "store")
    rc, out = _cli("campaign", "submit", str(spec), "--store", store)
    assert rc == 0 and "submitted campaign 'cli': 2 item(s)" in out
    cdir = out.strip().splitlines()[-1]
    rc, out = _cli("campaign", "run", cdir, "--device", "cpu",
                   "--checkpoint-every", "1")
    assert rc == 1, out
    assert "ran 2 item(s): 2 done (1 invalid), 0 failed" in out
    items = cqueue.list_items(cdir)
    assert load_checkpoint(items[0]["run-dir"])["ticks"] == 50
    rc, out = _cli("campaign", "status", cdir)
    assert rc == 0 and "done 2" in out
    assert out == render_status(campaign_status(cdir)) + "\n"
    rc, out = _cli("campaign", "report", cdir, "--no-static-cost")
    assert rc == 0 and "valid? False" in out
    assert jrender_report(jreport(cdir, static_cost=False, write=False)) \
        in out
    # a campaign whose item is valid drains with 0
    clean = cqueue.submit_campaign({"name": "clean", "items": [
        dict(ECHO_OPTS, workload="echo", time_limit=0.1, **RUN)]}, store)
    rc, out = _cli("campaign", "run", clean, "--device", "cpu")
    assert rc == 0 and "1 done (0 invalid), 0 failed" in out
    bad = tmp_path / "bad.json"
    bad.write_text("{nope")
    assert _cli("campaign", "submit", str(bad), "--store", store)[0] == 2
    assert _cli("campaign", "status", str(tmp_path))[0] == 2
    assert _cli("campaign", "resume", str(tmp_path), "--device",
                "cpu")[0] == 2


def test_test_checkpoint_every_and_run_dir_resume(tmp_path):
    """``test --checkpoint-every`` checkpoints a stored run, recording the
    stride in the run-start record; ``campaign resume RUN_DIR`` re-runs
    its tail from the checkpoint to the same verdict (exit 0)."""
    store = str(tmp_path)
    rc, out = _cli("test", "-w", "echo", "--node-count", "2",
                   "--concurrency", "2", "--rate", "100", "--n-instances",
                   "8",
                   "--record-instances", "2", "--time-limit", "0.2",
                   "--latency", "5", "--seed", "3", "--chunk-ticks", "50",
                   "--checkpoint-every", "1", "--store", store,
                   "--device", "cpu")
    assert rc == 0
    summary = json.loads(out)
    run_dir = summary["store-dir"]
    assert load_checkpoint(run_dir)["ticks"] == 150
    hb = read_heartbeat(run_dir)
    assert hb["header"]["opts"]["checkpoint_every"] == 1
    before = read(run_dir, "history-0.jsonl")
    rc, out = _cli("campaign", "resume", run_dir, "--device", "cpu")
    assert rc == 0
    res = json.loads(out)
    assert res["valid?"] is True and res["net"] == summary["net"]
    assert res["perf"]["phases"]["pipeline"]["resumed-from-ticks"] == 150
    assert read(run_dir, "history-0.jsonl") == before
    assert len(read_heartbeat(run_dir)["resumes"]) == 1


def test_campaign_run_sigkilled_and_resumed(tmp_path):
    """``campaign run`` in a child process, SIGKILLed once its item's
    checkpoint reaches tick 200; ``campaign resume`` requeues the dead
    item and finishes it from the checkpoint, equal to an uninterrupted
    run of the same options."""
    opts = dict(ECHO_OPTS, time_limit=1.0, **RUN)
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"name": "kill", "items": [
        dict(opts, workload="echo", checkpoint_every=1)]}))
    store = str(tmp_path / "store")
    rc, out = _cli("campaign", "submit", str(spec), "--store", store)
    cdir = out.strip().splitlines()[-1]
    env = dict(one_thread_env(), PYTHONPATH=REPO)
    child = subprocess.Popen(
        [sys.executable, "-m", "maelstrom_tpu_torch", "campaign", "run",
         cdir, "--device", "cpu"], cwd=REPO, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    killed_at = None
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and child.poll() is None:
            run_dir = cqueue.list_items(cdir)[0].get("run-dir")
            try:
                ck = run_dir and load_checkpoint(run_dir)
            except Exception:
                ck = None
            if ck and ck["ticks"] >= 200:
                child.send_signal(signal.SIGKILL)
                killed_at = ck["ticks"]
                break
            time.sleep(0.05)
    finally:
        if child.poll() is None and killed_at is None:
            child.kill()
        child.wait(timeout=60)
    assert killed_at is not None and killed_at < 1000, \
        "the child finished or stalled before its checkpoint"
    item = cqueue.list_items(cdir)[0]
    assert item["status"] == "running"
    assert not os.path.exists(os.path.join(item["run-dir"],
                                           "results.json"))
    rc, out = _cli("campaign", "resume", cdir, "--device", "cpu")
    assert rc == 0, out
    assert "requeued 1 preempted item(s): [0]" in out
    item = cqueue.list_items(cdir)[0]
    assert item["status"] == "done" and item["valid?"] is True
    assert item["resumed-from-checkpoint"] is True
    assert item["attempts"] == 2
    run_dir = item["run-dir"]
    hb = read_heartbeat(run_dir)
    assert len(hb["resumes"]) == 1
    assert hb["resumes"][0]["from-ticks"] >= killed_at
    assert hb["end"]["ticks"] == 1000
    ref = harness.run_torch_test(get_model("echo", 2), dict(
        opts, store_root=str(tmp_path / "ref")), device="cpu")
    with open(os.path.join(run_dir, "results.json")) as f:
        got = json.load(f)
    for k in ("valid?", "invariants", "net", "instances", "telemetry"):
        assert got[k] == json.loads(json.dumps(ref[k])), k
    assert read(run_dir, "history-0.jsonl") == \
        read(ref["store-dir"], "history-0.jsonl")


def _spawn_watch(args, timeout=60):
    return _spawn(["watch"] + args, timeout)


def test_watch_campaign_mode(tmp_path):
    """One shot: 3 while an item is pending, 0 once every item is done
    or failed; the table is the JAX package's."""
    cdir = cqueue.submit_campaign(
        {"name": "t", "items": [dict(ECHO_OPTS, workload="echo", seed=s)
                                for s in range(2)]}, str(tmp_path))
    c0 = cqueue.claim_next(cdir)
    cqueue.finish_item(c0, cqueue.DONE, **{"valid?": True})
    proc = _spawn_watch([cdir, "--campaign"])
    assert proc.returncode == 3, proc.stdout
    assert "done 1" in proc.stdout and "pending 1" in proc.stdout
    assert proc.stdout == jrender_status(jstatus(cdir)) + "\n"
    c1 = cqueue.claim_next(cdir)
    cqueue.finish_item(c1, cqueue.FAILED, error="x")
    proc = _spawn_watch([cdir, "--campaign", "--follow", "--interval",
                         "0.1"])
    assert proc.returncode == 0, proc.stdout
    assert "failed 1" in proc.stdout
    assert _spawn_watch([str(tmp_path), "--campaign"]).returncode == 2


def test_watch_follow_reports_resume_seam(tmp_path):
    """``watch -f`` exits 0 once the run-end record lands after a resume
    seam, and the one-shot report names the seam."""
    run = tmp_path / "run"
    run.mkdir()
    recs = [{"type": "run-start", "schema": 1, "workload": "echo",
             "instances": 4, "ticks": 200, "chunk-ticks": 100},
            {"type": "chunk", "chunk": 0, "t0": 0, "ticks": 100,
             "wall-s": 0.1, "net": {"sent": 5, "delivered": 5},
             "first-violation": None, "events-overflowed": False},
            {"type": "resume", "schema": 1, "from-ticks": 100},
            {"type": "chunk", "chunk": 1, "t0": 100, "ticks": 100,
             "wall-s": 0.2, "net": {"sent": 9, "delivered": 9},
             "first-violation": None, "events-overflowed": False},
            {"type": "run-end", "status": "complete", "chunks": 2,
             "ticks": 200, "wall-s": 0.5, "first-violation": None,
             "valid?": True}]
    (run / "heartbeat.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in recs))
    proc = _spawn_watch([str(run), "--follow", "--interval", "0.1"])
    assert proc.returncode == 0, proc.stdout
    assert "status: complete" in proc.stdout and "chunk   1" in proc.stdout
    rc, out = _cli("watch", str(run))
    assert rc == 0 and "1 resume seam(s)" in out


@pytest.fixture(scope="module")
def retried(tmp_path_factory):
    """An item of an unknown workload with 2 retries, drained by each
    package."""
    root = tmp_path_factory.mktemp("retry")
    spec = {"name": "retry", "items": [{
        "workload": "no-such-workload", "retries": 2, "backoff_s": 0.2}]}
    tdir = cqueue.submit_campaign(spec, str(root / "torch"))
    jdir = jqueue.submit_campaign(spec, str(root / "jax"))
    tsum = run_campaign(tdir, store_root=str(root), log=quiet,
                        device="cpu")
    jsum = jrun_campaign(jdir, store_root=str(root), log=quiet)
    return tdir, jdir, tsum, jsum


def test_failed_item_requeues_with_backoff(retried):
    tdir, jdir, tsum, jsum = retried
    assert tsum["ran"] == 3 and tsum["retried"] == 2 and tsum["failed"] == 1
    assert {k: v for k, v in tsum.items() if k != "items"} == \
        {k: v for k, v in jsum.items() if k != "items"}
    item = json.load(open(cqueue.item_path(tdir, 0)))
    assert item["status"] == cqueue.FAILED
    assert item["failures"] == 3 and item["attempts"] == 3
    assert item["backoff-history"] == [0.2, 0.4]
    assert "no-such-workload" in item["error"]
    jitem = json.load(open(jqueue.item_path(jdir, 0)))
    assert _item_view(item) == _item_view(jitem)


def test_status_and_report_show_attempt_counts(retried):
    tdir, _, _, _ = retried
    status = campaign_status(tdir)
    row = status["items"][0]
    assert row["attempts"] == 3 and row["failures"] == 3
    assert "failures 3/2" in render_status(status)
    report = campaign_report(tdir, static_cost=False, write=False)
    assert report["items"][0]["failures"] == 3
    assert report["items"][0]["error"]
    assert report["trends"]["no-such-workload"]["failed"] == 1
    assert report["items"][0]["attempts"] == 3
