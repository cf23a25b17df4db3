"""Verdict routing of the port's device lanes against the JAX harness,
live: the planted mutant, the clean sweep, fail-fast with the lanes on,
the heartbeat's ``check`` lane and triage's flagged set.

- **Double-vote** (the JAX routing test's ``MUTANT_OPTS``: 32 instances,
  all recorded, 300 ticks) in ``device`` and ``both`` mode: the results
  blocks equal JAX's (``check`` included), the flagged set is not empty
  and covers every farm-invalid instance, the farm checks exactly the
  flagged recorded instances and a flagged verdict equals ``both``
  mode's byte for byte.
- **Clean sweep** (the JAX test's echo fleet): nothing flagged, nothing
  routed to the farm, every verdict synthesized, as in JAX.
- **Fail-fast with the lanes on.** g-set at the JAX lane tests'
  ``BASE_OPTS`` in ``device`` mode, stored, 50-tick chunks: the g-set
  lane flags reads served while a replica lagged, with no invariant
  tripped, so the chunk scan (which counts flags) stops the run where
  JAX's does, long before the farm-mode run would; every heartbeat
  record (its ``check`` lane included) equals JAX's less the clocks, and
  renders to the same ``watch`` line; triage's flagged set is the union
  of the tripped and the flagged ids, as JAX's, and its replay runs.

Tolerance: exact."""

import json
import os

from maelstrom_tpu.checkers.triage import load_run_info as jload_run_info
from maelstrom_tpu.models import get_model as jget_model
from maelstrom_tpu.models.raft_buggy import RaftDoubleVote as JDoubleVote
from maelstrom_tpu.telemetry import stream as jstream
from maelstrom_tpu.tpu.harness import run_tpu_test
from maelstrom_tpu_torch import harness
from maelstrom_tpu_torch.checkers import device_summary
from maelstrom_tpu_torch.checkers.triage import load_run_info, triage_run
from maelstrom_tpu_torch.models import get_model
from maelstrom_tpu_torch.models.raft_buggy import RaftDoubleVote
from maelstrom_tpu_torch.telemetry import stream

from test_device_check import BASE_OPTS, MUTANT_OPTS
from test_torch_device_check import assert_same, run_pair
from test_torch_forensics import SHARED
from torch_tutorial_cases import one_torch_thread  # noqa: F401 (autouse)


def _double_vote(jax):
    cls = JDoubleVote if jax else RaftDoubleVote
    return cls(n_nodes_hint=3, log_cap=64, heartbeat=8)


def test_double_vote_flagged_and_routed():
    opts = dict(MUTANT_OPTS, layout="lead")
    dev_j, dev = run_pair("lin-kv-bug-double-vote",
                          dict(opts, check_mode="device"), _double_vote)
    both_j, both = run_pair("lin-kv-bug-double-vote",
                            dict(opts, check_mode="both"), _double_vote)
    assert_same(dev_j, dev, "double-vote device")
    assert_same(both_j, both, "double-vote both")
    assert dev["valid?"] is False and both["valid?"] is False
    flagged = set(dev["check"]["flagged-instance-ids"])
    assert flagged, "the mutant raised no device flag"
    oracle = {v["instance"] for v in both["instances"]
              if v.get("valid?") is False}
    assert oracle <= flagged, sorted(oracle - flagged)
    assert both["check"]["device-vs-farm"]["complete"]
    assert dev["check"]["farm-instances"] == len(
        [i for i in flagged if i < opts["record_instances"]])
    by_inst = {v["instance"]: v for v in both["instances"]}
    for v in dev["instances"]:
        if v["instance"] in flagged:
            assert v == by_inst[v["instance"]], v["instance"]
        else:
            assert v.get("checked-by") == "device-summary", v
    assert dev["check"]["summary-bytes-per-tick"] == \
        device_summary.summary_bytes_per_tick(32)


def test_clean_sweep_routes_zero_instances_to_farm():
    opts = dict(node_count=2, concurrency=2, n_instances=16,
                record_instances=8, time_limit=0.3, rate=100.0,
                latency=5.0, seed=3, telemetry=False, funnel=False,
                check_mode="device", layout="lead")
    jres, tres = run_pair("echo", opts)
    assert_same(jres, tres, "echo clean sweep")
    assert tres["valid?"] is True
    assert tres["check"]["flagged-instances"] == 0
    assert tres["check"]["farm-instances"] == 0
    assert tres["check"]["farm-load-fraction"] == 0.0
    assert all(v.get("checked-by") == "device-summary"
               for v in tres["instances"])
    assert tres["perf"]["phases"]["check"]["farm-instances"] == 0


def _records(run_dir):
    with open(os.path.join(run_dir, "heartbeat.jsonl")) as f:
        return [json.loads(line) for line in f]


def _clockless(rec):
    rec = {k: v for k, v in rec.items()
           if k not in ("wall-s", "store-dir")}
    if rec["type"] == "run-start":
        rec["opts"] = {k: v for k, v in rec["opts"].items()
                       if k != "checkpoint_every"}
    if "check" in rec and rec["type"] == "run-end":
        rec["check"] = {k: v for k, v in rec["check"].items()
                        if k not in ("decode-s", "check-s",
                                     "verdicts-per-s")}
    return rec


def test_fail_fast_heartbeat_and_triage_with_lanes(tmp_path):
    opts = dict(BASE_OPTS, **dict(SHARED, check_mode="device"),
                fail_fast=True, pipeline="on", chunk_ticks=50,
                record_instances=4)
    n = opts["node_count"]
    jres = run_tpu_test(jget_model("g-set", n),
                        dict(opts, store_root=str(tmp_path / "jax")))
    tres = harness.run_torch_test(
        get_model("g-set", n), dict(opts, store_root=str(tmp_path / "t")),
        device="cpu")
    for k in ("valid?", "invariants", "check", "fail-fast", "instances"):
        assert tres[k] == jres[k], k
    ff = tres["fail-fast"]
    # stopped on flags alone: no invariant tripped
    assert tres["invariants"]["violating-instances"] == 0
    assert ff["stopped"] and ff["ticks-dispatched"] < ff["ticks-planned"]
    assert tres["check"]["flagged-instances"] > 0
    # without the lanes the same run goes the whole horizon
    farm = harness.run_torch_test(get_model("g-set", n),
                                  dict(opts, check_mode="farm"),
                                  device="cpu")
    assert "fail-fast" not in farm

    jrec = _records(jres["store-dir"])
    trec = _records(tres["store-dir"])
    assert [_clockless(r) for r in trec] == [_clockless(r) for r in jrec]
    chunks = [r for r in trec if r["type"] == "chunk"]
    assert all(r["check"]["mode"] == "device"
               and r["check"]["of"] == opts["n_instances"] for r in chunks)
    assert chunks[-1]["check"]["flagged"] > 0
    assert [stream.render_chunk_line(_clockless(r)) for r in chunks] == \
        [jstream.render_chunk_line(_clockless(r)) for r in jrec
         if r["type"] == "chunk"]
    assert "check[device flagged" in stream.render_chunk_line(chunks[-1])

    info = load_run_info(tres["store-dir"])
    assert info["flagged"] == jload_run_info(jres["store-dir"])["flagged"]
    assert info["flagged"] == tres["check"]["flagged-instance-ids"]
    summary = triage_run(tres["store-dir"], max_instances=2,
                         out_root=str(tmp_path / "triage"), device="cpu")
    assert [e["instance"] for e in summary["triaged"]] == \
        info["flagged"][:2]
    assert summary["ticks"] == ff["ticks-dispatched"]
