"""The slice end to end: ``run_torch_test(device="cpu")`` against
``run_tpu_test`` with the same small lin-kv options (lead layout, serial
checking, the chunked pipeline over several chunks). Histories, the
verdicts and the network counters must be identical."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from maelstrom_tpu.models.raft import RaftModel as JRaftModel
from maelstrom_tpu.tpu.harness import run_tpu_test
from maelstrom_tpu_torch import harness, pipeline, runtime
from maelstrom_tpu_torch.models.raft import RaftModel

from torch_tutorial_cases import one_thread_env
from torch_tutorial_cases import one_torch_thread  # noqa: F401 (autouse)

OPTS = dict(node_count=3, concurrency=6, n_instances=32, record_instances=3,
            time_limit=0.3, rate=200.0, latency=5.0, rpc_timeout=1.0,
            nemesis=["partition"], nemesis_interval=0.1, p_loss=0.05,
            recovery_time=0.05, seed=3, inbox_k=1, pool_slots=16,
            layout="lead", check_workers=0, pipeline="on", chunk_ticks=100,
            heartbeat=False, device_profile="off", aot_store="off")
MODEL_KW = dict(n_nodes_hint=3, log_cap=64, heartbeat=8)


def _histories(run_dir, n):
    out = []
    for i in range(n):
        with open(os.path.join(run_dir, f"history-{i}.jsonl")) as f:
            out.append(f.read())
    return out


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    jroot = str(tmp_path_factory.mktemp("jax-store"))
    troot = str(tmp_path_factory.mktemp("torch-store"))
    jres = run_tpu_test(JRaftModel(**MODEL_KW),
                        dict(OPTS, store_root=jroot))
    tres = harness.run_torch_test(RaftModel(**MODEL_KW),
                                  dict(OPTS, store_root=troot),
                                  device="cpu")
    return jres, tres


def test_slice_matches_jax_runtime(both_runs):
    jres, tres = both_runs
    assert tres["perf"]["phases"]["pipeline"]["chunks"] >= 2
    assert tres["valid?"] is True and jres["valid?"] is True
    assert tres["net"] == {k: jres["net"][k] for k in tres["net"]}
    assert tres["net"]["dropped-partition"] > 0
    assert tres["invariants"] == jres["invariants"]
    assert [r["valid?"] for r in tres["instances"]] == \
        [r["valid?"] for r in jres["instances"]]
    assert tres["device"] == {"type": "cpu", "name": "cpu", "count": 1}


def test_slice_histories_identical(both_runs):
    jres, tres = both_runs
    n = OPTS["record_instances"]
    th = _histories(tres["store-dir"], n)
    jh = _histories(jres["store-dir"], n)
    assert th == jh
    assert all(len(h.splitlines()) > 20 for h in th)
    with open(os.path.join(tres["store-dir"], "results.json")) as f:
        assert json.load(f)["valid?"] is True


def test_unpipelined_run_matches_pipelined(both_runs):
    _, tres = both_runs
    res = harness.run_torch_test(RaftModel(**MODEL_KW),
                                 dict(OPTS, pipeline="off"), device="cpu")
    assert res["net"] == tres["net"]
    assert [r["valid?"] for r in res["instances"]] == \
        [r["valid?"] for r in tres["instances"]]


def test_compacted_events_expand_to_dense():
    """The pipeline's compacted chunks rebuild the unchunked loop's
    nonempty events, and the carries agree."""
    model = RaftModel(**MODEL_KW)
    sim = harness.make_sim_config(model, dict(OPTS, n_instances=8,
                                              time_limit=0.2))
    res = pipeline.run_sim_pipelined(model, sim, 3, "cpu", chunk=50,
                                     event_cap=64)
    carry, ys = runtime.run_sim(model, sim, 3, "cpu")
    dense = ys.events.numpy()
    dense[..., -1] = 0                # the msg-id lane is not carried
    dense[dense[..., 0] == 0] = 0     # nor the lanes of empty events
    assert res.perf["chunks"] == 4 and res.perf["overflowed-chunks"] == 0
    np.testing.assert_array_equal(
        pipeline.expand_compact_events(model, sim, res.compact), dense)
    np.testing.assert_array_equal(res.carry.pool.numpy(),
                                  carry.pool.numpy())
    assert res.scan.shape == (8, 3) and (res.scan[:, 2] == -1).all()


def test_cuda_request_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        harness.run_torch_test(RaftModel(**MODEL_KW), dict(OPTS))


def test_chip_smoke_without_card(tmp_path):
    """chip_smoke.py prints no result line and exits non-zero without a
    card; its CPU rehearsal runs every phase but the build (plain
    versions, tiny size) and exits 2."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(repo, "chip_smoke.py")
    out = subprocess.run([sys.executable, script], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=one_thread_env())
    assert out.returncode != 0 and '"ok"' not in out.stdout
    out = subprocess.run([sys.executable, script, "--rehearse-on-cpu",
                          "--time-limit", "0.2"],
                         cwd=repo, capture_output=True, text=True,
                         timeout=300, env=one_thread_env())
    assert out.returncode == 2, out.stderr[-2000:]
    assert "bit-equal to deliver_reference" in out.stdout
    assert "for 200 ticks: valid?=True" in out.stdout
    assert "phase 18 (demo): `python -m maelstrom_tpu_torch demo " \
        "--time-limit 3` (3 entries, 1 on the native engine)" in out.stdout
    assert "phase 18 (b) (native lin-kv): run_native_test" in out.stdout
    assert '"ok"' not in out.stdout


def test_cli_runs_on_cpu(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cmd = [sys.executable, "-m", "maelstrom_tpu_torch", "test",
           "--runtime", "tpu", "-w",
           "lin-kv", "--node-count", "3", "--concurrency", "2",
           "--rate", "100", "--latency", "10",
           "--n-instances", "4", "--record-instances", "2",
           "--time-limit", "0.2", "--nemesis", "partition",
           "--nemesis-interval", "0.05", "--p-loss", "0.05",
           "--inbox-k", "1", "--pool-slots", "16",
           "--store", str(tmp_path), "--device", "cpu"]
    out = subprocess.run(cmd, cwd=repo, capture_output=True, text=True,
                         timeout=300, env=one_thread_env())
    assert out.returncode == 0, out.stderr[-2000:]
    assert '"valid?": true' in out.stdout
    assert os.path.exists(tmp_path / "lin-kv-torch" / "latest"
                          / "results.json")
