"""The port's checker farm (``checkers/pool.py``) against its serial path.

A run started from a real entry point — the port's command line in a
subprocess, so the pool spawns even where the test process's
``__main__`` cannot be re-imported (pytest's xdist workers; the JAX
package's pool tests check serially there) — with ``--check-workers 2``
reports ``mode: "pooled"``, and its per-instance verdicts and stored
``history-<i>.jsonl`` equal the serial run's byte for byte. Cases: one
per checker family (WGL with its native core, the incremental unique-ids
twin, Elle, set-full) and the device routing modes through the pool. The
killed-pool fallback, the incremental twin, blow-ups and the streaming
decoder are in ``test_torch_check_farm.py``.

Tolerance: exact."""

import json
import os
import subprocess
import sys

import pytest

from maelstrom_tpu_torch import harness
from maelstrom_tpu_torch.models import get_model

from torch_tutorial_cases import one_thread_env
from torch_tutorial_cases import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the JAX pool tests' DECODE_OPTS (tests/test_check_pool.py:36-41) cut
# from 0.5 s to 0.2 s
DECODE_OPTS = dict(node_count=3, concurrency=4, n_instances=8,
                   record_instances=8, time_limit=0.2, rate=300.0,
                   latency=4.0, rpc_timeout=0.25, nemesis=["partition"],
                   nemesis_interval=0.1, p_loss=0.05, recovery_time=0.05,
                   pool_slots=32, seed=11, inbox_k=8)
# the JAX routing test's double-vote fleet (tests/test_device_check.py
# MUTANT_OPTS) at 16 instances, all recorded, cut from 0.3 s to 0.2 s:
# instances 13 and 14 trip by tick 97
MUTANT = dict(DECODE_OPTS, concurrency=6, n_instances=16,
              record_instances=16, time_limit=0.2, rate=200.0,
              latency=5.0, rpc_timeout=1.0, nemesis_interval=0.04,
              recovery_time=0.0, pool_slots=16, seed=7, inbox_k=1)
FLAGS = {"node_count": "--node-count", "concurrency": "--concurrency",
         "n_instances": "--n-instances",
         "record_instances": "--record-instances",
         "time_limit": "--time-limit", "rate": "--rate",
         "latency": "--latency", "rpc_timeout": "--rpc-timeout",
         "nemesis_interval": "--nemesis-interval", "p_loss": "--p-loss",
         "recovery_time": "--recovery-time", "pool_slots": "--pool-slots",
         "seed": "--seed", "inbox_k": "--inbox-k",
         "check_mode": "--check-mode"}

POOL_CASES = [("lin-kv", "farm"), ("unique-ids", "farm"),
              ("txn-list-append", "farm"), ("g-set", "both"),
              ("lin-kv-bug-double-vote", "device")]


def _opts(workload, mode):
    return dict(MUTANT if mode == "device" else DECODE_OPTS,
                check_mode=mode)


def _cli_run(workload, opts, workers, store):
    argv = [sys.executable, "-m", "maelstrom_tpu_torch", "test", "-w",
            workload, "--device", "cpu", "--store", store,
            "--check-workers", str(workers)]
    for k, flag in FLAGS.items():
        argv += [flag, str(opts[k])]
    for k in opts["nemesis"]:
        argv += ["--nemesis", k]
    proc = subprocess.run(argv, cwd=REPO, env=one_thread_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode in (0, 1), proc.stderr[-2000:]
    return os.path.join(store, f"{workload}-torch", "latest")


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("workload,mode", POOL_CASES)
def test_pooled_verdicts_and_histories_equal_serial(tmp_path, workload,
                                                    mode):
    opts = _opts(workload, mode)
    pooled = _cli_run(workload, opts, 2, str(tmp_path / "pooled"))
    serial = harness.run_torch_test(
        get_model(workload, opts["node_count"]),
        dict(opts, check_workers=0, store_root=str(tmp_path / "serial")),
        device="cpu")["store-dir"]
    p = json.loads(_read(os.path.join(pooled, "results.json")))
    s = json.loads(_read(os.path.join(serial, "results.json")))
    rec = p["perf"]["phases"]["check"]
    assert rec["mode"] == "pooled" and rec["workers"] == 2, rec
    assert s["perf"]["phases"]["check"]["mode"] == "serial"
    for k in ("valid?", "instances", "net", "invariants", "check"):
        assert p.get(k) == s.get(k), k
    assert rec["farm-instances"] == s["perf"]["phases"]["check"][
        "farm-instances"]
    for i in range(opts["record_instances"]):
        name = f"history-{i}.jsonl"
        assert _read(os.path.join(pooled, name)) == \
            _read(os.path.join(serial, name)), name
    assert any(_read(os.path.join(serial, f"history-{i}.jsonl")).strip()
               for i in range(opts["record_instances"]))
    if mode == "device":
        assert 0 < rec["farm-instances"] < opts["record_instances"]
