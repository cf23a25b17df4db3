"""The configurations shared by ``test_torch_tutorial.py`` (tick-by-tick
carries) and ``test_torch_tutorial_checkers.py`` (both harnesses): one
case per tutorial workload, the guide's 25-node tree4 broadcast at test
size, and cold restarts under a crash and links plan; and the fixture
that pins the port's CPU ops to one thread, which every port test file
imports."""

import os

import pytest
import torch

# 150 ticks; partitions in [50, 100), final heal at 120
BASE = dict(node_count=3, concurrency=6, n_instances=8, record_instances=2,
            time_limit=0.15, rate=200.0, latency=5.0, rpc_timeout=1.0,
            nemesis=["partition"], nemesis_interval=0.05, p_loss=0.05,
            recovery_time=0.03, seed=5, telemetry=True, inbox_k=2,
            pool_slots=32, layout="lead")
# the guide's broadcast (doc/guide/03-broadcast.md) at test size
BROADCAST_25 = dict(BASE, node_count=25, concurrency=25, n_instances=4,
                    time_limit=0.2, rate=100.0, latency=10.0, p_loss=0.0,
                    nemesis_interval=0.04, recovery_time=0.04, inbox_k=8,
                    pool_slots=256)
# crashes (one node, then two) and degraded links, healed at tick 120
CRASH_LINKS_PLAN = {"phases": [
    {"until": 20},
    {"until": 60, "crash": [0]},
    {"until": 90, "links": [{"dst": 1, "src": 0, "block": True},
                            {"dst": 0, "src": 2, "delay": 6},
                            {"dst": 2, "src": 1, "loss": 0.5}]},
    {"until": 110, "crash": [1, 2]}]}

CASES = {
    "echo": ("echo", "grid", BASE),
    "unique-ids": ("unique-ids", "grid", BASE),
    "broadcast": ("broadcast", "grid", BASE),
    "g-set": ("g-set", "line", dict(BASE, rpc_timeout=0.25)),
    "g-counter": ("g-counter", "grid", dict(BASE, rpc_timeout=0.25)),
    "pn-counter": ("pn-counter", "grid", dict(BASE, rpc_timeout=0.25)),
    "broadcast-25-tree4": ("broadcast", "tree4", BROADCAST_25),
    "g-set-crash-links": ("g-set", "grid",
                          dict(BASE, fault_plan=CRASH_LINKS_PLAN)),
    "pn-counter-crash-links": ("pn-counter", "grid",
                               dict(BASE, fault_plan=CRASH_LINKS_PLAN)),
}
# run_tpu_test's lifecycle options, off (the port accepts and ignores
# all but the heartbeat, which it writes as JAX does)
JAX_RUN = dict(check_workers=0, heartbeat=False, device_profile="off",
               aot_store="off")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ticks are many small ops: one intra-op thread is as
    fast alone and does not oversubscribe the cores that parallel test
    workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def one_thread_env():
    """The environment of a port subprocess: one torch thread, as the
    fixture above sets in the test processes."""
    return dict(os.environ, OMP_NUM_THREADS="1")
