"""The bench's configs, funnel and merged line at unit size, against the
JAX bench (``bench.py``) and runtime on the CPU.

- The port's config table gives the sims ``bench.py:239-261`` builds
  from its options, for ``k1``, ``k1-16k`` and ``k3``.
- ``k3`` (``inbox_k`` 3, 48 slots) over 64 instances and 100 ticks of
  the port's ``run_sim`` equals JAX's: the counters, the latency
  histogram and the violations (the JAX child runs only ``k1`` on the
  CPU, so the bench comparison cannot reach it).
- The port's copies of ``_funnel_block`` and ``_preference`` equal the
  root module's on stub replays; the merged line equals the one
  ``parent_main`` prints from the same per-config lines.
"""

import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from maelstrom_tpu.models.raft import RaftModel as JRaftModel
from maelstrom_tpu.tpu import harness as jharness
from maelstrom_tpu.tpu import runtime as jruntime
from maelstrom_tpu_torch import bench, harness, runtime

from torch_tutorial_cases import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def root_bench():
    """The root ``bench.py`` as a module (it imports no JAX at top)."""
    spec = importlib.util.spec_from_file_location(
        "root_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def bench_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith("BENCH_"):
            monkeypatch.delenv(k)
    return monkeypatch


def jax_options(n_instances, sim_seconds, knobs):
    """``bench.py:239-261``'s options at the default knobs."""
    return dict(node_count=3, concurrency=6, n_instances=n_instances,
                record_instances=1, time_limit=sim_seconds, rate=200.0,
                latency=5.0, rpc_timeout=1.0, nemesis=["partition"],
                nemesis_interval=0.4, p_loss=0.05, recovery_time=0.3,
                seed=7, telemetry=True, check_mode="farm",
                fault_fuzz={"windows": [2, 4], "gap": [40, 200],
                            "duration": [20, 100],
                            "links": {"rate": 0.0, "edges": [1, 2]},
                            "skew": {"rate": 0.0, "victims": [1, 1]}},
                **knobs)


def _plain(x):
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {f: _plain(getattr(x, f)) for f in x._fields}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return repr(x)


def test_config_plan_is_bench_py_s(bench_env):
    """``bench.py:174-188, 234-238``: three configs on the card, k1-16k
    at max(16384, instances) and half the horizon (skipped from 16,384
    instances on), k1 alone on the CPU."""
    plan = bench.plan_configs(4096, 4.0, on_cpu=False)
    assert [(n, k, s, i) for n, k, s, i in plan] == [
        ("k1", dict(inbox_k=1, pool_slots=16), 4.0, 4096),
        ("k1-16k", dict(inbox_k=1, pool_slots=16), 2.0, 16384),
        ("k3", dict(inbox_k=3, pool_slots=48), 2.0, 4096)]
    assert [p[0] for p in bench.plan_configs(16384, 4.0, False)] == [
        "k1", "k3"]
    assert [p[3] for p in bench.plan_configs(20000, 1.0, False)] == [
        20000, 20000]
    assert [p[0] for p in bench.plan_configs(256, 0.4, True)] == ["k1"]


@pytest.mark.parametrize("name", ["k1", "k1-16k", "k3"])
def test_config_sim_equals_jax(bench_env, name):
    """Each config's options give JAX's ``make_sim_config``, the layout
    "auto" resolves to on the CPU included."""
    (_, knobs, seconds, n), = [p for p in bench.plan_configs(4096, 4.0, False)
                               if p[0] == name]
    model, opts = bench.config_options(n, seconds, knobs)
    want = _plain(jharness.make_sim_config(
        JRaftModel(n_nodes_hint=3, log_cap=64, heartbeat=8),
        jax_options(n, seconds, knobs)))
    assert want["layout"] == "'lead'"
    assert _plain(harness.make_sim_config(model, opts)) == want
    assert (model.log_cap, model.heartbeat) == (64, 8)


def test_k3_run_sim_equals_jax(bench_env):
    """k3 over 64 instances and 100 ticks: counters, ``rpc_hist`` and
    violations equal to the JAX runtime's."""
    (_, knobs, _, _), = [p for p in bench.plan_configs(64, 0.2, False)
                         if p[0] == "k3"]
    model, opts = bench.config_options(64, 0.1, knobs)
    sim = harness.make_sim_config(model, opts)
    assert sim.n_ticks == 100 and sim.net.inbox_k == 3
    carry, _ = runtime.run_sim(model, sim, 7, "cpu")
    jmodel = JRaftModel(n_nodes_hint=3, log_cap=64, heartbeat=8)
    jsim = jharness.make_sim_config(jmodel, jax_options(64, 0.1, knobs))
    jcarry, _ = jruntime.run_sim(jmodel, jsim, 7,
                                 jmodel.make_params(jsim.net.n_nodes))
    assert [int(x) for x in carry.stats] == \
        [int(x) for x in jax.device_get(jcarry.stats)]
    np.testing.assert_array_equal(carry.telemetry.rpc_hist.numpy(),
                                  np.asarray(jcarry.telemetry.rpc_hist))
    np.testing.assert_array_equal(carry.violations.numpy(),
                                  np.asarray(jcarry.violations))
    assert int(carry.stats.delivered) > 0
    lat = bench.latency_ticks(carry)
    assert lat["p50"] <= lat["p95"] <= lat["p99"]


def _stub_replay(hist_of, viol_of, trunc_of=(), missing=(), raises=False):
    def replay(ids):
        if raises:
            raise RuntimeError("replay failed")
        return ({i: hist_of(i) for i in ids if i not in missing},
                {i: viol_of(i) for i in ids},
                {i: True for i in ids if i in trunc_of})
    return replay


def _checker(h):
    if h == "boom":
        raise ValueError("checker blew up")
    return {"valid?": h != "bad"}


FUNNEL_CASES = {
    # more trippers than BENCH_FUNNEL_MAX: the first three and the sample
    "past-the-cap": (np.array([0, 2, 1, 0, 3, 5, 0, 7, 1, 1, 0, 9, 4, 0]),
                     _stub_replay(lambda i: "ok", lambda i: int(i % 2)),
                     "3"),
    "missing-history": (np.array([0, 1] + [0] * 20),
                        _stub_replay(lambda i: "ok", lambda i: 1,
                                     missing={3}), None),
    "checker-error": (np.array([0] * 30),
                      _stub_replay(lambda i: "boom" if i == 4 else "bad",
                                   lambda i: 0), None),
    "truncated-unknown": (np.array([0, 0, 2] + [0] * 40),
                          _stub_replay(lambda i: "ok", lambda i: 1,
                                       trunc_of={2, 6}), None),
    "replay-raises": (np.array([1] * 9),
                      _stub_replay(None, None, raises=True), None),
    "tiny-fleet": (np.array([1]), _stub_replay(lambda i: "ok",
                                               lambda i: 1), None),
}


@pytest.mark.parametrize("case", sorted(FUNNEL_CASES))
def test_funnel_block_equals_bench_py_s(root_bench, bench_env, case):
    violations, replay, cap = FUNNEL_CASES[case]
    if cap is not None:
        bench_env.setenv("BENCH_FUNNEL_MAX", cap)
    got = bench._funnel_block(violations, replay, _checker)
    assert got == root_bench._funnel_block(violations, replay, _checker)
    assert json.loads(json.dumps(got)) == got


def test_preference_equals_bench_py_s(root_bench):
    recs = [{"value": 0.0, "platform": "gpu"},
            {"value": 5.0, "platform": "cpu"},
            {"value": 3.0, "platform": "gpu", "provisional": True},
            {"value": 2.0, "platform": "gpu", "partial": True},
            {"value": 1.0, "platform": "gpu"},
            {"value": 9.0, "platform": "gpu"}, {}]
    assert [bench._preference(r) for r in recs] == \
        [root_bench._preference(r) for r in recs]
    assert sorted(range(len(recs)), key=lambda i: bench._preference(
        recs[i])) == sorted(range(len(recs)),
                            key=lambda i: root_bench._preference(recs[i]))


def _line(config, value, **kw):
    rec = {"metric": "simulated_msgs_per_sec", "value": value,
           "vs_baseline": round(value / 60000.0, 3), "platform": "gpu",
           "config": config, "inbox_k": 3 if config == "k3" else 1,
           "pool_slots": 48 if config == "k3" else 16,
           "instances": 16384 if config == "k1-16k" else 4096,
           "sim_ticks": 4000, "delivered_timed": 100, "wall_s": 1.0,
           "dropped_overflow": 0, "complete": True}
    rec.update(kw)
    return rec


MERGE_CASES = {
    "16k-wins": [_line("k1", 50000.0, provisional=True), _line("k1", 52000.0),
                 _line("k1-16k", 150000.0), _line("k3", 45000.0)],
    "k1-wins": [_line("k1", 52000.0), _line("k1-16k", 40000.0),
                _line("k3", 45000.0)],
    "empty-window": [_line("k1", 52000.0),
                     _line("k1-16k", 0.0, provisional=True),
                     _line("k3", 45000.0)],
    "no-16k": [_line("k1", 52000.0, instances=16384),
               _line("k3", 45000.0, instances=16384)],
    "k3-provisional": [_line("k1", 52000.0), _line("k1-16k", 52000.0),
                       _line("k3", 1.0, provisional=True)],
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merged_line_equals_parent_main_s(root_bench, monkeypatch, capsys,
                                          case):
    """``parent_main`` with its child processes stubbed (a passing
    canary on a card, then one run printing these lines) prints the line
    the port's :func:`bench.merge_lines` builds, but for the ``attempt``
    name its retries add to every line."""
    lines = MERGE_CASES[case]
    from maelstrom_tpu.utils import driver_guard

    def run_child(cmd, env, deadline, tag):
        if "--canary" in cmd:
            return 0, json.dumps({"canary": True, "platform": "gpu"}), []
        return 0, "\n".join(json.dumps(r) for r in lines), []

    monkeypatch.setattr(driver_guard, "run_child", run_child)
    monkeypatch.setattr(driver_guard, "cpu_child_env", lambda n: {})
    assert root_bench.parent_main() == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    by_cfg = {}
    for r in lines:
        by_cfg[r["config"]] = r
    got = bench.merge_lines(by_cfg)
    for rec in (want, *want.values()):
        if isinstance(rec, dict):
            rec.pop("attempt", None)
    assert got == want
    assert got["config"] != "k3"
    assert "secondary" in got and got["secondary"]["config"] == "k3"
    assert ("alt_scale" in got) == (len(by_cfg) == 3)


def test_bench_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        bench.main([])


def test_a_config_that_raises_leaves_its_line_and_no_merge(
        bench_env, monkeypatch, capsys):
    """The run stops at the failing config with exit 1: its last line
    stays the last line printed, and no merged line hides the failure."""
    bench_env.setenv("BENCH_NO_NATIVE", "1")   # the device configs alone

    def run_config(name, knobs, seconds, n, dev, store_dir, print_line):
        print_line(_line(name, 1000.0))
        if name == "k1-16k":
            raise RuntimeError("lost the card")

    monkeypatch.setattr(bench, "run_config", run_config)
    monkeypatch.setattr(bench, "plan_configs",
                        lambda n, s, on_cpu: [(c, {}, s, n)
                                              for c, *_ in bench.CONFIGS])
    assert bench.main(["--device", "cpu", "--aot-store", "off"]) == 1
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [r["config"] for r in lines] == ["k1", "k1-16k"]
    assert "secondary" not in lines[-1]


def test_store_keys_and_certifies_a_per_length_buffer():
    """``cap`` None (the bench's buffer, sized per chunk length, as JAX's
    ``cap=None``) is keyed apart from any fixed capacity, and its
    certificate is the dispatch at the capacity of the recorded
    length."""
    from maelstrom_tpu_torch import aot_store
    from maelstrom_tpu_torch.analysis.cost_model import audit_sim
    from maelstrom_tpu_torch.models import get_model
    from maelstrom_tpu_torch.pipeline import event_capacity
    model = get_model("echo", 2)
    sim = audit_sim(model, 2)
    carry = aot_store._meta_carry(model, sim)
    ids = np.arange(sim.n_instances, dtype=np.int32)

    def key(cap):
        return aot_store.store_key(aot_store.pipelined_signature(
            model, sim, ids, cap, 8, 32, carry, True, ("cpu", "cpu")))
    cap_32 = event_capacity(sim, model, 32)
    assert len({key(None), key(cap_32), key(64)}) == 3
    digest = aot_store.graph_digest
    assert digest(aot_store.record_dispatch(
        "pipelined", model, sim, cap=None)) == digest(
        aot_store.record_dispatch(
            "pipelined", model, sim,
            cap=event_capacity(sim, model, aot_store.AOT_CHUNK_LEN)))
