"""The port's fault-plan engine and the two further nemesis kinds against
the JAX package.

Plans compile and generate to the JAX engine's tuples and refuse the
same inputs; ``tick_planes`` selects the JAX engine's planes at every
tick; runs under an active plan (crash + links + skew, and membership)
and under the ``isolated-node`` and ``majorities-ring`` nemesis equal
the JAX runtime's carry (lead layout) at every tick, snapshot slab
included; an all-healthy plan equals the bare run; ``run_torch_test``
under a plan gives the JAX harness's histories, verdicts and counters;
and ``make_sim_config`` refuses what the port does not implement.
Tolerance 0 throughout: the state is int32 and the draws bit-defined."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maelstrom_tpu import faults as jfaults
from maelstrom_tpu.faults import engine as jengine
from maelstrom_tpu.models.raft import RaftModel as JRaftModel
from maelstrom_tpu.tpu import harness as jharness
from maelstrom_tpu.tpu import runtime as jruntime
from maelstrom_tpu.tpu.harness import run_tpu_test
from maelstrom_tpu_torch import convert, faults, harness, runtime
from maelstrom_tpu_torch.faults import engine
from maelstrom_tpu_torch.models.raft import RaftModel

from torch_tutorial_cases import one_thread_env
from torch_tutorial_cases import one_torch_thread  # noqa: F401 (autouse)

# 16 instances x 200 ticks; partitions in [50, 100), [150, 200)
OPTS = dict(node_count=3, concurrency=6, n_instances=16, record_instances=2,
            time_limit=0.2, rate=200.0, latency=5.0, rpc_timeout=1.0,
            nemesis=["partition"], nemesis_interval=0.05, p_loss=0.05,
            recovery_time=0.02, seed=7, telemetry=True, inbox_k=1,
            pool_slots=16, layout="lead")
MODEL_KW = dict(log_cap=64, heartbeat=8)

# crash + asymmetric/slow/lossy links + skew, with a majority crash
CRASH_LINKS_SKEW_PLAN = {"phases": [
    {"until": 30},
    {"until": 70, "crash": [0], "skew": {"1": 2.0, "2": 0.75}},
    {"until": 110, "links": [{"dst": 1, "src": 0, "block": True},
                             {"dst": 0, "src": 1, "delay": 7},
                             {"dst": 0, "src": 2, "loss": 0.4},
                             {"dst": 0, "src": 2, "delay": 3}]},
    {"until": 150, "crash": [1, 2], "skew": {"0": 1.5}},
    {"until": 175, "skew": {"0": 0.5, "1": 8.0}}]}
# remove, rejoin, an absolute set, and a crash of a parked node
MEMBERSHIP_PLAN = {"snapshot_every": 3, "phases": [
    {"until": 40, "members": [0, 1]},
    {"until": 80, "add": [2]},
    {"until": 120, "remove": [0], "crash": [0]},
    {"until": 160, "members": [0, 1, 2], "skew": {"2": 1.25}},
    {"until": 185, "remove": [1]}]}
# lanes present, values neutral: zero edges, rate-1.0 clocks, everyone a
# member, and a crash phase past the final heal (tick 180)
NEUTRAL_PLAN = {"phases": [
    {"until": 190, "members": [0, 1, 2],
     "links": [{"dst": 0, "src": 1, "delay": 0, "loss": 0.0}],
     "skew": {str(i): 1.0 for i in range(3)}},
    {"until": 100_000, "crash": [0]}]}

RUNS = {
    "crash-links-skew": dict(fault_plan=CRASH_LINKS_SKEW_PLAN),
    "membership": dict(fault_plan=MEMBERSHIP_PLAN),
    "isolated-node": dict(nemesis_kind="isolated-node"),
    "majorities-ring": dict(nemesis_kind="majorities-ring", node_count=5),
}


def _models(opts):
    kw = dict(MODEL_KW, n_nodes_hint=opts["node_count"])
    return JRaftModel(**kw), RaftModel(**kw)


def _leaves(carry):
    return dict(convert.carry_leaves(carry))


def jax_trajectory(opts):
    """The JAX lead-layout run: numpy carry leaves after every tick and
    the recorded events."""
    jmodel, _ = _models(opts)
    sim = jharness.make_sim_config(jmodel, opts)
    carry = jruntime.init_carry(jmodel, sim, opts["seed"], None)
    tick = jax.jit(jruntime.make_tick_fn(jmodel, sim, None))
    carries = [_leaves(jax.tree.map(np.asarray, carry))]
    events = []
    for t in range(sim.n_ticks):
        carry, ys = tick(carry, jnp.int32(t))
        carries.append(_leaves(jax.tree.map(np.asarray, carry)))
        events.append(np.asarray(ys.events))
    return sim, carries, events


def assert_port_matches(opts, jax_run):
    """The port's tick loop equals the JAX trajectory at every tick,
    every leaf of the port's carry; returns the final port carry."""
    jsim, jcarries, jevents = jax_run
    _, model = _models(opts)
    sim = harness.make_sim_config(model, opts)
    assert sim.n_ticks == jsim.n_ticks
    carry = runtime.init_carry(model, sim, opts["seed"], "cpu")
    tick = runtime.make_tick_fn(model, sim, device="cpu")
    with torch.no_grad():
        for t in range(-1, sim.n_ticks):
            if t >= 0:
                carry, out = tick(carry, t)
                np.testing.assert_array_equal(
                    jevents[t], out.events.numpy(), err_msg=f"events at {t}")
            ref = jcarries[t + 1]
            got = _leaves(convert.carry_to_numpy(carry))
            assert set(got) <= set(ref), set(got) - set(ref)
            for name, x in got.items():
                np.testing.assert_array_equal(
                    ref[name], x, err_msg=f"{name} after tick {t}")
    return sim, carry


@pytest.fixture(scope="module", params=list(RUNS))
def run_case(request):
    opts = dict(OPTS, **RUNS[request.param])
    return request.param, opts, jax_trajectory(opts)


# --- spec and compile --------------------------------------------------------


@pytest.mark.parametrize("plan", [CRASH_LINKS_SKEW_PLAN, MEMBERSHIP_PLAN,
                                  NEUTRAL_PLAN, None])
def test_compile_fault_plan_matches_jax(plan):
    for every in (None, 4):
        ref = jfaults.compile_fault_plan(plan, 3, 180, snapshot_every=every)
        got = faults.compile_fault_plan(plan, 3, 180, snapshot_every=every)
        assert tuple(got) == tuple(ref)
        for lane in ("has_crash", "has_links", "has_skew", "has_members",
                     "active"):
            assert getattr(got, lane) == getattr(ref, lane), lane


@pytest.mark.parametrize("kinds", [[k] for k in faults.FAULT_KINDS]
                         + [list(faults.FAULT_KINDS)])
def test_generate_fault_plan_matches_jax(kinds):
    for n_nodes, n_ticks, interval, stop in ((3, 600, 50, 500),
                                             (5, 2500, 10_000, 2400),
                                             (1, 300, 40, 250)):
        ref = jfaults.generate_fault_plan(kinds, n_nodes, n_ticks, interval,
                                          stop)
        got = faults.generate_fault_plan(kinds, n_nodes, n_ticks, interval,
                                         stop)
        assert got == ref
        assert tuple(faults.compile_fault_plan(got, n_nodes, stop)) == \
            tuple(jfaults.compile_fault_plan(ref, n_nodes, stop))


@pytest.mark.parametrize("plan", [
    {}, [], {"phases": [{"until": 0}]},
    {"phases": [{"until": 10}, {"until": 5}]},
    {"phases": [{"until": 10, "crash": [7]}]},
    {"phases": [{"until": 10, "links": [{"dst": 0, "src": 1,
                                         "loss": 2.0}]}]},
    {"phases": [{"until": 10, "links": [{"dst": 0, "src": 1,
                                         "delay": 99_999}]}]},
    {"phases": [{"until": 10, "links": ["x"]}]},
    {"phases": [{"until": 10, "skew": {"0": 100.0}}]},
    {"phases": [{"until": 10, "skew": [1]}]},
    {"snapshot_every": 0, "phases": [{"until": 10}]},
    {"phases": [{"until": 10, "members": [0], "add": [1]}]},
    {"phases": [{"until": 10, "remove": [0, 1, 2]}]},
    {"phases": [{"until": 10, "members": ["a"]}]},
])
def test_validation_errors_match_jax(plan):
    with pytest.raises(jfaults.SpecError) as ref:
        jfaults.validate_fault_plan(plan, 3)
    with pytest.raises(faults.SpecError) as got:
        faults.validate_fault_plan(plan, 3)
    assert str(got.value) == str(ref.value)


def test_membership_heal_phases_match_jax():
    from maelstrom_tpu.faults.spec import membership_heal_phases as jheal
    from maelstrom_tpu_torch.faults.spec import membership_heal_phases
    for plan in (MEMBERSHIP_PLAN, NEUTRAL_PLAN, CRASH_LINKS_SKEW_PLAN):
        assert membership_heal_phases(plan, 3) == jheal(plan, 3)
        assert membership_heal_phases(plan) == jheal(plan)


@pytest.mark.parametrize("plan", [CRASH_LINKS_SKEW_PLAN, MEMBERSHIP_PLAN])
def test_tick_planes_match_jax(plan):
    _, model = _models(OPTS)
    sim = harness.make_sim_config(model, dict(OPTS, fault_plan=plan))
    fx, cfg = sim.faults, sim.net
    jfx = jfaults.compile_fault_plan(plan, 3, fx.stop_tick)
    tables = engine.plan_tables(fx, cfg)
    I = 4
    select = jax.jit(lambda t: jengine.tick_planes(jfx, cfg, t))
    for t in range(sim.n_ticks + 5):
        ref = select(jnp.int32(t))
        got = engine.tick_planes(fx, tables, t, I)
        for f in got._fields:
            r, g = getattr(ref, f), getattr(got, f)
            assert (r is None) == (g is None), f
            if g is not None:
                assert g.shape[0] == I
                for i in range(I):
                    np.testing.assert_array_equal(
                        np.asarray(r), g[i].numpy(), err_msg=f"{f} at {t}")
        assert engine.phase_summary(fx, t) == jengine.phase_summary(jfx, t)
    for t0, n in ((0, 50), (60, 30), (150, 100)):
        assert engine.span_summary(fx, t0, n) == \
            jengine.span_summary(jfx, t0, n)
    assert engine.plan_summary(fx) == jengine.plan_summary(jfx)


@pytest.mark.parametrize("kind,n", [("isolated-node", 3),
                                    ("majorities-ring", 3),
                                    ("majorities-ring", 5),
                                    ("majorities-ring", 7)])
def test_partition_matrix_matches_jax(kind, n):
    opts = dict(OPTS, node_count=n)
    _, model = _models(opts)
    sim = harness.make_sim_config(model, opts)
    nem = runtime.NemesisConfig(enabled=True, interval=20, kind=kind,
                                stop_tick=90)
    jnem = jruntime.NemesisConfig(enabled=True, interval=20, kind=kind,
                                  stop_tick=90)
    ids = jnp.arange(16, dtype=jnp.int32)
    jkeys = jruntime._instance_keys(jax.random.PRNGKey(11),
                                    jruntime._RNG_NEMESIS, ids)
    tkeys = torch.from_numpy(np.asarray(jkeys).astype(np.int64))
    active = 0
    for t in (0, 19, 20, 39, 40, 60, 75, 89, 90, 95):
        ref = np.asarray(jax.vmap(lambda k: jruntime.partition_matrix(
            jnem, sim.net, jnp.int32(t), k))(jkeys))
        got = runtime.partition_matrix(nem, sim.net, t, tkeys).numpy()
        np.testing.assert_array_equal(ref, got, err_msg=f"{kind} t={t}")
        active += int(got.any())
    assert active >= 4


# --- runs against the JAX runtime ----------------------------------------------


def test_run_matches_jax_every_tick(run_case):
    name, opts, jax_run = run_case
    sim, carry = assert_port_matches(opts, jax_run)
    assert int(carry.stats.dropped_partition) > 0
    assert int((carry.node_state.commit_idx > 0).sum()) > 0
    if opts.get("fault_plan"):
        assert carry.snapshots is not None and sim.faults.active
        assert set(carry.snapshots) == set(RaftModel.DURABLE_LANES)


def test_all_healthy_plan_equals_bare_run():
    """A plan whose lanes are present but value-neutral leaves every
    leaf of the bare run's carry as it is, at every tick."""
    _, model = _models(OPTS)
    sims = [harness.make_sim_config(model, o)
            for o in (OPTS, dict(OPTS, fault_plan=NEUTRAL_PLAN))]
    assert sims[1].faults.has_crash and sims[1].faults.has_members
    carries = [runtime.init_carry(model, s, OPTS["seed"], "cpu")
               for s in sims]
    ticks = [runtime.make_tick_fn(model, s, device="cpu") for s in sims]
    with torch.no_grad():
        for t in range(sims[0].n_ticks):
            (bare, ev0), (neutral, ev1) = (
                tick(c, t) for tick, c in zip(ticks, carries))
            carries = [bare, neutral]
            np.testing.assert_array_equal(ev0.events.numpy(),
                                          ev1.events.numpy())
            b = _leaves(convert.carry_to_numpy(bare))
            n = _leaves(convert.carry_to_numpy(neutral))
            assert set(n) - set(b) == {f"carry.snapshots.{k}"
                                       for k in RaftModel.DURABLE_LANES}
            for k, v in b.items():
                np.testing.assert_array_equal(v, n[k], err_msg=f"{k} at {t}")


def _histories(run_dir, n):
    out = []
    for i in range(n):
        with open(os.path.join(run_dir, f"history-{i}.jsonl")) as f:
            out.append(f.read())
    return out


def test_harness_under_plan_matches_jax(tmp_path):
    """``run_torch_test`` under an active plan (pipelined over several
    chunks) gives the JAX harness's histories, verdicts and counters."""
    opts = dict(OPTS, fault_plan=CRASH_LINKS_SKEW_PLAN, check_workers=0,
                pipeline="on", chunk_ticks=50, heartbeat=False,
                device_profile="off", aot_store="off")
    jmodel, model = _models(opts)
    jres = run_tpu_test(jmodel, dict(opts, store_root=str(tmp_path / "j")))
    tres = harness.run_torch_test(
        model, dict(opts, store_root=str(tmp_path / "t")), device="cpu")
    assert tres["net"] == {k: jres["net"][k] for k in tres["net"]}
    assert tres["valid?"] is True and jres["valid?"] is True
    assert [r["valid?"] for r in tres["instances"]] == \
        [r["valid?"] for r in jres["instances"]]
    assert {k: tres["invariants"][k] for k in jres["invariants"]} == \
        jres["invariants"]
    n = opts["record_instances"]
    assert _histories(tres["store-dir"], n) == \
        _histories(jres["store-dir"], n)
    assert tres["faults"]["lanes"] == ["crash-restart", "link-degradation",
                                       "clock-skew"]


# --- options -------------------------------------------------------------------


@pytest.mark.parametrize("extra,msg", [
    (dict(topology="tree"), "topology"),
    (dict(layout="minor"), "layout"),
    (dict(check_mode="bogus"), "check_mode"),
    # profile_dir is taken since the profiler was ported; a misspelt
    # option is what could still be dropped
    pytest.param(dict(profile_dirs="profile"), "profile_dirs",
                 id="extra3-profile_dir"),
    (dict(nemesis=["partition", "bridge"]), "bridge"),
    (dict(nemesis_kind="ring"), "ring"),
])
def test_unimplemented_option_raises(extra, msg):
    """Nothing is dropped silently: an option (or an option value) the
    port does not implement raises, naming it."""
    _, model = _models(OPTS)
    with pytest.raises(ValueError, match=msg):
        harness.make_sim_config(model, dict(OPTS, **extra))


@pytest.mark.parametrize("extra", [
    dict(fault_plan=CRASH_LINKS_SKEW_PLAN, nemesis=["crash-restart"]),
    dict(fault_fuzz={"crash": {"victims": 1}}, fault_plan=MEMBERSHIP_PLAN),
    dict(fault_fuzz={"crash": {"victims": 1}}, nemesis=["clock-skew"]),
    dict(node_count=1, nemesis=["crash-restart", "link-degrade"]),
])
def test_fault_option_errors_match_jax(extra):
    opts = dict(OPTS, **extra)
    jmodel, model = _models(opts)
    with pytest.raises(ValueError) as ref:
        jharness.make_sim_config(jmodel, opts)
    with pytest.raises(ValueError) as got:
        harness.make_sim_config(model, opts)
    assert str(got.value) == str(ref.value)


def test_fault_options_compile_as_jax():
    for extra in (dict(nemesis=["partition", "crash-restart",
                                "membership"]),
                  dict(nemesis=list(faults.FAULT_KINDS),
                       fault_snapshot_every=5),
                  dict(fault_plan=MEMBERSHIP_PLAN, fault_snapshot_every=2)):
        opts = dict(OPTS, **extra)
        jmodel, model = _models(opts)
        ref = jharness.make_sim_config(jmodel, opts).faults
        got = harness.make_sim_config(model, opts).faults
        assert tuple(got) == tuple(ref) and got.active


def test_cli_fault_flags_on_cpu(tmp_path):
    """``python -m maelstrom_tpu_torch test`` takes a plan file, the
    slab stride and a nemesis kind, and reports the plan's lanes."""
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps(CRASH_LINKS_SKEW_PLAN))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cmd = [sys.executable, "-m", "maelstrom_tpu_torch", "test", "-w",
           "lin-kv", "--node-count", "3", "--concurrency", "2",
           "--n-instances", "4", "--record-instances", "1",
           "--time-limit", "0.2", "--nemesis", "partition",
           "--nemesis-interval", "0.05", "--nemesis-kind", "isolated-node",
           "--fault-plan", str(plan), "--fault-snapshot-every", "3",
           "--inbox-k", "1", "--pool-slots", "16",
           "--store", str(tmp_path), "--device", "cpu"]
    out = subprocess.run(cmd, cwd=repo, capture_output=True, text=True,
                         timeout=300, env=one_thread_env())
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout)
    assert res["valid?"] is True
    assert res["faults"] == {"phases": 5, "lanes": [
        "crash-restart", "link-degradation", "clock-skew"],
        "snapshot-every": 3, "stop-tick": 100}
