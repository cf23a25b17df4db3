"""The port's fault fuzzer against the JAX package's.

``compile_fault_fuzz`` gives the JAX tuples and refuses the same
inputs; ``draw_schedule`` over 64 instances equals ``jax.vmap`` of the
JAX draw for every distribution the JAX tests use and the benchmark's;
``schedule_planes`` selects the JAX planes; an active four-lane fuzz
run equals the JAX runtime's carry (lead layout) at every tick,
``fault_sched`` and the snapshot slab included, and its harness run
gives the JAX histories, verdicts and counters; a run under the
benchmark's all-healthy distribution equals both the bare run and JAX;
the fleet summaries match; a fuzzed instance equals its
``schedule_to_plan`` replay; and a pipelined run equals the unpipelined
loop under faults. Tolerance 0 throughout."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maelstrom_tpu.faults import SpecError as JSpecError
from maelstrom_tpu.faults import fuzz as jfuzz
from maelstrom_tpu.models.raft import RaftModel as JRaftModel
from maelstrom_tpu.tpu import harness as jharness
from maelstrom_tpu.tpu import runtime as jruntime
from maelstrom_tpu.tpu.harness import run_tpu_test
from maelstrom_tpu_torch import convert, harness, pipeline, rng, runtime
from maelstrom_tpu_torch.faults import SpecError, fuzz
from maelstrom_tpu_torch.models.raft import RaftModel

from torch_tutorial_cases import one_torch_thread  # noqa: F401 (autouse)

# the JAX fuzz tests' distributions (tests/test_fault_fuzz.py and
# tests/test_membership.py) and the benchmark's
ACTIVE_DIST = {"windows": [2, 2], "gap": [40, 120], "duration": [30, 80],
               "crash": {"rate": 0.8, "victims": [1, 2]},
               "links": {"rate": 0.6, "edges": [1, 3], "block": 0.5,
                         "delay": [0, 20], "loss": [0.0, 0.3]},
               "skew": {"rate": 0.5, "victims": [1, 2],
                        "range": [0.5, 2.0]}}
HEALTHY_DIST = {"windows": [1, 2], "gap": [20, 60], "duration": [20, 50],
                "crash": {"rate": 0.0, "victims": [1, 2]},
                "links": {"rate": 0.0, "edges": [1, 2]},
                "skew": {"rate": 0.0, "victims": [1, 1]}}
MEMBER_HEALTHY_DIST = {"windows": [1, 2], "gap": [20, 60],
                       "duration": [20, 50],
                       "membership": {"rate": 0.0, "victims": [1, 2]}}
MEMBER_ACTIVE_DIST = {"windows": [2, 2], "gap": [60, 160],
                      "duration": [40, 90],
                      "membership": {"rate": 0.8, "victims": [1, 2]}}
# all four lanes at once, windows short enough for a 200-tick run
FOUR_LANE_DIST = {"windows": [2, 3], "gap": [5, 50], "duration": [15, 45],
                  "crash": {"rate": 0.7, "victims": [1, 1]},
                  "links": {"rate": 0.7, "edges": [1, 4], "block": 0.5,
                            "delay": [0, 12], "loss": [0.0, 0.4]},
                  "skew": {"rate": 0.6, "victims": [1, 2],
                           "range": [0.25, 3.0]},
                  "membership": {"rate": 0.6, "victims": [1, 1]},
                  "snapshot_every": 2}
DISTS = {"active": ACTIVE_DIST, "healthy": HEALTHY_DIST,
         "membership-healthy": MEMBER_HEALTHY_DIST,
         "membership-active": MEMBER_ACTIVE_DIST,
         "four-lane": FOUR_LANE_DIST, "bench": fuzz.BENCH_FUZZ_DIST}

# 16 instances x 200 ticks, the flagship's shape at test size
OPTS = dict(node_count=3, concurrency=6, n_instances=16, record_instances=2,
            time_limit=0.2, rate=200.0, latency=5.0, rpc_timeout=1.0,
            nemesis=["partition"], nemesis_interval=0.05, p_loss=0.05,
            recovery_time=0.02, seed=7, telemetry=True, inbox_k=1,
            pool_slots=16, layout="lead")
MODEL_KW = dict(n_nodes_hint=3, log_cap=64, heartbeat=8)


def _leaves(carry):
    return dict(convert.carry_leaves(carry))


def _port_leaves(carry):
    return _leaves(convert.carry_to_numpy(carry))


def _jax_keys(seed, n):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), fuzz.RNG_PURPOSE)
    return jax.vmap(lambda i: jax.random.fold_in(key, i))(
        jnp.arange(n, dtype=jnp.int32))


def _port_keys(jkeys):
    return torch.from_numpy(np.asarray(jkeys).astype(np.int64))


def jax_trajectory(opts):
    """The JAX lead-layout run: numpy carry leaves after every tick."""
    jmodel = JRaftModel(**MODEL_KW)
    sim = jharness.make_sim_config(jmodel, opts)
    carry = jruntime.init_carry(jmodel, sim, opts["seed"], None)
    tick = jax.jit(jruntime.make_tick_fn(jmodel, sim, None))
    carries = [_leaves(jax.tree.map(np.asarray, carry))]
    for t in range(sim.n_ticks):
        carry, _ = tick(carry, jnp.int32(t))
        carries.append(_leaves(jax.tree.map(np.asarray, carry)))
    return carries


def port_trajectory(opts, instance_ids=None):
    """The port's run on the CPU: carry leaves at init and after every
    tick."""
    model = RaftModel(**MODEL_KW)
    sim = harness.make_sim_config(model, opts)
    ids = (None if instance_ids is None
           else torch.tensor(instance_ids, dtype=torch.int32))
    carry = runtime.init_carry(model, sim, opts["seed"], "cpu", ids)
    tick = runtime.make_tick_fn(model, sim, ids, device="cpu")
    carries = [_port_leaves(carry)]
    with torch.no_grad():
        for t in range(sim.n_ticks):
            carry, _ = tick(carry, t)
            carries.append(_port_leaves(carry))
    return carries


def assert_trajectories_equal(ref, got):
    """Every leaf of ``got`` equals ``ref``'s at every tick."""
    for t, (r, g) in enumerate(zip(ref, got)):
        for name, x in g.items():
            np.testing.assert_array_equal(
                r[name], x, err_msg=f"{name} after tick {t - 1}")


@pytest.fixture(scope="module")
def four_lane_runs():
    opts = dict(OPTS, fault_fuzz=FOUR_LANE_DIST)
    return opts, jax_trajectory(opts), port_trajectory(opts)


# --- spec and compile --------------------------------------------------------


@pytest.mark.parametrize("name", list(DISTS))
def test_compile_fault_fuzz_matches_jax(name):
    for n_nodes in (3, 5):
        for every in (None, 3):
            ref = jfuzz.compile_fault_fuzz(DISTS[name], n_nodes, 600,
                                           snapshot_every=every)
            got = fuzz.compile_fault_fuzz(DISTS[name], n_nodes, 600,
                                          snapshot_every=every)
            assert tuple(got) == tuple(ref)
            for lane in ("has_crash", "has_links", "has_skew",
                         "has_members", "active", "has_fuzz"):
                assert getattr(got, lane) == getattr(ref, lane), lane
            assert fuzz.fuzz_summary(got) == jfuzz.fuzz_summary(ref)


@pytest.mark.parametrize("dist,n", [
    ({}, 3), ([], 3),
    ({"windows": [3, 1], "crash": {"victims": 1}}, 3),
    ({"crash": {"rate": 2.0, "victims": 1}}, 3),
    ({"crash": {"victims": [1, 7]}}, 3),
    ({"links": {"edges": [1, 2]}, "windows": 99}, 3),
    ({"skew": {"victims": 1, "range": [0.01, 1.0]}}, 3),
    ({"snapshot_every": 0, "crash": {"victims": 1}}, 3),
    ({"links": {"edges": 1}}, 1),
    ({"membership": {"victims": 1}}, 1),
    ({"membership": {"victims": [1, 3]}}, 3),
    ({"gap": [1, 2, 3], "crash": {"victims": 1}}, 3),
    ({"gap": "x", "crash": {"victims": 1}}, 3),
])
def test_validation_errors_match_jax(dist, n):
    with pytest.raises(JSpecError) as ref:
        jfuzz.validate_fault_fuzz(dist, n)
    with pytest.raises(SpecError) as got:
        fuzz.validate_fault_fuzz(dist, n)
    assert str(got.value) == str(ref.value)


# --- the draw and the planes ---------------------------------------------------


@pytest.mark.parametrize("name", list(DISTS))
@pytest.mark.parametrize("n_nodes", [3, 5])
def test_draw_schedule_matches_jax(name, n_nodes):
    fx = fuzz.compile_fault_fuzz(DISTS[name], n_nodes, 400)
    jfx = jfuzz.compile_fault_fuzz(DISTS[name], n_nodes, 400)
    jkeys = _jax_keys(7, 64)
    ref = jax.jit(jax.vmap(lambda k: jfuzz.draw_schedule(k, jfx, n_nodes)))(
        jkeys)
    got = fuzz.draw_schedule(_port_keys(jkeys), fx, n_nodes)
    for f in got._fields:
        r, g = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        assert r.dtype == g.dtype and r.shape == g.shape, f
        np.testing.assert_array_equal(r, g, err_msg=f)
    if name in ("active", "four-lane", "membership-active"):
        assert got.crash.any() or got.mem_out.any()


@pytest.mark.parametrize("name", ["four-lane", "membership-active",
                                  "bench"])
def test_schedule_planes_match_jax(name):
    model = RaftModel(**MODEL_KW)
    sim = harness.make_sim_config(model, dict(OPTS, time_limit=0.4,
                                              fault_fuzz=DISTS[name]))
    fx, cfg = sim.faults, sim.net
    jfx = jfuzz.compile_fault_fuzz(DISTS[name], 3, fx.stop_tick)
    jkeys = _jax_keys(3, 32)
    jsched = jax.vmap(lambda k: jfuzz.draw_schedule(k, jfx, 3))(jkeys)
    sched = fuzz.draw_schedule(_port_keys(jkeys), fx, 3)
    select = jax.jit(lambda t: jax.vmap(
        lambda s: jfuzz.schedule_planes(s, jfx, cfg, t))(jsched))
    # every window edge of the first instances, and the final heal
    edges = np.asarray(jsched.untils)[:2].reshape(-1)
    ticks = sorted({0, 1, fx.stop_tick - 1, fx.stop_tick, sim.n_ticks - 1}
                   | {int(e) + d for e in edges for d in (-1, 0, 1)
                      if 0 <= int(e) + d < sim.n_ticks})
    for t in ticks:
        ref = select(jnp.int32(t))
        got = fuzz.schedule_planes(sched, fx, cfg, t)
        for f in got._fields:
            r, g = getattr(ref, f), getattr(got, f)
            assert (r is None) == (g is None), f
            if g is not None:
                np.testing.assert_array_equal(np.asarray(r), g.numpy(),
                                              err_msg=f"{f} at {t}")


# --- runs ----------------------------------------------------------------------


def test_four_lane_run_matches_jax_every_tick(four_lane_runs):
    _, jax_run, port_run = four_lane_runs
    assert_trajectories_equal(jax_run, port_run)
    final = port_run[-1]
    assert {n.split(".")[1] for n in final} >= {"snapshots", "fault_sched"}
    sched = fuzz.FaultSchedule(*(final[f"carry.fault_sched.{f}"]
                                 for f in fuzz.FaultSchedule._fields))
    assert sched.crash.any() and sched.mem_out.any()
    assert sched.edge_block.any() and (sched.skew != 64).any()


def test_bench_distribution_equals_bare_run_and_jax():
    """The benchmark's all-healthy distribution: JAX's trajectory, and
    every leaf of the bare run's."""
    opts = dict(OPTS, fault_fuzz=fuzz.BENCH_FUZZ_DIST)
    fuzzed = port_trajectory(opts)
    assert_trajectories_equal(jax_trajectory(opts), fuzzed)
    bare = port_trajectory(OPTS)
    assert_trajectories_equal(fuzzed, bare)
    assert {n for n in fuzzed[-1] if n not in bare[-1]} == {
        f"carry.fault_sched.{f}" for f in fuzz.FaultSchedule._fields}


def test_fleet_summaries_match_jax():
    fx = fuzz.compile_fault_fuzz(FOUR_LANE_DIST, 3, 180)
    jfx = jfuzz.compile_fault_fuzz(FOUR_LANE_DIST, 3, 180)
    ids = np.arange(0, 96, 3)
    ref = jfuzz.fleet_windows(jfx, 3, 11, ids)
    got = fuzz.fleet_windows(fx, 3, 11, ids)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(ref[k], got[k], err_msg=k)
    assert fuzz.fleet_coverage(got) == jfuzz.fleet_coverage(ref)
    cov = fuzz.fleet_coverage(got)
    assert min(cov[f"{k}-windows"] for k in ("crash", "link", "skew",
                                              "membership")) > 0


def test_fuzzed_instance_equals_its_plan_replay(four_lane_runs):
    """An instance's schedule, re-drawn from (seed, id) and lowered to a
    plan, replays that instance bit for bit on its own."""
    opts, _, fleet = four_lane_runs
    fx = harness.make_sim_config(RaftModel(**MODEL_KW), opts).faults
    jfx = jfuzz.compile_fault_fuzz(FOUR_LANE_DIST, 3, fx.stop_tick)
    plans = {}
    for i in range(opts["n_instances"]):
        sched = fuzz.reconstruct_schedule(fx, 3, opts["seed"], i)
        jsched = jfuzz.reconstruct_schedule(jfx, 3, opts["seed"], i)
        for f in sched._fields:
            np.testing.assert_array_equal(getattr(sched, f),
                                          getattr(jsched, f), err_msg=f)
        plans[i] = fuzz.schedule_to_plan(sched, fx)
        assert plans[i] == jfuzz.schedule_to_plan(jsched, jfx)
    # an instance with crash, links and membership phases and a first gap
    i = next(i for i, p in plans.items()
             if p and all(any(k in ph for ph in p["phases"])
                          for k in ("crash", "links", "remove"))
             and "until" in p["phases"][0] and len(p["phases"][0]) == 1)
    replay_opts = {k: v for k, v in opts.items() if k != "fault_fuzz"}
    replay = port_trajectory(dict(replay_opts, n_instances=1,
                                  record_instances=1,
                                  fault_plan=plans[i]), instance_ids=[i])
    per_instance = ("carry.pool", "carry.node_state", "carry.client_state",
                    "carry.violations", "carry.snapshots")
    for t, (f, r) in enumerate(zip(fleet, replay)):
        for name, x in r.items():
            if name.startswith(per_instance):
                np.testing.assert_array_equal(
                    f[name][i], x[0], err_msg=f"{name} after tick {t - 1}")


def test_pipelined_run_equals_unpipelined_under_faults():
    model = RaftModel(**MODEL_KW)
    sim = harness.make_sim_config(model, dict(OPTS,
                                              fault_fuzz=FOUR_LANE_DIST))
    res = pipeline.run_sim_pipelined(model, sim, 7, "cpu", chunk=50,
                                     event_cap=512)
    carry, ys = runtime.run_sim(model, sim, 7, "cpu")
    assert res.perf["chunks"] == 4 and res.perf["overflowed-chunks"] == 0
    a, b = _port_leaves(res.carry), _port_leaves(carry)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    dense = ys.events.numpy()
    dense[..., -1] = 0                # the msg-id lane is not carried
    dense[dense[..., 0] == 0] = 0     # nor the lanes of empty events
    np.testing.assert_array_equal(
        pipeline.expand_compact_events(model, sim, res.compact), dense)


def _histories(run_dir, n):
    out = []
    for i in range(n):
        with open(os.path.join(run_dir, f"history-{i}.jsonl")) as f:
            out.append(f.read())
    return out


def test_harness_under_fuzz_matches_jax(tmp_path):
    """``run_torch_test`` under the active four-lane distribution
    (pipelined) gives the JAX harness's histories, verdicts and
    counters, and reports the lanes and the fleet coverage."""
    opts = dict(OPTS, fault_fuzz=FOUR_LANE_DIST, check_workers=0,
                pipeline="on", chunk_ticks=50, heartbeat=False,
                device_profile="off", aot_store="off")
    jres = run_tpu_test(JRaftModel(**MODEL_KW),
                        dict(opts, store_root=str(tmp_path / "j")))
    tres = harness.run_torch_test(RaftModel(**MODEL_KW),
                                  dict(opts, store_root=str(tmp_path / "t")),
                                  device="cpu")
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
                                       "clock-skew", "membership"]
    assert tres["fault-fuzz"]["instances"] == OPTS["n_instances"]


def test_reconstructed_key_chain_is_init_carry_s():
    """The schedule key of instance i is fold_in(fold_in(PRNGKey(seed),
    6), i): the carry's schedule equals the per-instance re-draws."""
    model = RaftModel(**MODEL_KW)
    sim = harness.make_sim_config(model, dict(OPTS,
                                              fault_fuzz=FOUR_LANE_DIST))
    carry = runtime.init_carry(model, sim, 5, "cpu")
    keys = rng.fold_in(rng.fold_in(rng.prng_key(5), runtime._RNG_FAULTS)
                       [None], torch.arange(sim.n_instances))
    again = fuzz.draw_schedule(keys, sim.faults, 3)
    for f in again._fields:
        assert torch.equal(getattr(carry.fault_sched, f),
                           getattr(again, f)), f
    one = fuzz.reconstruct_schedule(sim.faults, 3, 5, 9)
    for f in one._fields:
        np.testing.assert_array_equal(getattr(carry.fault_sched, f)[9]
                                      .numpy(), getattr(one, f))
