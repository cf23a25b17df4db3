"""The batch-minor carry layout of the port against the JAX package.

A ``layout="minor"`` run of the port keeps the instance axis last on the
pool ``[S, L, I]``, the node and client state, the snapshot slab and the
fuzzed schedules, each contiguous between ticks. These tests mirror
``tests/test_layouts.py``: three nemesis kinds, ``inbox_k`` 3, replayed
instance ids, the canonical round trip, ``auto`` on the CPU and the
sharded chunked minor run. Each holds the port's minor run against the
live JAX minor run (its batch-last leaves as they lie, the canonical
carry and the events, bit for bit) and against the port's own lead run.
Tolerance 0 throughout: the state is int32 and the draws bit-defined.
"""

import jax
import numpy as np
import pytest
import torch

from maelstrom_tpu.models.raft import RaftModel as JRaftModel
from maelstrom_tpu.tpu import harness as jharness
from maelstrom_tpu.tpu import runtime as jruntime
from maelstrom_tpu_torch import convert, harness, netsim, runtime
from maelstrom_tpu_torch.kernels import delivery, delivery_cases
from maelstrom_tpu_torch.models.raft import RaftModel
from maelstrom_tpu_torch.tree import tree_leaves

from torch_tutorial_cases import one_torch_thread  # noqa: F401 (autouse)

# tests/test_layouts.py's BASE_OPTS (64 instances, 120 ticks): its
# cases' sims, so the JAX runs compile what that file compiles (the
# suite's persistent compilation cache)
BASE_OPTS = dict(node_count=3, concurrency=6, n_instances=64,
                 record_instances=4, inbox_k=1, pool_slots=16,
                 time_limit=0.12, rate=200.0, latency=5.0,
                 rpc_timeout=1.0, nemesis=["partition"],
                 nemesis_interval=0.04, p_loss=0.05, recovery_time=0.0,
                 seed=7)
MODEL_KW = dict(log_cap=64, heartbeat=8)


def _leaves(carry):
    return dict(convert.carry_leaves(carry))


def _jax_run(opts, ids=None):
    """The live JAX run in ``opts["layout"]``: ``(carry as it lies,
    canonical carry, events)``, numpy leaves."""
    jm = JRaftModel(n_nodes_hint=opts["node_count"], **MODEL_KW)
    sim = jharness.make_sim_config(jm, opts)
    jids = None if ids is None else jax.numpy.asarray(ids, np.int32)
    carry, ys = jruntime.run_sim(jm, sim, opts["seed"],
                                 jm.make_params(sim.net.n_nodes), jids)
    as_np = lambda c: _leaves(jax.tree.map(np.asarray, c))
    return (as_np(carry), as_np(jruntime.canonical_carry(carry, sim)),
            np.asarray(ys.events))


def _port_run(opts, ids=None):
    """The port's run on the CPU: ``(sim, carry as it lies, canonical
    carry, events)``."""
    model = RaftModel(n_nodes_hint=opts["node_count"], **MODEL_KW)
    sim = harness.make_sim_config(model, opts)
    tids = None if ids is None else torch.tensor(ids, dtype=torch.int32)
    carry, ys = runtime.run_sim(model, sim, opts["seed"], "cpu", tids)
    return (sim, carry,
            _leaves(convert.carry_to_numpy(runtime.canonical_carry(carry,
                                                                   sim))),
            ys.events.numpy())


def _assert_equal(ref, got, what):
    assert set(ref) == set(got), (what, set(ref) ^ set(got))
    for name, x in ref.items():
        np.testing.assert_array_equal(np.asarray(x).astype(np.int64),
                                      got[name].astype(np.int64),
                                      err_msg=f"{what}: {name}")


def _assert_batch_last(sim, carry):
    """Every leaf JAX keeps batch-last lies batch-last and contiguous;
    the violations lead."""
    I = sim.n_instances
    assert tuple(carry.pool.shape) == (sim.net.pool_slots, sim.net.lanes, I)
    for tree in (carry.pool, carry.node_state, carry.client_state,
                 carry.snapshots, carry.fault_sched):
        for x in tree_leaves(tree):
            assert x.shape[-1] == I and x.is_contiguous()
    assert tuple(carry.violations.shape) == (I,)


def _check_minor(opts, ids=None):
    """The port's minor run equals the live JAX minor run (batch-last
    leaves as they lie, the canonical carry, the events) and the port's
    lead run (canonical carry, events)."""
    opts_m = dict(opts, layout="minor")
    sim, carry, canon, events = _port_run(opts_m, ids)
    assert sim.layout == "minor"
    _assert_batch_last(sim, carry)
    j_raw, j_canon, j_events = _jax_run(opts_m, ids)
    _assert_equal(j_raw, _leaves(convert.carry_to_numpy(carry)),
                  "minor leaves vs JAX minor")
    _assert_equal(j_canon, canon, "canonical vs JAX minor")
    np.testing.assert_array_equal(j_events, events)
    _, _, lead, lead_events = _port_run(dict(opts, layout="lead"), ids)
    _assert_equal(lead, canon, "minor vs the port's lead")
    np.testing.assert_array_equal(lead_events, events)
    return canon


@pytest.mark.parametrize("kind", ["random-halves", "isolated-node",
                                  "majorities-ring"])
def test_minor_layout_matches_jax_and_lead(kind):
    canon = _check_minor(dict(BASE_OPTS, nemesis_kind=kind))
    # the run exercises traffic
    assert int(canon["carry.stats.delivered"]) > 100


def test_minor_layout_inbox_k3():
    # K > 1: the sorted selection of the delivery round
    _check_minor(dict(BASE_OPTS, inbox_k=3, pool_slots=24))


def test_minor_layout_replay_instance_ids():
    # the funnel replays any subset of ids: every draw follows the id
    ids = [3, 17, 42, 63]
    _check_minor(dict(BASE_OPTS, n_instances=len(ids),
                      record_instances=len(ids)), ids)


def test_canonical_roundtrip():
    model = RaftModel(n_nodes_hint=3, **MODEL_KW)
    sim = harness.make_sim_config(model, dict(BASE_OPTS, layout="minor",
                                              n_instances=8,
                                              time_limit=0.03))
    carry, _ = runtime.run_sim(model, sim, 7, "cpu")
    canon = runtime.canonical_carry(carry, sim)
    assert canon.pool.shape[0] == sim.n_instances
    assert carry.pool.shape[-1] == sim.n_instances
    back = runtime.carry_from_canonical(canon, sim)
    _assert_equal(_leaves(convert.carry_to_numpy(carry)),
                  _leaves(convert.carry_to_numpy(back)), "round trip")
    _assert_batch_last(sim, back)
    # the lead layout's canonical carry is the carry itself
    lead = sim._replace(layout="lead")
    assert runtime.canonical_carry(canon, lead) is canon


def test_resolve_layout_auto():
    # on the CPU, auto is the lead layout; on a card, minor (JAX's rule)
    assert harness.resolve_layout("auto", "cpu") == "lead"
    assert harness.resolve_layout("auto", "cuda") == "minor"
    assert harness.resolve_layout("auto", "cuda:0") == "minor"
    assert harness.resolve_layout("auto") == (
        "minor" if torch.cuda.is_available() else "lead")
    assert harness.resolve_layout(" minor ") == "minor"
    assert harness.resolve_layout("lead", "cuda") == "lead"
    assert harness.TORCH_DEFAULTS["layout"] == jharness.TPU_DEFAULTS[
        "layout"] == "auto"
    model = RaftModel(n_nodes_hint=3, **MODEL_KW)
    for dev, want in (("cpu", "lead"), ("cuda", "minor")):
        sim = harness.make_sim_config(model, dict(BASE_OPTS, device=dev))
        assert sim.layout == want
    with pytest.raises(ValueError) as got:
        harness.make_sim_config(model, dict(BASE_OPTS, layout="sideways"))
    with pytest.raises(ValueError) as ref:
        jharness.resolve_layout("sideways")
    assert str(got.value) == str(ref.value)


def test_sharded_chunked_minor_matches_unsharded():
    from maelstrom_tpu_torch.parallel import mesh
    model = RaftModel(n_nodes_hint=3, **MODEL_KW)
    # two shards, 40 ticks (cut from four and 120) in 20-tick chunks: the
    # wire crosses a chunk boundary
    sim = harness.make_sim_config(model, dict(
        BASE_OPTS, n_instances=8, record_instances=2, layout="minor",
        time_limit=0.04))
    assert sim.layout == "minor"
    got = mesh.run_sim_sharded_chunked(
        model, sim, 7, mesh=mesh.make_mesh(devices=["cpu"] * 2), chunk=20)
    ref = mesh.run_sim_unsharded(model, sim, 7, n_shards=2, device="cpu")
    assert tuple(int(x) for x in got[0]) == tuple(int(x) for x in ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[2], ref[2])


@pytest.mark.parametrize("name", ["flagship", "odd", "broadcast-25",
                                  "flagship-netid", "ragged", "unstaged"])
def test_deliver_minor_reference_equals_lead(name):
    """The plain version of the batch-last entry equals the lead plain
    version on the transposed pool, on every edge-case pool; pool' is
    batch-last and contiguous. "ragged" (37 instances) is a multiple of
    neither the kernel's tile nor 4, "unstaged" (256 slots of L = 228) a
    shape only the batch-last kernel takes."""
    shape = {**delivery_cases.EDGE_SHAPES,
             **delivery_cases.MINOR_EDGE_SHAPES}[name]
    cfg = delivery_cases.net_config(*shape[:5])
    for pname, (pools, parts, t) in delivery_cases.edge_pools(
            cfg, shape[5], 11).items():
        pool = torch.from_numpy(pools)
        part = torch.from_numpy(parts)
        ref = netsim.deliver_reference(pool, part, t, cfg)
        minor = pool.movedim(0, -1).contiguous()
        got = delivery.deliver_minor(minor, part, t, cfg)
        assert got[0].is_contiguous()
        torch.testing.assert_close(got[0].movedim(-1, 0), ref[0],
                                   rtol=0, atol=0, msg=pname)
        for a, b in zip(got[1:], ref[1:]):
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=pname)


def test_enqueue_minor_equals_lead():
    cfg = delivery_cases.net_config(3, 6, 16, 1, 12)
    rs = np.random.RandomState(5)
    pools, _ = delivery_cases.random_pools(rs, 32, cfg)
    pool = torch.from_numpy(pools)
    msgs = torch.from_numpy(delivery_cases.random_pools(
        rs, 32, cfg._replace(pool_slots=24))[0])
    key = torch.from_numpy(rs.randint(0, 2**32, (32, 2), dtype=np.int64))
    delay = torch.from_numpy(rs.randint(0, 3, (32, 9, 9)).astype(np.int32))
    loss = torch.from_numpy(rs.randint(0, 300, (32, 9, 9)).astype(np.int32))
    for kw in ({}, dict(edge_delay=delay, edge_loss_pm=loss)):
        ref = netsim.enqueue(pool, msgs, 40, key, cfg, **kw)
        got = netsim.enqueue(pool.movedim(0, -1).contiguous(), msgs, 40,
                             key, cfg, minor=True, **kw)
        assert got[0].is_contiguous()
        torch.testing.assert_close(got[0].movedim(-1, 0), ref[0], rtol=0,
                                   atol=0)
        for a, b in zip(got[1:], ref[1:]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_minor_tick_runs_the_minor_entry():
    """The minor tick delivers through the batch-last entry (its plain
    version on the CPU; the launch counters stay for the card), and a
    CUDA request without a card raises instead of falling back."""
    model = RaftModel(n_nodes_hint=3, **MODEL_KW)
    sim = harness.make_sim_config(model, dict(BASE_OPTS, layout="minor",
                                              n_instances=4,
                                              time_limit=0.005))
    calls = []
    real = delivery.deliver_minor

    def spy(*a, **kw):
        calls.append(tuple(a[0].shape))
        return real(*a, **kw)

    delivery.deliver_minor = spy
    try:
        runtime.run_sim(model, sim, 7, "cpu")
    finally:
        delivery.deliver_minor = real
    assert calls == [(16, sim.net.lanes, 4)] * sim.n_ticks
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            harness.run_torch_test(model, dict(BASE_OPTS, layout="minor"))
