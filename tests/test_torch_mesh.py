"""The port's instance sharding (``maelstrom_tpu_torch/parallel/``)
against the live JAX mesh executor on the virtual 8-device CPU mesh.

The same options and seed go to JAX's ``run_sim_sharded`` /
``run_sim_sharded_chunked`` on ``make_mesh(S)`` and to the port's on a
mesh of S CPU shards; everything they return is compared bit for bit:
NetStats, per-instance violations, dense events, the merged telemetry,
the device verdict lanes, the heartbeat (less wall clocks) and the
fail-fast stop. Also: the id layout (``shard_instance_ids``,
``interleave``/``deinterleave``), the wire carry's leaf kinds and
template for every registered model, ``combine_shard_scans``, the
degenerate hybrid mesh, the refusals, and a run under
``torch.set_default_device("meta")``, where a tensor made without an
explicit device fails. Sizes: 2-16 instances per shard, at most 200
ticks. Tolerance: exact."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from maelstrom_tpu.models import get_model as jget_model
from maelstrom_tpu.models.raft import RaftModel as JRaftModel
from maelstrom_tpu.parallel import mesh as jmesh
from maelstrom_tpu.parallel import multihost as jmultihost
from maelstrom_tpu.telemetry import stream as jstream
from maelstrom_tpu.tpu.harness import make_sim_config as jmake_sim_config
from maelstrom_tpu_torch import convert, harness
from maelstrom_tpu_torch.models import MUTANTS, WORKLOADS, get_model
from maelstrom_tpu_torch.models.raft import RaftModel
from maelstrom_tpu_torch.parallel import mesh, multihost
from maelstrom_tpu_torch.telemetry import stream
from maelstrom_tpu_torch.telemetry.profiler import DeviceProfiler

from test_campaign import BUGGY_OPTS, ECHO_OPTS
from test_torch_fuzz import FOUR_LANE_DIST
from torch_tutorial_cases import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")

# lin-kv Raft at the flagship's widths, 4 instances a shard, partitions
# every 40 ticks (the tests cut the 160 ticks further)
RAFT_OPTS = dict(node_count=3, concurrency=6, n_instances=4,
                 record_instances=2, time_limit=0.16, rate=200.0,
                 latency=5.0, rpc_timeout=0.4, nemesis=["partition"],
                 nemesis_interval=0.04, p_loss=0.05, recovery_time=0.02,
                 seed=9, telemetry=True, inbox_k=1, pool_slots=16)
RAFT_KW = dict(n_nodes_hint=3, log_cap=64, heartbeat=8)


def cpu_mesh(n):
    return mesh.make_mesh(devices=[CPU] * n)


def _models(name):
    if name == "raft":
        return JRaftModel(**RAFT_KW), RaftModel(**RAFT_KW)
    if name == "double-vote":
        return (jget_model("lin-kv-bug-double-vote", 3),
                get_model("lin-kv-bug-double-vote", 3))
    return jget_model(name, 2), get_model(name, 2)


def _sims(jm, tm, opts):
    return jmake_sim_config(jm, opts), harness.make_sim_config(tm, opts)


def _same_tel(j, t):
    assert (j is None) == (t is None)
    if j is None:
        return
    assert list(j._fields) == list(t._fields)
    for f, a, b in zip(j._fields, j, t):
        assert np.array_equal(np.asarray(a), np.asarray(b)), f


def _same_outputs(j, t):
    assert tuple(int(x) for x in j[0]) == tuple(int(x) for x in t[0])
    assert np.array_equal(np.asarray(j[1]), t[1])
    assert np.asarray(j[2]).shape == t[2].shape
    assert np.array_equal(np.asarray(j[2]), t[2])


# --- the id layout ----------------------------------------------------------


@pytest.mark.parametrize("S", [1, 2, 4, 8])
@pytest.mark.parametrize("I", [1, 3, 16])
def test_id_layout_matches_jax(S, I):
    got = mesh.shard_instance_ids(I, S)
    assert got.dtype == np.int32
    assert np.array_equal(got, jmesh.shard_instance_ids(I, S))
    x = np.random.RandomState(S * 31 + I).randint(
        0, 1000, size=(5, I * S, 3)).astype(np.int32)
    for axis in (0, 1):
        a = np.moveaxis(x, 1, axis)
        assert np.array_equal(mesh.deinterleave(a, S, axis),
                              jmesh.deinterleave(a, S, axis))
        assert np.array_equal(mesh.interleave(a, S, axis),
                              jmesh.interleave(a, S, axis))
        assert np.array_equal(
            mesh.interleave(mesh.deinterleave(a, S, axis), S, axis), a)
    assert mesh._seed32(2**31 + 5) == jmesh._seed32(2**31 + 5)


# --- the wire carry ---------------------------------------------------------


@pytest.mark.parametrize("name", WORKLOADS + MUTANTS)
def test_wire_kinds_and_template_match_jax(name):
    jm, tm = jget_model(name, 3), get_model(name, 3)
    opts = dict(node_count=3, concurrency=3, n_instances=2,
                record_instances=1, time_limit=0.05, latency=5.0)
    jsim, tsim = _sims(jm, tm, opts)
    assert mesh.wire_leaf_kinds(tm, tsim) == jmesh.wire_leaf_kinds(jm, jsim)
    for S in (1, 2, 4):
        want = jax.tree.leaves(jmesh.wire_template(jm, jsim,
                                                   jmesh.make_mesh(S)))
        got = [a for _, a in convert.carry_leaves(
            mesh.wire_template(tm, tsim, cpu_mesh(S)))]
        assert [(tuple(a.shape), np.dtype(a.dtype)) for a in want] == \
            [(a.shape, a.dtype) for a in got]


# --- the one-shot runners ---------------------------------------------------


@pytest.mark.parametrize("name,S", [("echo", 2), ("echo", 4), ("raft", 2),
                                    ("raft", 4)])
def test_run_sim_sharded_matches_jax(name, S):
    jm, tm = _models(name)
    opts = (dict(ECHO_OPTS, n_instances=3, time_limit=0.1, telemetry=True)
            if name == "echo" else dict(RAFT_OPTS, n_instances=2,
                                        time_limit=0.08))
    jsim, tsim = _sims(jm, tm, opts)
    want = jmesh.run_sim_sharded(jm, jsim, 9, mesh=jmesh.make_mesh(S),
                                 return_telemetry=True)
    got = mesh.run_sim_sharded(tm, tsim, 9, mesh=cpu_mesh(S),
                               return_telemetry=True)
    oracle = mesh.run_sim_unsharded(tm, tsim, 9, S, device="cpu",
                                    return_telemetry=True)
    for out in (got, oracle):
        _same_outputs(want, out)
        _same_tel(want[3], out[3])
    assert want[2].shape[1] == opts["record_instances"] * S
    assert int(got[0].delivered) > 0


# --- the chunked executor ---------------------------------------------------


def _records(run_dir):
    with open(os.path.join(run_dir, "heartbeat.jsonl")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return [{k: v for k, v in r.items() if k != "wall-s"} for r in recs]


def _chunked_pair(tmp_path, name, opts, S, **kw):
    """JAX's and the port's chunked runs on the same options, each with a
    heartbeat in a directory of its own; their outputs, perf and
    heartbeat records."""
    jm, tm = _models(name)
    jsim, tsim = _sims(jm, tm, opts)
    out = []
    for pkg, m, sim, run, msh, hbw in (
            ("jax", jm, jsim, jmesh.run_sim_sharded_chunked,
             jmesh.make_mesh(S), jstream.HeartbeatWriter),
            ("torch", tm, tsim, mesh.run_sim_sharded_chunked, cpu_mesh(S),
             stream.HeartbeatWriter)):
        d = str(tmp_path / pkg)
        os.makedirs(d, exist_ok=True)
        hb = hbw(d, meta={"workload": m.name})
        perf = {}
        res = run(m, sim, opts["seed"], mesh=msh, heartbeat=hb, perf=perf,
                  **kw)
        hb.finish(status="stopped" if perf.get("stopped-early")
                  else "complete")
        out.append((res, perf, _records(d)))
    return out


@pytest.mark.parametrize("S", [1, 2, 4])
def test_chunked_matches_jax(tmp_path, S):
    """Telemetry, the verdict lanes (``both`` mode), a four-lane fuzz
    distribution and the heartbeat with its ``fault-fuzz`` and ``check``
    lanes: the port's chunked executor equals JAX's."""
    opts = dict(RAFT_OPTS, n_instances=8 // S, time_limit=0.12,
                check_mode="both", fault_fuzz=FOUR_LANE_DIST)
    (j, jperf, jrec), (t, tperf, trec) = _chunked_pair(
        tmp_path, "raft", opts, S, chunk=40, return_telemetry=True,
        return_check_summary=True, check_mode="both", scan_k=4)
    _same_outputs(j, t)
    _same_tel(j[3], t[3])
    assert j[4] is not None and np.array_equal(np.asarray(j[4]), t[4])
    assert trec == jrec
    assert [r["check"]["of"] for r in trec if r["type"] == "chunk"] == \
        [8] * 3
    assert any(r["fault-fuzz"]["schedules-active"] for r in trec
               if r["type"] == "chunk")
    assert tperf["ticks-dispatched"] == jperf["ticks-dispatched"] == 120
    assert tperf["shards"] == S and len(tperf["shard-issue-s"]) == S


def test_fail_fast_stop_matches_jax(tmp_path):
    """A planted-bug mutant under fail-fast: the same stop tick, outputs
    and heartbeat (the trippers named by global id) as JAX's."""
    opts = dict(BUGGY_OPTS, n_instances=8)
    (j, jperf, jrec), (t, tperf, trec) = _chunked_pair(
        tmp_path, "double-vote", opts, 2, chunk=50, fail_fast=True,
        return_telemetry=True)
    assert tperf.get("stopped-early") and jperf.get("stopped-early")
    assert tperf["ticks-dispatched"] == jperf["ticks-dispatched"] < 300
    _same_outputs(j, t)
    _same_tel(j[3], t[3])
    assert trec == jrec
    assert stream.first_violation_of(stream.read_heartbeat(
        str(tmp_path / "torch"))) is not None


def test_chunked_equals_one_shot_and_unsharded():
    """The chunk loop (with a checkpoint cut) changes no result: the
    chunked executor equals the one-shot runner and the unsharded
    oracle."""
    tm = RaftModel(**RAFT_KW)
    sim = harness.make_sim_config(tm, dict(RAFT_OPTS, time_limit=0.08))
    cuts = []
    chunked = mesh.run_sim_sharded_chunked(
        tm, sim, 9, mesh=cpu_mesh(2), chunk=20, return_telemetry=True,
        checkpoint_every=2,
        checkpoint_cb=lambda wire, ticks, host: cuts.append(ticks))
    assert cuts == [40]
    one_shot = mesh.run_sim_sharded(tm, sim, 9, mesh=cpu_mesh(2),
                                    return_telemetry=True)
    oracle = mesh.run_sim_unsharded(tm, sim, 9, 2, device="cpu",
                                    return_telemetry=True)
    for out in (one_shot, oracle):
        _same_outputs(chunked, out)
        _same_tel(chunked[3], out[3])


def test_no_tensor_without_a_device():
    """Under ``torch.set_default_device("meta")`` a tensor made without an
    explicit device is a meta tensor, and any op mixing it with the
    shards' CPU tensors raises: the sharded executor (init, ticks, scans,
    copies, the merge) still equals its run under the CPU default."""
    tm = RaftModel(**RAFT_KW)
    sim = harness.make_sim_config(tm, dict(RAFT_OPTS, time_limit=0.08,
                                           check_mode="both"))
    kw = dict(mesh=cpu_mesh(2), chunk=40, return_telemetry=True,
              return_check_summary=True)
    want = mesh.run_sim_sharded_chunked(tm, sim, 9, **kw)
    torch.set_default_device("meta")
    try:
        with pytest.raises(RuntimeError):
            torch.arange(3) + torch.zeros(3, device=CPU)
        got = mesh.run_sim_sharded_chunked(tm, sim, 9, **kw)
    finally:
        torch.set_default_device(None)
    _same_outputs(want, got)
    _same_tel(want[3], got[3])
    assert np.array_equal(want[4], got[4])


# --- the scan merge, the hybrid mesh, the refusals ---------------------------


def test_combine_shard_scans_globalizes_instances():
    I = 8
    cases = [np.array([[0, -1, -1], [2, 90, 3], [1, 82, 5], [0, -1, -1]],
                      np.int32),
             np.array([[0, -1, -1], [1, -1, 6], [2, -1, 1]], np.int32),
             np.zeros((3, 3), np.int32)]
    want_rows = [[3, 82, 2 * I + 5], [3, -1, 1 * I + 6], [0, -1, -1]]
    for scans, want in zip(cases, want_rows):
        out = stream.combine_shard_scans(scans, I)
        assert out.shape == (1, 3) and out[0].tolist() == want
        assert np.array_equal(out, jstream.combine_shard_scans(scans, I))


def test_combine_shard_scans_top_k_merge():
    I = 8
    scans = np.array([[[0, -1, -1], [0, -1, -1]],
                      [[2, 90, 3], [2, 95, 0]],
                      [[1, 82, 5], [2, -1, -1]]], np.int32)
    for k in (None, 1, 4):
        out = stream.combine_shard_scans(scans, I, k=k)
        assert np.array_equal(out, jstream.combine_shard_scans(scans, I,
                                                               k=k))
    out4 = stream.combine_shard_scans(scans, I, k=4)
    assert out4.tolist() == [[3, 82, 21], [3, 90, 11], [3, 95, 8],
                             [3, -1, -1]]
    # global ids as given (the executor's convention), random blocks
    rs = np.random.RandomState(3)
    for _ in range(20):
        sc = rs.randint(-1, 50, size=(4, 3, 3)).astype(np.int32)
        assert np.array_equal(stream.combine_shard_scans(sc, None, k=5),
                              jstream.combine_shard_scans(sc, None, k=5))


def test_hybrid_mesh_single_process_degenerate(monkeypatch):
    """``make_hybrid_mesh`` in its one-process form: a ``(1, n)`` mesh
    named ``("dcn", "ici")`` whose run equals JAX's on its ``(1, 8)``
    hybrid mesh; ``init`` does nothing for one process and raises when
    several are asked for without a coordinator address."""
    m = multihost.make_hybrid_mesh(devices=[CPU] * 8)
    jm_ = jmultihost.make_hybrid_mesh()
    assert m.shape == jm_.devices.shape == (1, 8)
    assert m.axis_names == tuple(jm_.axis_names) == (
        multihost.DCN_AXIS, multihost.ICI_AXIS)
    jmod, tmod = _models("echo")
    opts = dict(ECHO_OPTS, n_instances=2, record_instances=1,
                time_limit=0.05)
    jsim, tsim = _sims(jmod, tmod, opts)
    want = jmesh.run_sim_sharded(jmod, jsim, 4, mesh=jm_)
    got = mesh.run_sim_sharded(tmod, tsim, 4, mesh=m)
    _same_outputs(want, got)
    assert got[1].shape == (16,) and got[2].shape[1] == 8
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    multihost.init()
    assert multihost.process_count() == 1
    with pytest.raises(ValueError, match="coordinator address"):
        multihost.init(num_processes=2)


def test_refusals(monkeypatch, tmp_path):
    """``journal_instances`` is refused as JAX refuses it, and
    ``make_mesh()`` without a card unless CPU devices are passed; the
    device profiler and the kernel-library store (``aot_store``), both
    ported since, are taken: the store populates its entry for the
    shards' dispatch (no library on the CPU) and the outputs are those
    of the run without it."""
    jm, tm = _models("raft")
    opts = dict(RAFT_OPTS, journal_instances=1, time_limit=0.05)
    jsim, tsim = _sims(jm, tm, opts)
    with pytest.raises(AssertionError, match="journal_instances"):
        jmesh.run_sim_sharded(jm, jsim, 9, mesh=jmesh.make_mesh(2))
    for run in (mesh.run_sim_sharded, mesh.run_sim_sharded_chunked):
        with pytest.raises(ValueError, match="journal_instances"):
            run(tm, tsim, 9, mesh=cpu_mesh(2))
    tsim = harness.make_sim_config(tm, dict(opts, journal_instances=0))
    monkeypatch.delenv("MAELSTROM_AOT", raising=False)
    store = str(tmp_path / "store")
    perf = {}
    got = mesh.run_sim_sharded_chunked(tm, tsim, 9, mesh=cpu_mesh(2),
                                       perf=perf,
                                       profiler=DeviceProfiler("on"),
                                       aot_store=store)
    assert perf["device"]["captured-chunks"] == perf["chunks"]
    assert set(perf["aot"]["lengths"].values()) == {"populated"}
    from maelstrom_tpu_torch.aot_store import AotStore
    assert [m["libraries"] for _, m in AotStore(store).entries()] == [[]]
    want = mesh.run_sim_sharded_chunked(tm, tsim, 9, mesh=cpu_mesh(2))
    assert got[0] == want[0] and np.array_equal(got[1], want[1])
    monkeypatch.setenv("MAELSTROM_AOT", "0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.run_sim_sharded(tm, tsim, 9)
    with pytest.raises(ValueError, match="3-device mesh"):
        mesh.make_mesh(3, devices=[CPU] * 2)
    assert mesh.make_mesh(2, devices=[CPU] * 4).size == 2


@pytest.mark.cuda
def test_shards_on_card_equal_cpu_and_count_launches_by_device():
    """On the card: two shards on the first card (or on two cards) equal
    the CPU shards, and the delivery kernel launches once per tick on
    every shard, counted by device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the delivery kernel has "
                    "no CPU or interpret mode")
    from maelstrom_tpu_torch.kernels import delivery
    n = torch.cuda.device_count()
    devs = ([torch.device("cuda", 0), torch.device("cuda", 1)] if n > 1
            else [torch.device("cuda", 0)] * 2)
    tm = RaftModel(**RAFT_KW)
    sim = harness.make_sim_config(tm, dict(RAFT_OPTS, time_limit=0.1))
    want = mesh.run_sim_sharded_chunked(tm, sim, 9, mesh=cpu_mesh(2),
                                        chunk=50, return_telemetry=True)
    delivery.reset_launches()
    got = mesh.run_sim_sharded_chunked(
        tm, sim, 9, mesh=mesh.make_mesh(devices=devs), chunk=50,
        return_telemetry=True)
    by_dev = dict(delivery.deliver.launches_by_device)
    _same_outputs(want, got)
    _same_tel(want[3], got[3])
    expect = {}
    for d in devs:
        expect[str(d)] = expect.get(str(d), 0) + sim.n_ticks
    assert by_dev == expect
