"""Runs over several processes (``maelstrom_tpu_torch/parallel/
multihost.py``) against the live JAX mesh executor.

Two processes are spawned (``multihost.spawn``: the ``spawn`` method, a
gloo group on a free localhost port, one torch thread each) and run the
functions of ``tests/torch_multihost_cases.py``, which import no JAX:

- ``run_sim_sharded`` on the ``(2, 1)`` and ``(2, 2)`` hybrid meshes of
  CPU devices: both ranks return what JAX's ``run_sim_sharded`` returns
  at S = 2 and S = 4 on the virtual 8-device mesh, telemetry included;
- ``run_sim_sharded_chunked`` on the double-vote mutant with fail-fast,
  a heartbeat and a checkpoint after every chunk: both ranks equal JAX's
  chunked run at S = 2 and stop at the same chunk, rank 0's heartbeat
  equals JAX's and rank 1 writes none, rank 0's checkpoints equal the
  one-process S = 2 checkpoints array by array, and its first resumes
  in one process at S = 1 equal to the uninterrupted run;
- ``init`` from the launcher variables, the refusal of rows of unequal
  width on every rank, and a deserted rank: the other raises.

Sizes: 2 and 8 instances a shard, at most 300 ticks. Tolerance: exact.
Each spawn is joined within 60 s or the test fails."""

import json
import os

import numpy as np
import pytest
import torch

from maelstrom_tpu.campaign import checkpoint as jckpt
from maelstrom_tpu.models import get_model as jget_model
from maelstrom_tpu.models.raft import RaftModel as JRaftModel
from maelstrom_tpu.parallel import mesh as jmesh
from maelstrom_tpu.telemetry import stream as jstream
from maelstrom_tpu.tpu.harness import make_sim_config as jmake_sim_config
from maelstrom_tpu_torch import harness
from maelstrom_tpu_torch.campaign import checkpoint as ckpt
from maelstrom_tpu_torch.parallel import mesh, multihost
from maelstrom_tpu_torch.pipeline import ResumeState

import torch_multihost_cases as cases
from torch_tutorial_cases import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
SPAWN = dict(nprocs=2, timeout=60.0, threads=1)


def _same(want, got, telemetry=True):
    assert tuple(int(x) for x in want[0]) == got["stats"]
    assert np.array_equal(np.asarray(want[1]), got["violations"])
    assert np.asarray(want[2]).shape == got["events"].shape
    assert np.array_equal(np.asarray(want[2]), got["events"])
    if telemetry:
        tel = want[3]
        assert (tel is None) == (got["telemetry"] is None)
        assert list(tel._fields) == list(got["telemetry"])
        for f, a in zip(tel._fields, tel):
            assert np.array_equal(np.asarray(a), got["telemetry"][f]), f


def _records(run_dir):
    with open(os.path.join(run_dir, "heartbeat.jsonl")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return [{k: v for k, v in r.items() if k != "wall-s"} for r in recs]


# --- run_sim_sharded on the (2, 1) and (2, 2) hybrid meshes -----------------


@pytest.fixture(scope="module")
def one_shot_ranks():
    return multihost.spawn(cases.one_shot, **SPAWN)


@pytest.fixture(scope="module")
def jax_one_shot():
    jm = JRaftModel(**cases.RAFT_KW)
    jsim = jmake_sim_config(jm, cases.RAFT_OPTS)
    return {S: jmesh.run_sim_sharded(jm, jsim, 9, mesh=jmesh.make_mesh(S),
                                     return_telemetry=True)
            for S in (2, 4)}


def test_init_from_launcher_variables(one_shot_ranks):
    ports = set()
    for rank, r in enumerate(one_shot_ranks):
        assert r["rank"] == rank and r["count"] == 2
        assert r["env"]["WORLD_SIZE"] == "2"
        assert r["env"]["RANK"] == str(rank)
        assert r["env"]["MASTER_ADDR"] == "127.0.0.1"
        assert not r["jax-imported"]
        ports.add(r["env"]["MASTER_PORT"])
    assert len(ports) == 1


@pytest.mark.parametrize("per_host", [1, 2])
def test_hybrid_mesh_rows(one_shot_ranks, per_host):
    for rank, r in enumerate(one_shot_ranks):
        shape, axes, size, local = r[f"mesh-{per_host}"]
        assert shape == (2, per_host) and size == 2 * per_host
        assert axes == (multihost.DCN_AXIS, multihost.ICI_AXIS)
        assert local == list(range(rank * per_host,
                                   (rank + 1) * per_host))


@pytest.mark.parametrize("per_host,S", [(1, 2), (2, 4)])
def test_two_processes_equal_jax_mesh(one_shot_ranks, jax_one_shot,
                                      per_host, S):
    """Both ranks return JAX's global outputs at S shards, and what one
    process returns at S CPU shards."""
    tm = cases.RaftModel(**cases.RAFT_KW)
    tsim = harness.make_sim_config(tm, cases.RAFT_OPTS)
    want = jax_one_shot[S]
    one = mesh.run_sim_sharded(tm, tsim, 9,
                               mesh=mesh.make_mesh(devices=[CPU] * S),
                               return_telemetry=True)
    for r in one_shot_ranks:
        _same(want, r[f"run-{per_host}"])
        _same(one, r[f"run-{per_host}"])
    assert one_shot_ranks[0][f"run-{per_host}"]["events"].shape[1] == \
        cases.RAFT_OPTS["record_instances"] * S
    assert int(want[0].delivered) > 0


def test_unequal_rows_refused_on_every_rank(one_shot_ranks):
    for r in one_shot_ranks:
        assert r["refusal"] is not None
        assert "different numbers of devices [1, 2]" in r["refusal"]


# --- the chunked executor: fail-fast, heartbeat, checkpoint, resume ---------


@pytest.fixture(scope="module")
def chunked_ranks(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("chunked"))
    return multihost.spawn(cases.chunked, (base,), **SPAWN)


@pytest.fixture(scope="module")
def jax_chunked(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jax"))
    jm = jget_model("lin-kv-bug-double-vote", 3)
    jsim = jmake_sim_config(jm, cases.BUGGY_OPTS)
    hb = jstream.HeartbeatWriter(d, meta={"workload": jm.name})
    perf = {}
    # the same cuts: a cut consumes the chunk just issued, so fail-fast
    # sees a trip one chunk sooner than without checkpoints
    out = jmesh.run_sim_sharded_chunked(
        jm, jsim, 7, mesh=jmesh.make_mesh(2), chunk=50, fail_fast=True,
        heartbeat=hb, perf=perf, return_telemetry=True,
        checkpoint_cb=jckpt.make_checkpoint_cb(d, kind="sharded"),
        checkpoint_every=1)
    hb.finish(status="stopped" if perf.get("stopped-early")
              else "complete")
    return out, perf, _records(d)


def test_chunked_equals_jax_and_stops_together(chunked_ranks, jax_chunked):
    want, jperf, _ = jax_chunked
    assert jperf.get("stopped-early")
    for r in chunked_ranks:
        _same(want, r["out"])
    perf = chunked_ranks[0]["perf"]
    assert perf["stopped-early"]
    assert perf["ticks-dispatched"] == jperf["ticks-dispatched"] < 300
    assert perf["chunks"] == jperf["chunks"]
    assert perf["shards"] == 2 and perf["processes"] == 2
    assert len(perf["shard-issue-s"]) == 2
    assert len(perf["process-gather-s"]) == 2
    # rank 0 alone fills perf
    assert chunked_ranks[1]["perf"] == {}


def test_heartbeat_written_by_rank_zero_only(chunked_ranks, jax_chunked):
    _, _, jrec = jax_chunked
    r0, r1 = (_records(r["dir"]) for r in chunked_ranks)
    assert r0 == jrec
    assert [r["type"] for r in r1] == ["run-start", "run-end"]


def test_checkpoints_equal_one_process(chunked_ranks, tmp_path):
    """Rank 0's checkpoints equal, array by array, the ones a one-process
    run at S = 2 writes at the same cuts; rank 1 writes none."""
    tm, tsim = cases.buggy_sim()
    d = str(tmp_path)
    sink = ckpt.make_checkpoint_cb(d, kind="sharded", meta={"run": "mesh"})
    saves = []

    def cb(state, ticks, host):
        sink(state, ticks, host)
        saves.append((ticks, cases._npz(ckpt.checkpoint_path(d))))

    mesh.run_sim_sharded_chunked(
        tm, tsim, 7, mesh=mesh.make_mesh(devices=[CPU] * 2), chunk=50,
        fail_fast=True, checkpoint_cb=cb, checkpoint_every=1)
    got = chunked_ranks[0]["saves"]
    assert chunked_ranks[1]["saves"] == []
    assert [t for t, _ in saves] == [t for t, _, _ in got]
    assert len(saves) >= 2
    for (_, (wa, wh)), (_, _, (ga, gh)) in zip(saves, got):
        assert gh == wh and gh["meta"]["shard"]["n-shards"] == 2
        assert sorted(ga) == sorted(wa)
        for k in wa:
            assert ga[k].dtype == wa[k].dtype, k
            assert np.array_equal(ga[k], wa[k]), k


def test_two_process_checkpoint_resumes_in_one(chunked_ranks):
    """Rank 0's first checkpoint resumes in one process at S = 1 (16
    instances, 8 recorded: the same global ids) equal to the two-process
    run."""
    ticks, keep, _ = chunked_ranks[0]["saves"][0]
    ck = ckpt.load_checkpoint(keep)
    assert ck["ticks"] == ticks and ck["meta"]["shard"]["n-shards"] == 2
    tm = cases.get_model("lin-kv-bug-double-vote", 3)
    tsim = harness.make_sim_config(tm, dict(cases.BUGGY_OPTS,
                                            n_instances=16,
                                            record_instances=8))
    msh = mesh.make_mesh(devices=[CPU])
    resume = ResumeState(
        carry=ckpt.restore_carry(mesh.wire_template(tm, tsim, msh),
                                 ck["carry"], shard=ck["meta"]["shard"]),
        ticks=ck["ticks"], chunks=ck["chunks"], events=tuple(ck["events"]))
    perf = {}
    # the resumed run keeps the cuts, so fail-fast stops at the same chunk
    got = mesh.run_sim_sharded_chunked(
        tm, tsim, 7, mesh=msh, chunk=50, fail_fast=True, resume=resume,
        perf=perf, return_telemetry=True,
        checkpoint_cb=lambda wire, ticks, host: None, checkpoint_every=1)
    want = chunked_ranks[0]["out"]
    assert perf["resumed-from-ticks"] == ticks
    assert perf["ticks-dispatched"] == \
        chunked_ranks[0]["perf"]["ticks-dispatched"]
    assert tuple(int(x) for x in got[0]) == want["stats"]
    assert np.array_equal(got[1], want["violations"])
    assert np.array_equal(got[2], want["events"])
    for f, a in zip(got[3]._fields, got[3]):
        assert np.array_equal(np.asarray(a), want["telemetry"][f]), f


# --- a deserted rank ----------------------------------------------------------


def test_deserted_rank_raises_on_the_other():
    """Rank 1 leaves without joining the chunk exchange: rank 0 raises in
    the collective (the peer is gone or the group's timeout runs out)
    instead of returning a one-process result, and ``spawn`` raises
    naming it."""
    with pytest.raises(RuntimeError, match="rank 0 raised"):
        multihost.spawn(cases.deserted, nprocs=2, timeout=60.0, threads=1,
                        group_timeout=10.0)
