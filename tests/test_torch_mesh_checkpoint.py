"""Sharded checkpoints of the port against the JAX package's.

- **The file format.** At the same cuts (every chunk, S=2) the port's
  ``state.npz`` equals JAX's array by array: the wire carry, the dense
  ``events/NNNN`` blocks and the header with ``meta.shard``.
- **Cross-mesh resume, both ways.** A JAX checkpoint written at S=4
  resumes in the port at S=2 and S=1 (``restore_carry`` reshards it)
  equal to JAX's uninterrupted run at the new S; a port checkpoint
  written at S=2 resumes in JAX at S=4, and in the port at S=4, equal
  to the uninterrupted runs.
- **``reshard_carry``** equals JAX's on random leaves of every kind, and
  refuses what JAX refuses in JAX's words; so do ``restore_carry``'s
  refusals (``tests/test_campaign.py:351-377``).

Sizes: the JAX campaign tests' ``ECHO_OPTS`` (8 global instances, 120
ticks in 40-tick chunks) and the mesh tests' Raft options. The sweep
over every pair of shard counts is ``slow``. Tolerance: exact."""

import json

import jax
import numpy as np
import pytest
import torch

from maelstrom_tpu.campaign import checkpoint as jckpt
from maelstrom_tpu.models import get_model as jget_model
from maelstrom_tpu.models.raft import RaftModel as JRaftModel
from maelstrom_tpu.parallel import mesh as jmesh
from maelstrom_tpu.tpu.harness import make_sim_config as jmake_sim_config
from maelstrom_tpu.tpu.pipeline import ResumeState as JResumeState
from maelstrom_tpu_torch import harness
from maelstrom_tpu_torch.campaign import checkpoint as ckpt
from maelstrom_tpu_torch.models import get_model
from maelstrom_tpu_torch.models.raft import RaftModel
from maelstrom_tpu_torch.parallel import mesh
from maelstrom_tpu_torch.pipeline import ResumeState

from test_campaign import ECHO_OPTS, Killed
from test_torch_mesh import RAFT_KW, RAFT_OPTS, cpu_mesh
from torch_tutorial_cases import one_torch_thread  # noqa: F401 (autouse)


def echo_sim(pkg, S):
    """The same 8-instance global echo fleet at S shards, all recorded,
    so the recorded set is the same at every shard count, with the
    device verdict lanes."""
    opts = dict(ECHO_OPTS, n_instances=8 // S, record_instances=8 // S,
                time_limit=0.12, check_mode="both")
    if pkg == "jax":
        m = jget_model("echo", 2)
        return m, jmake_sim_config(m, opts)
    m = get_model("echo", 2)
    return m, harness.make_sim_config(m, opts)


def _same(a, b):
    assert tuple(int(x) for x in a[0]) == tuple(int(x) for x in b[0])
    for x, y in zip(a[1:], b[1:]):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def _killed_run(run, model, sim, msh, d, save):
    """``run`` killed right after its first checkpoint (written by
    ``save``, the JAX tests' way of simulating SIGKILL)."""
    def cb(state, ticks, host):
        save(d, kind="sharded", state=state, ticks=ticks,
             chunks=host["chunks"], events=tuple(host["events"]),
             meta={"shard": host["shard"]})
        raise Killed

    with pytest.raises(Killed):
        run(model, sim, 3, mesh=msh, chunk=40, checkpoint_cb=cb,
            checkpoint_every=1, return_check_summary=True)


def _npz(path):
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    header = json.loads(bytes(arrays.pop("__meta__")).decode())
    return arrays, header


def test_sharded_state_npz_matches_jax(tmp_path):
    """Raft with telemetry and the verdict lanes at S=2, a checkpoint
    after every chunk: each ``state.npz`` equals JAX's at the same cut,
    array by array, the header with ``meta.shard`` included."""
    opts = dict(RAFT_OPTS, time_limit=0.12, check_mode="both")
    jm, tm = JRaftModel(**RAFT_KW), RaftModel(**RAFT_KW)
    saves = {}
    for pkg, m, sim, run, msh, mod in (
            ("jax", jm, jmake_sim_config(jm, opts),
             jmesh.run_sim_sharded_chunked, jmesh.make_mesh(2), jckpt),
            ("torch", tm, harness.make_sim_config(tm, opts),
             mesh.run_sim_sharded_chunked, cpu_mesh(2), ckpt)):
        d = str(tmp_path / pkg)
        sink = mod.make_checkpoint_cb(d, kind="sharded",
                                      meta={"run": "mesh"})
        saves[pkg] = []

        def cb(state, ticks, host, sink=sink, d=d, pkg=pkg, mod=mod):
            sink(state, ticks, host)
            saves[pkg].append(_npz(mod.checkpoint_path(d)))

        run(m, sim, 3, mesh=msh, chunk=40, checkpoint_cb=cb,
            checkpoint_every=1)
    assert len(saves["torch"]) == len(saves["jax"]) == 2
    for (ta, th), (ja, jh) in zip(saves["torch"], saves["jax"]):
        assert th == jh
        assert th["n-events"] == th["chunks"] and th["kind"] == "sharded"
        assert th["meta"]["shard"]["n-shards"] == 2
        assert sorted(ta) == sorted(ja)
        assert any(k.startswith("events/") for k in ta)
        for k in ja:
            assert ta[k].dtype == ja[k].dtype, k
            assert np.array_equal(ta[k], ja[k]), k


@pytest.mark.parametrize("new_shards", [2, 1])
def test_jax_checkpoint_resumes_in_port_at_another_shard_count(
        tmp_path, new_shards):
    jm4, jsim4 = echo_sim("jax", 4)
    d = str(tmp_path)
    _killed_run(jmesh.run_sim_sharded_chunked, jm4, jsim4,
                jmesh.make_mesh(4), d, jckpt.save_checkpoint)
    jm, jsim = echo_sim("jax", new_shards)
    want = jmesh.run_sim_sharded_chunked(
        jm, jsim, 3, mesh=jmesh.make_mesh(new_shards), chunk=40,
        return_check_summary=True)
    ck = ckpt.load_checkpoint(d)
    assert ck["meta"]["shard"]["n-shards"] == 4 and ck["kind"] == "sharded"
    tm, tsim = echo_sim("torch", new_shards)
    msh = cpu_mesh(new_shards)
    resume = ResumeState(
        carry=ckpt.restore_carry(mesh.wire_template(tm, tsim, msh),
                                 ck["carry"], shard=ck["meta"]["shard"]),
        ticks=ck["ticks"], chunks=ck["chunks"], events=tuple(ck["events"]))
    perf = {}
    got = mesh.run_sim_sharded_chunked(tm, tsim, 3, mesh=msh, chunk=40,
                                       resume=resume, perf=perf,
                                       return_check_summary=True)
    assert perf["resumed-from-ticks"] == 40 and perf["chunks"] == 2
    _same(want, got)
    assert want[3] is not None


def test_port_checkpoint_resumes_in_jax_and_in_port(tmp_path):
    """Written by the port at S=2; resumed by JAX at S=4 and by the port
    at S=4, both equal to the uninterrupted runs of both packages."""
    tm2, tsim2 = echo_sim("torch", 2)
    d = str(tmp_path)
    _killed_run(mesh.run_sim_sharded_chunked, tm2, tsim2, cpu_mesh(2), d,
                ckpt.save_checkpoint)
    jm, jsim = echo_sim("jax", 4)
    jmsh = jmesh.make_mesh(4)
    want = jmesh.run_sim_sharded_chunked(jm, jsim, 3, mesh=jmsh, chunk=40,
                                         return_check_summary=True)
    ck = jckpt.load_checkpoint(d)
    jres = jmesh.run_sim_sharded_chunked(
        jm, jsim, 3, mesh=jmsh, chunk=40, return_check_summary=True,
        resume=JResumeState(
            carry=jckpt.restore_carry(jmesh.wire_template(jm, jsim, jmsh),
                                      ck["carry"],
                                      shard=ck["meta"]["shard"]),
            ticks=ck["ticks"], chunks=ck["chunks"],
            events=tuple(ck["events"])))
    _same(want, jres)
    tm, tsim = echo_sim("torch", 4)
    msh = cpu_mesh(4)
    ck = ckpt.load_checkpoint(d)
    got = mesh.run_sim_sharded_chunked(
        tm, tsim, 3, mesh=msh, chunk=40, return_check_summary=True,
        resume=ResumeState(
            carry=ckpt.restore_carry(mesh.wire_template(tm, tsim, msh),
                                     ck["carry"],
                                     shard=ck["meta"]["shard"]),
            ticks=ck["ticks"], chunks=ck["chunks"],
            events=tuple(ck["events"])))
    _same(want, got)
    # a restored wire of the wrong shard count is refused by the executor
    tmpl2 = mesh.wire_template(tm2, tsim2, cpu_mesh(2))
    with pytest.raises(ValueError, match="leading axis"):
        mesh.run_sim_sharded_chunked(
            tm, tsim, 3, mesh=msh, chunk=40, resume=ResumeState(
                carry=ckpt.restore_carry(tmpl2, ck["carry"]),
                ticks=ck["ticks"], chunks=ck["chunks"]))


def _random_wire(rs, kinds, S, I):
    leaves = []
    for j, kind in enumerate(kinds):
        lead = S * I if kind == "instance" else S
        shape = (lead,) + tuple(rs.randint(1, 4, size=j % 3))
        if kind == "key":
            leaves.append(np.tile(rs.randint(0, 2**31, size=(1,) + shape[1:])
                                  .astype(np.uint32), (S,) + (1,) *
                                  (len(shape) - 1)))
        elif j % 4 == 3:
            leaves.append(rs.randint(0, 2, size=shape).astype(bool))
        else:
            leaves.append(rs.randint(-2**31, 2**31, size=shape,
                                     dtype=np.int64).astype(np.int32))
    return leaves


@pytest.mark.parametrize("S,new", [(4, 2), (4, 1), (2, 4), (1, 8), (8, 2),
                                   (3, 6)])
def test_reshard_carry_matches_jax(S, new):
    rs = np.random.RandomState(S * 10 + new)
    kinds = ["instance", "sum", "instance", "key", "sum", "instance",
             "instance", "sum"]
    I = 24 // S
    leaves = _random_wire(rs, kinds, S, I)
    shard = {"n-shards": S, "instances-per-shard": I, "interleaved": True,
             "leaf-kinds": kinds}
    got, gmeta = ckpt.reshard_carry(leaves, shard, new)
    want, wmeta = jckpt.reshard_carry(leaves, shard, new)
    assert gmeta == wmeta
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # the fleet totals of the sum slots are kept (int32 wrap)
    for a, b, kind in zip(got, leaves, kinds):
        if kind == "sum":
            assert np.array_equal(a.sum(axis=0, dtype=a.dtype),
                                  b.sum(axis=0, dtype=b.dtype))
    # and a round trip is the identity
    back, _ = ckpt.reshard_carry(got, gmeta, S)
    for a, b, kind in zip(back, leaves, kinds):
        if kind != "sum":
            assert np.array_equal(a, b)


def _error(fn, *args, **kw):
    with pytest.raises(Exception) as e:
        fn(*args, **kw)
    return type(e.value).__name__, str(e.value)


def test_reshard_and_restore_refusals_match_jax():
    """Every refusal of ``reshard_carry`` and ``restore_carry``'s reshard
    route, in JAX's words (the case of
    ``tests/test_campaign.py:351-377`` among them)."""
    rs = np.random.RandomState(1)
    kinds = ["instance", "sum", "key"]
    leaves = _random_wire(rs, kinds, 4, 2)
    shard = {"n-shards": 4, "instances-per-shard": 2, "leaf-kinds": kinds}
    bad_key = [x.copy() for x in leaves]
    bad_key[2][1] += 1
    cases = [(leaves, {}, 2), (leaves, shard, 3), (leaves, shard, 0),
             (leaves[:2], shard, 2), (bad_key, shard, 2),
             (leaves, dict(shard, **{"leaf-kinds": ["instance", "sum",
                                                    "other"]}), 2),
             (leaves, dict(shard, **{"instances-per-shard": 3}), 2),
             (leaves, dict(shard, **{"n-shards": 2}), 1)]
    for lv, sh, n in cases:
        got = _error(ckpt.reshard_carry, lv, sh, n)
        assert got == ("CheckpointError",
                       _error(jckpt.reshard_carry, lv, sh, n)[1])
    # restore_carry: a different global fleet is not a reshard
    jm, tm = jget_model("echo", 2), get_model("echo", 2)
    jsim4 = jmake_sim_config(jm, dict(ECHO_OPTS, n_instances=2))
    tsim4 = harness.make_sim_config(tm, dict(ECHO_OPTS, n_instances=2))
    t_leaves = [np.zeros(x.shape, x.dtype) for x in jax.tree.leaves(
        jmesh.wire_template(jm, jsim4, jmesh.make_mesh(4)))]
    shard = {"n-shards": 4, "instances-per-shard": 2, "interleaved": True,
             "leaf-kinds": mesh.wire_leaf_kinds(tm, tsim4)}
    jsim2 = jmake_sim_config(jm, dict(ECHO_OPTS, n_instances=3))
    tsim2 = harness.make_sim_config(tm, dict(ECHO_OPTS, n_instances=3))
    got = _error(ckpt.restore_carry,
                 mesh.wire_template(tm, tsim2, cpu_mesh(2)), t_leaves,
                 shard=shard)
    want = _error(jckpt.restore_carry,
                  jmesh.wire_template(jm, jsim2, jmesh.make_mesh(2)),
                  t_leaves, shard=shard)
    assert got == want
    assert "carry saved at 4 shards, mesh has 2" in got[1]
    assert "8 instances (4 x 2)" in got[1]
    # no shard metadata: a wrong-size mesh is refused, never re-chunked;
    # with a shard block that cannot reshard, the hint names it
    for sh in (None, {"n-shards": 4, "instances-per-shard": 2}):
        got = _error(ckpt.restore_carry,
                     mesh.wire_template(tm, tsim4, cpu_mesh(2)), t_leaves,
                     shard=sh)
        want = _error(jckpt.restore_carry,
                      jmesh.wire_template(jm, jsim4, jmesh.make_mesh(2)),
                      t_leaves, shard=sh)
        assert got == want and got[0] == "CheckpointError"


@pytest.mark.slow
@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_reshard_sweep_raft_lanes(tmp_path, S):
    """Every pair of shard counts on the Raft fleet with telemetry and the
    verdict lanes: a port checkpoint written at S resumes at every S',
    equal to JAX's uninterrupted run at S'."""
    opts = dict(RAFT_OPTS, time_limit=0.12, check_mode="both")
    tm, jm = RaftModel(**RAFT_KW), JRaftModel(**RAFT_KW)

    def sims(n):
        # all 8 recorded: the recorded set is the same at every S
        o = dict(opts, n_instances=8 // n, record_instances=8 // n)
        return (jmake_sim_config(jm, o), harness.make_sim_config(tm, o))

    d = str(tmp_path)
    _killed_run(mesh.run_sim_sharded_chunked, tm, sims(S)[1], cpu_mesh(S),
                d, ckpt.save_checkpoint)
    ck = ckpt.load_checkpoint(d)
    for new in (1, 2, 4, 8):
        jsim, tsim = sims(new)
        want = jmesh.run_sim_sharded_chunked(
            jm, jsim, 3, mesh=jmesh.make_mesh(new), chunk=40,
            return_telemetry=True, return_check_summary=True)
        msh = cpu_mesh(new)
        got = mesh.run_sim_sharded_chunked(
            tm, tsim, 3, mesh=msh, chunk=40, return_telemetry=True,
            return_check_summary=True, resume=ResumeState(
                carry=ckpt.restore_carry(
                    mesh.wire_template(tm, tsim, msh), ck["carry"],
                    shard=ck["meta"]["shard"]),
                ticks=ck["ticks"], chunks=ck["chunks"],
                events=tuple(ck["events"])))
        _same(want[:3] + want[4:], got[:3] + got[4:])
        for f, a, b in zip(want[3]._fields, want[3], got[3]):
            assert np.array_equal(np.asarray(a), b), f


def test_minor_sharded_checkpoint_is_the_lead_wire_and_reshards(tmp_path):
    """The wire is canonical: a minor run's sharded ``state.npz`` equals
    the lead run's array by array, header included, and it reshards from
    2 shards to 1 and resumes in the minor layout equal to the
    uninterrupted minor run."""
    tm, tsim = echo_sim("torch", 2)
    npz = {}
    for layout in ("lead", "minor"):
        d = str(tmp_path / layout)
        _killed_run(mesh.run_sim_sharded_chunked, tm,
                    tsim._replace(layout=layout), cpu_mesh(2), d,
                    ckpt.save_checkpoint)
        npz[layout] = _npz(ckpt.checkpoint_path(d))
    (a, ha), (b, hb) = npz["lead"], npz["minor"]
    assert ha == hb and a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    ck = ckpt.load_checkpoint(str(tmp_path / "minor"))
    _, tsim1 = echo_sim("torch", 1)
    tsim1 = tsim1._replace(layout="minor")
    msh = cpu_mesh(1)
    want = mesh.run_sim_sharded_chunked(tm, tsim1, 3, mesh=msh, chunk=40,
                                        return_check_summary=True)
    got = mesh.run_sim_sharded_chunked(
        tm, tsim1, 3, mesh=msh, chunk=40, return_check_summary=True,
        resume=ResumeState(
            carry=ckpt.restore_carry(mesh.wire_template(tm, tsim1, msh),
                                     ck["carry"], shard=ck["meta"]["shard"]),
            ticks=ck["ticks"], chunks=ck["chunks"],
            events=tuple(ck["events"])))
    _same(want, got)


def test_restore_is_on_the_requested_device(tmp_path):
    """``restore_carry`` of a sharded wire lands on ``device`` (the CPU by
    default); the executor then moves each shard to its own device."""
    tm, tsim = echo_sim("torch", 2)
    msh = cpu_mesh(2)
    d = str(tmp_path)
    _killed_run(mesh.run_sim_sharded_chunked, tm, tsim, msh, d,
                ckpt.save_checkpoint)
    ck = ckpt.load_checkpoint(d)
    wire = ckpt.restore_carry(mesh.wire_template(tm, tsim, msh),
                              ck["carry"], shard=ck["meta"]["shard"],
                              device=torch.device("cpu"))
    assert wire.pool.device.type == "cpu"
    assert tuple(wire.pool.shape)[0] == 8 and tuple(wire.key.shape) == (2, 2)
