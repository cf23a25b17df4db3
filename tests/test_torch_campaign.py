"""Checkpoint and resume of the port against the JAX package.

- **Checkpoints.** ``save_checkpoint``/``load_checkpoint`` round-trip a
  carry and the compacted chunks; a writer killed mid-write leaves the
  previous checkpoint or none; ``restore_carry`` refuses another
  configuration (naming a lane-width change) and a sharded checkpoint.
- **The file format.** On the same options the port's ``state.npz``
  after each save equals the JAX package's array by array, header
  included (bare echo, the journaled double-vote mutant, the device
  verdict lanes).
- **Resume.** A port run killed right after a checkpoint (a
  ``BaseException`` raised from the patched ``save_checkpoint``, as the
  JAX tests kill theirs) and resumed with ``campaign.runner.resume_run``
  ends with the results (less ``perf`` and ``store-dir``),
  ``history-*.jsonl`` and ``fleet-metrics.json`` of both the port's
  uninterrupted run and JAX's; the heartbeat has one seam and its end;
  a second resume lands on the same results; a checkpoint written by
  the JAX package resumes in the port to JAX's uninterrupted results;
  triage of a resumed run replays the whole horizon.

Sizes: the JAX campaign tests' ``ECHO_OPTS`` and ``BUGGY_OPTS``
(``tests/test_campaign.py:52-66``). Tolerance: exact."""

import copy
import glob
import json
import os
import shutil

import numpy as np
import pytest

import maelstrom_tpu.campaign.checkpoint as jckpt
from maelstrom_tpu.campaign.checkpoint import load_checkpoint as jload
from maelstrom_tpu.models import get_model as jget_model
from maelstrom_tpu.models.raft_buggy import RaftDoubleVote as JDoubleVote
from maelstrom_tpu.tpu.harness import run_tpu_test
from maelstrom_tpu.tpu.pipeline import ResumeState as JResumeState
from maelstrom_tpu.tpu.pipeline import resume_plans as jresume_plans
from maelstrom_tpu_torch import convert, harness
from maelstrom_tpu_torch.campaign import checkpoint as ckpt
from maelstrom_tpu_torch.campaign.checkpoint import (CheckpointError,
                                                     checkpoint_path,
                                                     load_checkpoint,
                                                     restore_carry,
                                                     save_checkpoint)
from maelstrom_tpu_torch.campaign.runner import resume_run
from maelstrom_tpu_torch.checkers.triage import triage_run
from maelstrom_tpu_torch.models import get_model
from maelstrom_tpu_torch.models.raft_buggy import RaftDoubleVote
from maelstrom_tpu_torch.pipeline import (ResumeState, resume_plans,
                                          run_sim_pipelined)
from maelstrom_tpu_torch.runtime import init_carry
from maelstrom_tpu_torch.telemetry.stream import read_heartbeat

from test_campaign import BUGGY_OPTS, ECHO_OPTS
from torch_mutant_cases import COMPARED, read
from torch_mutant_cases import one_torch_thread  # noqa: F401 (autouse)
from torch_tutorial_cases import JAX_RUN

# options both harnesses take and record alike in the run-start record
# (tests/test_torch_forensics.py's SHARED): the JAX lifecycle options
# off, the heartbeat on (a resume rebuilds the run from it), and the
# port's defaults that the JAX harness lacks or sets otherwise
SHARED = dict(JAX_RUN, heartbeat=True, check_mode="farm", layout="lead",
              nemesis_kind="random-halves", nemesis_schedule=(),
              availability=None, funnel_max=32)
CKPT = dict(ECHO_OPTS, checkpoint_every=2, **SHARED)
BUGGY_KW = dict(n_nodes_hint=3, log_cap=64, heartbeat=8)


class Killed(BaseException):
    """A simulated SIGKILL, raised from the checkpoint sink right after
    a checkpoint lands (a BaseException, so no ``except Exception``
    path swallows it)."""


def _kill_after(module, n_saves):
    """Make ``module.save_checkpoint`` die after its ``n_saves``-th
    save; returns the thunk that restores it."""
    orig = module.save_checkpoint
    calls = [0]

    def dying(*a, **k):
        path = orig(*a, **k)
        calls[0] += 1
        if calls[0] >= n_saves:
            raise Killed
        return path

    module.save_checkpoint = dying
    return lambda: setattr(module, "save_checkpoint", orig)


def _killed_run(run, module, root, n_saves=1):
    """``run()`` killed after its ``n_saves``-th checkpoint; the one run
    dir it left under ``root``."""
    restore = _kill_after(module, n_saves)
    try:
        with pytest.raises(Killed):
            run()
    finally:
        restore()
    (run_dir,) = glob.glob(os.path.join(root, "*", "2*"))
    assert not os.path.exists(os.path.join(run_dir, "results.json"))
    return run_dir


def _strip(results):
    """The results that must be equal across a kill and a resume: all
    but the wall-clock perf and the store path."""
    r = copy.deepcopy(results)
    r.pop("perf", None)
    r.pop("store-dir", None)
    return json.loads(json.dumps(r, default=repr))


def _assert_like_jax(jres, tres):
    """The port's results equal JAX's on every compared block."""
    jkeys = [k for k in jres if k not in ("perf", "store-dir")]
    assert set(jkeys) <= set(COMPARED), set(jkeys) - set(COMPARED)
    for k in jkeys:
        assert tres[k] == jres[k], k


def _echo():
    return jget_model("echo", 2), get_model("echo", 2)


# --- checkpoints -------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    model = get_model("echo", 2)
    sim = harness.make_sim_config(model, ECHO_OPTS)
    res = run_sim_pipelined(model, sim, 3, "cpu", chunk=50)
    d = str(tmp_path)
    save_checkpoint(d, kind="pipelined", state=res.carry, ticks=300,
                    chunks=6, compact=tuple(res.compact),
                    meta={"workload": "echo"})
    ck = load_checkpoint(d)
    assert ck["kind"] == "pipelined"
    assert ck["ticks"] == 300 and ck["chunks"] == 6
    assert len(ck["compact"]) == len(res.compact) == 6
    for (a, na), (b, nb) in zip(ck["compact"], res.compact):
        assert na == nb and np.array_equal(a, b)
    assert ck["meta"]["workload"] == "echo"
    leaves = [a for _, a in convert.carry_leaves(
        convert.carry_to_numpy(res.carry))]
    assert len(ck["carry"]) == len(leaves)
    for a, b in zip(ck["carry"], leaves):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # and back into a carry of the same structure, leaf for leaf
    back = restore_carry(res.carry, ck["carry"], device="cpu")
    for (n, a), (m, b) in zip(
            convert.carry_leaves(convert.carry_to_numpy(back)),
            convert.carry_leaves(convert.carry_to_numpy(res.carry))):
        assert n == m and np.array_equal(a, b)


def test_checkpoint_kill_mid_write_leaves_old_or_none(tmp_path,
                                                      monkeypatch):
    """A writer that dies before the rename pivot leaves the previous
    checkpoint intact, and a first write that dies leaves none."""
    model = get_model("echo", 2)
    sim = harness.make_sim_config(model, ECHO_OPTS)
    carry = init_carry(model, sim, 3, "cpu")
    d = str(tmp_path)

    def torn_savez(f, **arrays):
        f.write(b"\x00" * 37)   # partial garbage, then the "kill"
        raise Killed

    monkeypatch.setattr(np, "savez", torn_savez)
    with pytest.raises(Killed):
        save_checkpoint(d, kind="pipelined", state=carry, ticks=50,
                        chunks=1)
    monkeypatch.undo()
    assert load_checkpoint(d) is None
    assert not glob.glob(checkpoint_path(d) + ".tmp-*")

    save_checkpoint(d, kind="pipelined", state=carry, ticks=50, chunks=1)
    monkeypatch.setattr(np, "savez", torn_savez)
    with pytest.raises(Killed):
        save_checkpoint(d, kind="pipelined", state=carry, ticks=100,
                        chunks=2)
    monkeypatch.undo()
    ck = load_checkpoint(d)
    assert ck is not None and ck["ticks"] == 50


@pytest.mark.parametrize("case", ["instances", "lane-width", "leaves"])
def test_restore_refuses_config_mismatch(tmp_path, case):
    """Another instance count is refused with the plain message; a
    checkpoint taken without the NETID lane, resumed with it, is named
    as a lane-width change (the JAX refusal's hint); a carry with
    another leaf count (telemetry off) is refused by its count."""
    model = get_model("echo", 2)
    sim = harness.make_sim_config(model, ECHO_OPTS)
    d = str(tmp_path)
    save_checkpoint(d, kind="pipelined",
                    state=init_carry(model, sim, 3, "cpu"), ticks=50,
                    chunks=1)
    ck = load_checkpoint(d)
    other = {"instances": dict(ECHO_OPTS, n_instances=16),
             "lane-width": dict(ECHO_OPTS, netid=True),
             "leaves": dict(ECHO_OPTS, telemetry=False)}[case]
    template = init_carry(model, harness.make_sim_config(model, other), 3,
                          "cpu")
    with pytest.raises(CheckpointError) as e:
        restore_carry(template, ck["carry"])
    assert ("LANE-WIDTH" in str(e.value)) == (case == "lane-width")
    assert ("carry leaves but the rebuilt config produces"
            in str(e.value)) == (case == "leaves")
    assert "does not match the checkpointed run" in str(e.value)


def test_sharded_checkpoint_refused_by_name(tmp_path):
    """What is still refused: ``run_torch_test`` resumes single-device
    runs only (a sharded checkpoint is refused in JAX's words, as
    ``run_tpu_test`` refuses it), and ``reshard_carry`` needs the shard
    metadata the sharded executor records."""
    model = get_model("echo", 2)
    sim = harness.make_sim_config(model, ECHO_OPTS)
    carry = init_carry(model, sim, 3, "cpu")
    d = str(tmp_path)
    save_checkpoint(d, kind="sharded", state=carry, ticks=50, chunks=1)
    with pytest.raises(CheckpointError) as e:
        harness.run_torch_test(model, dict(ECHO_OPTS), device="cpu",
                               resume_from=d)
    with pytest.raises(jckpt.CheckpointError) as je:
        run_tpu_test(jget_model("echo", 2), dict(ECHO_OPTS, **JAX_RUN),
                     resume_from=d)
    assert str(e.value) == str(je.value).replace("run_tpu_test",
                                                 "run_torch_test")
    assert "holds a 'sharded' checkpoint" in str(e.value)
    assert "resumes single-device runs only" in str(e.value)
    leaves = load_checkpoint(d)["carry"]
    with pytest.raises(CheckpointError) as e:
        ckpt.reshard_carry(leaves, {"n-shards": 2}, 1)
    with pytest.raises(jckpt.CheckpointError) as je:
        jckpt.reshard_carry(leaves, {"n-shards": 2}, 1)
    assert str(e.value) == str(je.value)
    assert "lacks per-leaf shard metadata" in str(e.value)


@pytest.mark.parametrize("n_ticks,chunk,frontier", [
    (300, 50, None), (300, 50, 100), (300, 50, 70), (300, 50, 300),
    (250, 100, 100), (250, 100, 125), (1000, 100, 400)])
def test_resume_plans_match_jax(n_ticks, chunk, frontier):
    """The resumed plan is the JAX package's, and a frontier off the
    plan's boundaries is refused by both."""
    def plans(fn, rs):
        try:
            return fn(n_ticks, chunk, rs)
        except ValueError as e:
            return ("refused", "not a chunk boundary" in str(e))
    got = plans(resume_plans, None if frontier is None
                else ResumeState(carry=None, ticks=frontier))
    want = plans(jresume_plans, None if frontier is None
                 else JResumeState(carry=None, ticks=frontier))
    assert got == want
    if (n_ticks, chunk, frontier) == (300, 50, 70):
        assert got == ("refused", True)


# --- the file format ---------------------------------------------------------


FORMAT_CASES = {
    "echo": (lambda: (jget_model("echo", 2), get_model("echo", 2)), CKPT),
    # the double-vote mutant journaling instance 0: the NETID lane, the
    # journal blocks and a violating fleet
    "double-vote-journaled": (
        lambda: (JDoubleVote(**BUGGY_KW), RaftDoubleVote(**BUGGY_KW)),
        dict(BUGGY_OPTS, checkpoint_every=2, journal_instances=1,
             **SHARED)),
    # the device verdict lanes ride the carry
    "echo-device-lanes": (
        lambda: (jget_model("echo", 2), get_model("echo", 2)),
        dict(CKPT, check_mode="device")),
    # a minor run's state.npz holds its batch-last leaves, as JAX's does
    "echo-minor": (
        lambda: (jget_model("echo", 2), get_model("echo", 2)),
        dict(CKPT, layout="minor")),
}


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("case", list(FORMAT_CASES))
def test_state_npz_equals_jax(tmp_path, case):
    """Each save's ``state.npz``: the same keys, and every array equal
    to the JAX package's in shape, dtype and value, header included."""
    models, opts = FORMAT_CASES[case]
    jmodel, model = models()
    saves = {}

    def recorder(module, side):
        orig = module.save_checkpoint

        def save(run_dir, **kw):
            path = orig(run_dir, **kw)
            saves.setdefault(side, []).append(_npz(path))
            return path
        module.save_checkpoint = save
        return lambda: setattr(module, "save_checkpoint", orig)

    for module, side, run in (
            (jckpt, "jax", lambda: run_tpu_test(jmodel, dict(
                opts, store_root=str(tmp_path / "j")))),
            (ckpt, "torch", lambda: harness.run_torch_test(model, dict(
                opts, store_root=str(tmp_path / "t")), device="cpu"))):
        restore = recorder(module, side)
        try:
            run()
        finally:
            restore()
    assert len(saves["torch"]) == len(saves["jax"]) == 2
    for k, (j, t) in enumerate(zip(saves["jax"], saves["torch"])):
        assert sorted(t) == sorted(j), k
        for key in j:
            assert t[key].dtype == j[key].dtype, (k, key)
            assert t[key].shape == j[key].shape, (k, key)
            assert np.array_equal(t[key], j[key]), (k, key)
        header = json.loads(bytes(t["__meta__"]).decode())
        assert header["ticks"] == 100 * (k + 1)
        if "journal" in case:
            assert header["n-journal"] == 2 * (k + 1)


# --- resume ------------------------------------------------------------------


@pytest.mark.parametrize("check_mode", ["farm", "device"])
def test_resume_bit_identical(tmp_path, check_mode):
    """Killed after a mid-run checkpoint and resumed, the executor's
    compacted chunks and final carry (the device verdict lanes
    included) equal the uninterrupted run's: the port's counterpart of
    the JAX summary lanes' resume test (``tests/test_device_check.py:
    257-300``), on one device."""
    model = get_model("echo", 2)
    sim = harness.make_sim_config(model, dict(ECHO_OPTS,
                                              check_mode=check_mode))
    assert sim.check_summary == (check_mode == "device")
    base = run_sim_pipelined(model, sim, 3, "cpu", chunk=50)
    d = str(tmp_path)

    def cb(state, ticks, host):
        save_checkpoint(d, kind="pipelined", state=state, ticks=ticks,
                        chunks=host["chunks"],
                        compact=tuple(host["compact"]),
                        journal=tuple(host["journal"]))
        raise Killed

    with pytest.raises(Killed):
        run_sim_pipelined(model, sim, 3, "cpu", chunk=50,
                          checkpoint_cb=cb, checkpoint_every=2)
    ck = load_checkpoint(d)
    assert ck["ticks"] == 100 and ck["chunks"] == 2
    resume = ResumeState(
        carry=restore_carry(init_carry(model, sim, 3, "cpu"), ck["carry"],
                            device="cpu"),
        ticks=ck["ticks"], chunks=ck["chunks"],
        compact=tuple(ck["compact"]), journal=tuple(ck["journal"]))
    res = run_sim_pipelined(model, sim, 3, "cpu", chunk=50, resume=resume)
    assert res.perf["resumed-from-ticks"] == 100
    assert res.perf["ticks-dispatched"] == sim.n_ticks
    assert res.perf["chunks"] == 4
    assert len(res.compact) == len(base.compact) == 6
    for (a, na), (b, nb) in zip(base.compact, res.compact):
        assert na == nb and np.array_equal(a, b)
    got = dict(convert.carry_leaves(convert.carry_to_numpy(res.carry)))
    for name, a in convert.carry_leaves(convert.carry_to_numpy(base.carry)):
        assert np.array_equal(a, got.pop(name)), name
    assert not got
    if check_mode == "device":
        assert base.carry.check_summary is not None


def test_minor_checkpoint_resumes_in_either_layout(tmp_path):
    """A minor run killed after its first checkpoint resumes bit-exactly
    in place (its recorded layout), and a copy resumed under the lead
    layout (a card's run resumed on the CPU: "auto" resolves the other
    way there) turns the restored carry over once and ends with the same
    results."""
    # 200 ticks (cut from 300): the first checkpoint at tick 100
    opts = dict(CKPT, layout="minor", time_limit=0.2)
    oracle = harness.run_torch_test(get_model("echo", 2), dict(
        opts, store_root=str(tmp_path / "oracle")), device="cpu")
    run_dir = _killed_run(
        lambda: harness.run_torch_test(get_model("echo", 2), dict(
            opts, store_root=str(tmp_path / "killed")), device="cpu"),
        ckpt, str(tmp_path / "killed"))
    ck = load_checkpoint(run_dir)
    assert ck["meta"]["layout"] == "minor"
    assert ck["carry"][0].shape[-1] == opts["n_instances"]   # the pool
    copy_dir = str(tmp_path / "copy")
    shutil.copytree(run_dir, copy_dir)
    resumed = resume_run(run_dir, device="cpu")
    lead = harness.run_torch_test(get_model("echo", 2),
                                  dict(opts, layout="lead"), device="cpu",
                                  resume_from=copy_dir)
    assert _strip(resumed) == _strip(lead) == _strip(oracle)


@pytest.fixture(scope="module")
def resumed_echo(tmp_path_factory):
    """JAX's uninterrupted run, the port's uninterrupted run, and a port
    run killed after its first checkpoint and resumed, of one
    configuration."""
    root = tmp_path_factory.mktemp("resume")
    jmodel, model = _echo()
    jres = run_tpu_test(jmodel, dict(CKPT, store_root=str(root / "jax")))
    oracle = harness.run_torch_test(model, dict(
        CKPT, store_root=str(root / "oracle")), device="cpu")
    run_dir = _killed_run(
        lambda: harness.run_torch_test(get_model("echo", 2), dict(
            CKPT, store_root=str(root / "killed")), device="cpu"),
        ckpt, str(root / "killed"))
    ck = load_checkpoint(run_dir)
    assert ck["ticks"] == 100 and ck["chunks"] == 2
    resumed = resume_run(run_dir, device="cpu")
    return jres, oracle, resumed, run_dir


def test_resume_run_matches_uninterrupted(resumed_echo):
    jres, oracle, resumed, run_dir = resumed_echo
    assert _strip(resumed) == _strip(oracle)
    assert resumed["valid?"] is True
    assert resumed["store-dir"] == run_dir
    _assert_like_jax(jres, resumed)
    pipe = resumed["perf"]["phases"]["pipeline"]
    assert pipe["resumed-from-ticks"] == 100
    assert pipe["checkpoints"] == 1   # at tick 200; none after the last


@pytest.mark.parametrize("name", ["history-0.jsonl", "history-1.jsonl",
                                  "fleet-metrics.json"])
def test_resumed_store_artifacts_match(resumed_echo, name):
    """The resumed run's stored histories and fleet metrics are the
    uninterrupted runs' byte for byte, the port's and JAX's."""
    jres, oracle, _, run_dir = resumed_echo
    assert read(run_dir, name) == read(oracle["store-dir"], name)
    assert read(run_dir, name) == read(jres["store-dir"], name)


def test_resumed_heartbeat_has_seam_and_end(resumed_echo):
    jres, _, _, run_dir = resumed_echo
    hb = read_heartbeat(run_dir)
    assert len(hb["resumes"]) == 1
    seam = hb["resumes"][0]
    assert seam["from-ticks"] == 100 and seam["chunks-done"] == 2
    assert seam["workload"] == "echo"
    assert hb["end"]["status"] == "complete" and hb["end"]["ticks"] == 300
    # the kill came at the cut after chunk 1, and the records go on at
    # the absolute chunk cursor
    assert [r["chunk"] for r in hb["chunks"]] == [0, 1, 2, 3, 4, 5]
    # the run-start record is JAX's, whole: checkpoint_every included
    with open(os.path.join(jres["store-dir"], "heartbeat.jsonl")) as f:
        jstart = json.loads(f.readline())
    assert hb["header"] == jstart
    assert hb["header"]["opts"]["checkpoint_every"] == 2


def test_double_resume_idempotent(resumed_echo):
    """A second resume of the finished run re-runs its tail from the
    checkpoint, which is still there, and lands on the same results."""
    _, oracle, _, run_dir = resumed_echo
    again = resume_run(run_dir, device="cpu")
    assert _strip(again) == _strip(oracle)
    hb = read_heartbeat(run_dir)
    assert len(hb["resumes"]) == 2 and hb["end"] is not None


def test_resume_without_checkpoint_refused(tmp_path):
    with pytest.raises(CheckpointError, match="no checkpoint"):
        resume_run(str(tmp_path), device="cpu")
    with pytest.raises(CheckpointError, match="no checkpoint"):
        harness.run_torch_test(get_model("echo", 2), dict(ECHO_OPTS),
                               device="cpu", resume_from=str(tmp_path))


def test_aot_fingerprint_resume_refused_by_name(resumed_echo, tmp_path,
                                                monkeypatch):
    """The store's drift gate, as JAX's campaign resume holds it: a
    fingerprint this package wrote is recomputed from the record's
    options — a match resumes, a drift is refused naming EXE901; one the
    JAX package wrote keys an XLA executable and is refused by name."""
    import shutil
    _, oracle, _, run_dir = resumed_echo
    monkeypatch.delenv("MAELSTROM_AOT", raising=False)

    def with_start(name, **edit):
        d = str(tmp_path / name)
        shutil.copytree(run_dir, d)
        path = os.path.join(d, "heartbeat.jsonl")
        with open(path) as f:
            lines = f.readlines()
        start = json.loads(lines[0])
        start.update(edit)
        lines[0] = json.dumps(start) + "\n"
        with open(path, "w") as f:
            f.writelines(lines)
        return d, start

    # the resumed runs keep their store in the test's directory
    store = {"aot_store": str(tmp_path / "store")}
    _, start = with_start("run")
    fp = harness.aot_fingerprint_for(get_model("echo", 2),
                                     dict(start["opts"], **store),
                                     device="cpu")
    assert fp is not None
    ours = {"aot-engine": harness.AOT_ENGINE, "aot-device": ["cpu", "cpu"]}
    ok, _ = with_start("ok", **{"aot-fingerprint": fp}, **ours)
    assert _strip(resume_run(ok, device="cpu", opts_override=store)) \
        == _strip(oracle)
    drifted, _ = with_start("drift", **{"aot-fingerprint": "0123abcd"},
                            **ours)
    with pytest.raises(CheckpointError, match="EXE901"):
        resume_run(drifted, device="cpu", opts_override=store)
    jax_written, _ = with_start("jax", **{"aot-fingerprint": "0123abcd"})
    with pytest.raises(CheckpointError, match="aot-fingerprint"):
        resume_run(jax_written, device="cpu", opts_override=store)


def test_checkpoint_notes_without_store_or_chunks(tmp_path, capsys):
    """Durability that would not exist is said, as the JAX harness
    says it: no store dir, or the single-loop executor."""
    model = get_model("echo", 2)
    harness.run_torch_test(model, dict(CKPT), device="cpu")
    assert ("note: --checkpoint-every has no effect here (no store dir "
            "to hold checkpoint/); the run will NOT be resumable"
            in capsys.readouterr().err)
    res = harness.run_torch_test(model, dict(
        CKPT, pipeline="off", store_root=str(tmp_path)), device="cpu")
    assert ("(the monolithic executor has no chunk boundaries to "
            "checkpoint at)" in capsys.readouterr().err)
    assert load_checkpoint(res["store-dir"]) is None


def test_jax_checkpoint_resumed_by_port(resumed_echo, tmp_path):
    """A run the JAX package checkpointed and was killed in, resumed by
    the port: JAX's uninterrupted results and histories."""
    jres = resumed_echo[0]
    root = str(tmp_path / "jax-killed")
    run_dir = _killed_run(
        lambda: run_tpu_test(jget_model("echo", 2), dict(
            CKPT, store_root=root)), jckpt, root)
    assert jload(run_dir)["ticks"] == 100
    resumed = resume_run(run_dir, device="cpu")
    _assert_like_jax(jres, resumed)
    for name in ("history-0.jsonl", "history-1.jsonl",
                 "fleet-metrics.json"):
        assert read(run_dir, name) == read(jres["store-dir"], name), name
    assert len(read_heartbeat(run_dir)["resumes"]) == 1


def test_triage_on_resumed_run_covers_full_horizon(tmp_path):
    """Triage of a killed-then-resumed run of the planted double-vote
    mutant replays its flagged instances over the whole horizon across
    the seam, and each trips again; the flagged set is JAX's."""
    opts = dict(BUGGY_OPTS, checkpoint_every=2, **SHARED)
    jres = run_tpu_test(JDoubleVote(**BUGGY_KW), dict(
        opts, store_root=str(tmp_path / "jax")))
    assert jres["valid?"] is False
    root = str(tmp_path / "killed")
    run_dir = _killed_run(
        lambda: harness.run_torch_test(RaftDoubleVote(**BUGGY_KW), dict(
            opts, store_root=root), device="cpu"), ckpt, root)
    resumed = resume_run(run_dir, device="cpu")
    _assert_like_jax(jres, resumed)
    summary = triage_run(run_dir, max_instances=2, device="cpu")
    assert summary["flagged"] == \
        jres["invariants"]["violating-instance-ids"]
    assert summary["ticks"] == 300   # the whole horizon, not the tail
    assert summary["replayed-violating"] == len(summary["triaged"]) == 2


def test_resumed_device_lanes_cover_full_horizon(tmp_path):
    """The double-vote mutant in ``both`` mode, killed after its first
    checkpoint and resumed: the checkpointed chunks go through the
    stream decoder ahead of the live suffix, so the farm checks every
    recorded instance's whole history and the ``check`` block, the
    audit and every verdict equal JAX's uninterrupted run's."""
    opts = dict(BUGGY_OPTS, checkpoint_every=2, **dict(SHARED,
                                                       check_mode="both"))
    jres = run_tpu_test(JDoubleVote(**BUGGY_KW), dict(
        opts, store_root=str(tmp_path / "jax")))
    root = str(tmp_path / "killed")
    run_dir = _killed_run(
        lambda: harness.run_torch_test(RaftDoubleVote(**BUGGY_KW), dict(
            opts, store_root=root), device="cpu"), ckpt, root)
    resumed = resume_run(run_dir, device="cpu")
    assert resumed["check"]["device-vs-farm"]["complete"] is True
    assert resumed["check"] == jres["check"]
    _assert_like_jax({k: v for k, v in jres.items() if k != "check"},
                     resumed)
    for i in range(opts["record_instances"]):
        name = f"history-{i}.jsonl"
        assert read(run_dir, name) == read(jres["store-dir"], name)
