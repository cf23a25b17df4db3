"""The port's device profiler (``telemetry/profiler.py``) against the JAX
package's (``tests/test_profiler.py``, case by case).

- **Observational.** The port's carry and compacted events are the same
  with ``device_profile`` off and on, in the pipelined and the sharded
  executor, and equal the live JAX carry with the JAX profiler on; a
  killed run resumed with profiling on ends equal to the uninterrupted
  unprofiled run, and captures by absolute chunk index (``on``: the
  rest of the chunks; ``auto``: JAX's ``should_capture`` picks).
- **Schemas.** The heartbeat's ``device-ms`` lane and
  ``results.perf.phases.device`` have JAX's keys (the values masked),
  the timed source's phases are JAX's phases for the configuration,
  ``render_chunk_line`` renders a record as JAX's does, and ``profile``
  prints what the JAX CLI prints on the same run dir.
- **Sources.** The timed source splits the measured wall by the tick's
  per-phase operator counts and sums to it; the marks source sums to its
  wall too, is torn down when the chunk raises, and a trace attempt that
  fails latches the process to the timed source.
- **Campaigns.** The campaign report's and status table's device columns
  equal the JAX report's on the same port-written campaign dir.

Sizes: the JAX tests' ``ECHO_OPTS`` (8 instances, 50-tick chunks) cut
from 300 ticks to 150 (``OPTS``; the resume 120 ticks in 10-tick
chunks, so that auto mode's every-8th pick lies past the kill).
Tolerance: exact for trajectories; device times are compared
by schema, never by value."""

import contextlib
import io
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from maelstrom_tpu import cli as jcli
from maelstrom_tpu.campaign import queue as jqueue
from maelstrom_tpu.campaign.report import campaign_report as jreport
from maelstrom_tpu.campaign.report import campaign_status as jstatus
from maelstrom_tpu.campaign.report import render_report as jrender_report
from maelstrom_tpu.campaign.report import render_status as jrender_status
from maelstrom_tpu.models.echo import EchoModel as JEcho
from maelstrom_tpu.telemetry import profiler as jprofiler
from maelstrom_tpu.telemetry.stream import render_chunk_line as jrender
from maelstrom_tpu.tpu import pipeline as jpipeline
from maelstrom_tpu.tpu import runtime as jruntime
from maelstrom_tpu.tpu.harness import make_sim_config as jmake_sim_config
from maelstrom_tpu.tpu.harness import run_tpu_test
from maelstrom_tpu_torch import convert, harness
from maelstrom_tpu_torch.__main__ import main
from maelstrom_tpu_torch.campaign import queue as cqueue
from maelstrom_tpu_torch.campaign.checkpoint import (load_checkpoint,
                                                     restore_carry,
                                                     save_checkpoint)
from maelstrom_tpu_torch.campaign.report import (campaign_report,
                                                 campaign_status,
                                                 render_report,
                                                 render_status)
from maelstrom_tpu_torch.campaign.runner import run_campaign
from maelstrom_tpu_torch.models.echo import EchoModel
from maelstrom_tpu_torch.parallel import mesh
from maelstrom_tpu_torch.pipeline import ResumeState, run_sim_pipelined
from maelstrom_tpu_torch.runtime import init_carry
from maelstrom_tpu_torch.telemetry import profiler
from maelstrom_tpu_torch.telemetry.profiler import (PHASE_LABELS,
                                                    DeviceProfiler, phase,
                                                    phase_weights,
                                                    render_profile_report)
from maelstrom_tpu_torch.telemetry.stream import (HeartbeatWriter,
                                                  read_heartbeat,
                                                  render_chunk_line)

from test_profiler import ECHO_OPTS
from torch_tutorial_cases import JAX_RUN
from torch_tutorial_cases import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
OPTS = dict(ECHO_OPTS, time_limit=0.15)


class Killed(BaseException):
    pass


def _leaves(carry):
    return dict(convert.carry_leaves(convert.carry_to_numpy(carry)))


def _same_carry(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert set(la) == set(lb)
    for name, x in la.items():
        np.testing.assert_array_equal(x, lb[name], err_msg=name)


def _same_compact(a, b):
    assert len(a) == len(b)
    for (ra, na), (rb, nb) in zip(a, b):
        assert na == nb and np.array_equal(ra, rb)


def _cli(fn, *argv):
    """A CLI's exit code, standard output and standard error."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(list(argv))
    return rc, out.getvalue(), err.getvalue()


# --- observational purity --------------------------------------------------

def test_pipelined_bit_identity_on_off():
    model = EchoModel()
    sim = harness.make_sim_config(model, OPTS)
    off = run_sim_pipelined(model, sim, 3, CPU, chunk=50)
    prof = DeviceProfiler("on", model=model, sim=sim, device=CPU)
    on = run_sim_pipelined(model, sim, 3, CPU, chunk=50, profiler=prof)
    _same_carry(off.carry, on.carry)
    _same_compact(off.compact, on.compact)
    assert len(prof.records) == on.perf["chunks"] == 3
    assert on.perf["device"]["captured-chunks"] == 3
    assert "device" not in off.perf
    # the live JAX carry, with the JAX profiler on
    jm = JEcho()
    jsim = jmake_sim_config(jm, OPTS)
    params = jm.make_params(jsim.net.n_nodes)
    jres = jpipeline.run_sim_pipelined(
        jm, jsim, 3, params, chunk=50,
        profiler=jprofiler.DeviceProfiler("on", model=jm, sim=jsim,
                                          params=params))
    ref = dict(convert.carry_leaves(jax.tree.map(
        np.asarray, jruntime.canonical_carry(jres.carry, jsim))))
    got = _leaves(on.carry)
    assert set(got) <= set(ref)
    for name, x in got.items():
        np.testing.assert_array_equal(ref[name], x, err_msg=name)


def test_pipelined_bit_identity_on_off_minor():
    """The minor layout with the profiler on: the phase marks of the
    minor tick are observational (the carry, batch-last, and the
    compacted chunks equal the unprofiled run's; its JAX twin is
    ``tests/test_torch_campaign.py``'s echo-minor ``state.npz``), and
    its timed weights count the minor tick."""
    model = EchoModel()
    sim = harness.make_sim_config(model, dict(OPTS, layout="minor",
                                              time_limit=0.1))
    assert sim.layout == "minor"
    off = run_sim_pipelined(model, sim, 3, CPU, chunk=50)
    prof = DeviceProfiler("on", model=model, sim=sim, device=CPU)
    on = run_sim_pipelined(model, sim, 3, CPU, chunk=50, profiler=prof)
    _same_carry(off.carry, on.carry)
    _same_compact(off.compact, on.compact)
    assert on.carry.pool.shape[-1] == sim.n_instances
    assert on.perf["device"]["captured-chunks"] == 2
    assert set(phase_weights(model, sim)) >= {"deliver", "enqueue"}


def test_sharded_bit_identity_on_off():
    model = EchoModel()
    sim = harness.make_sim_config(model, dict(ECHO_OPTS, n_instances=4,
                                              time_limit=0.06))
    devs = mesh.make_mesh(devices=[CPU] * 2)
    off = mesh.run_sim_sharded_chunked(model, sim, 3, mesh=devs, chunk=20)
    prof = DeviceProfiler("on", model=model, sim=sim, device=CPU)
    perf = {}
    on = mesh.run_sim_sharded_chunked(model, sim, 3, mesh=devs, chunk=20,
                                      perf=perf, profiler=prof)
    assert tuple(off[0]) == tuple(on[0])
    assert np.array_equal(off[1], on[1])
    assert np.array_equal(off[2], on[2])
    assert perf["device"]["captured-chunks"] == perf["chunks"] == 3


def test_auto_mode_samples_as_jax():
    p, j = DeviceProfiler("auto"), jprofiler.DeviceProfiler("auto")
    got = [p.should_capture(i) for i in range(40)]
    assert got == [j.should_capture(i) for i in range(40)]
    assert 0 < sum(got) < 40
    assert (p.AUTO_FIRST_K, p.AUTO_EVERY_N) == (j.AUTO_FIRST_K,
                                                j.AUTO_EVERY_N)
    assert all(DeviceProfiler("on").should_capture(i) for i in range(9))
    with pytest.raises(ValueError):
        DeviceProfiler("sometimes")


RESUME_OPTS = dict(ECHO_OPTS, time_limit=0.12, chunk_ticks=10)
_BASE = {}


def _uninterrupted(model, sim):
    """The unprofiled run both resume cases are held to (run once)."""
    if "res" not in _BASE:
        _BASE["res"] = run_sim_pipelined(model, sim, 3, CPU, chunk=10)
    return _BASE["res"]


@pytest.mark.parametrize("mode", ["on", "auto"])
def test_resume_with_profiling_bit_exact(tmp_path, mode):
    """Killed at the tick-40 checkpoint (chunk 4 of 12) and resumed
    with profiling on: equal to the uninterrupted unprofiled run, and
    the resumed segment captures by absolute chunk index."""
    model = EchoModel()
    sim = harness.make_sim_config(model, RESUME_OPTS)
    base = _uninterrupted(model, sim)
    d = str(tmp_path)

    def cb(state, ticks, host):
        save_checkpoint(d, kind="pipelined", state=state, ticks=ticks,
                        chunks=host["chunks"],
                        compact=tuple(host["compact"]),
                        journal=tuple(host["journal"]))
        raise Killed

    with pytest.raises(Killed):
        run_sim_pipelined(model, sim, 3, CPU, chunk=10, checkpoint_cb=cb,
                          checkpoint_every=4,
                          profiler=DeviceProfiler(mode, model=model,
                                                  sim=sim))
    ck = load_checkpoint(d)
    assert ck["chunks"] == 4
    resume = ResumeState(
        carry=restore_carry(init_carry(model, sim, 3, CPU), ck["carry"],
                            device=CPU),
        ticks=ck["ticks"], chunks=ck["chunks"],
        compact=tuple(ck["compact"]), journal=tuple(ck["journal"]))
    prof = DeviceProfiler(mode, model=model, sim=sim)
    hb = HeartbeatWriter(str(tmp_path), {"workload": "echo"},
                         resume_from=ck["ticks"])
    res = run_sim_pipelined(model, sim, 3, CPU, chunk=10, resume=resume,
                            profiler=prof, heartbeat=hb)
    hb.finish()
    _same_carry(base.carry, res.carry)
    _same_compact(base.compact, res.compact)
    captured = [r["chunk"] for r in read_heartbeat(str(tmp_path))["chunks"]
                if r.get("device-ms")]
    jp = jprofiler.DeviceProfiler(mode)
    assert captured == [i for i in range(4, 12) if jp.should_capture(i)]
    assert len(prof.records) == len(captured)
    assert captured == (list(range(4, 12)) if mode == "on" else [8])


# --- the streamed schema ---------------------------------------------------

@pytest.fixture(scope="module")
def profiled_runs(tmp_path_factory):
    """One stored chunked echo run with ``device_profile="on"`` by each
    package, and a copy of the port's run under a JAX store name."""
    root = tmp_path_factory.mktemp("prof-store")
    opts = dict(OPTS, **dict(JAX_RUN, heartbeat=True,
                             device_profile="on"))
    tres = harness.run_torch_test(EchoModel(), dict(
        opts, store_root=str(root / "torch")), device="cpu")
    jres = run_tpu_test(JEcho(), dict(opts, store_root=str(root / "jax")))
    run_dir = tres["store-dir"]
    copy = str(root / "copy" / "echo-tpu" / os.path.basename(run_dir))
    shutil.copytree(run_dir, copy)
    return tres, jres, run_dir, copy


def _chunks(run_dir):
    return read_heartbeat(os.path.join(run_dir, "heartbeat.jsonl"))["chunks"]


def test_heartbeat_device_ms_schema(profiled_runs):
    tres, jres, run_dir, _ = profiled_runs
    recs, jrecs = _chunks(run_dir), _chunks(jres["store-dir"])
    assert len(recs) == len(jrecs) == 3
    for rec, jrec in zip(recs, jrecs):
        assert set(rec) == set(jrec)
        assert set(rec["device-ms"]) == set(jrec["device-ms"])
        assert set(rec["device-ms"]) <= set(PHASE_LABELS)
        assert all(isinstance(v, float) and v >= 0.0
                   for v in rec["device-ms"].values())
        assert rec["device-source"] == jrec["device-source"] == "timed"
        assert rec["device-s"] > 0.0
        assert "dev[" in render_chunk_line(rec)


def test_results_device_rollup_schema(profiled_runs):
    tres, jres, run_dir, _ = profiled_runs
    dev = tres["perf"]["phases"]["device"]
    jdev = jres["perf"]["phases"]["device"]
    assert set(dev) == set(jdev)
    assert set(dev["per-phase-ms-per-tick"]) == \
        set(jdev["per-phase-ms-per-tick"])
    assert (dev["mode"], dev["source"], dev["captured-chunks"]) == \
        (jdev["mode"], jdev["source"], jdev["captured-chunks"]) == \
        ("on", "timed", 3)
    per = dev["per-phase-ms-per-tick"]
    assert dev["ms-per-tick"] > 0.0
    assert abs(sum(per.values()) - dev["ms-per-tick"]) \
        <= 0.05 * dev["ms-per-tick"] + 1e-3
    with open(os.path.join(run_dir, "results.json")) as f:
        stored = json.load(f)
    assert stored["perf"]["phases"]["device"] == json.loads(json.dumps(dev))


def test_render_chunk_line_matches_jax(profiled_runs):
    _, _, run_dir, _ = profiled_runs
    for rec in _chunks(run_dir):
        assert render_chunk_line(rec) == jrender(rec)


def test_profile_cli_matches_jax(profiled_runs):
    _, _, run_dir, copy = profiled_runs
    rc, out, _ = _cli(main, "profile", run_dir)
    jrc, jout, _ = _cli(jcli.main, "profile", copy)
    assert rc == jrc == 0
    assert out.replace(run_dir, "RUN") == jout.replace(copy, "RUN")
    assert "hot scope:" in out and "ms/tick" in out
    # a dir with no device time exits 2, with JAX's message
    parent = os.path.dirname(run_dir)
    rc, out, err = _cli(main, "profile", parent)
    jrc, _, jerr = _cli(jcli.main, "profile", parent)
    assert rc == jrc == 2 and out == ""
    assert err == jerr
    assert not torch.cuda.is_initialized()


def test_profile_off_leaves_no_lanes(tmp_path):
    res = harness.run_torch_test(EchoModel(), dict(
        OPTS, time_limit=0.1, store_root=str(tmp_path),
        device_profile="off"),
        device="cpu")
    assert "device" not in res["perf"]["phases"]
    assert not any(c.get("device-ms") for c in _chunks(res["store-dir"]))
    assert render_profile_report(res["store-dir"]) is None


# --- the two sources ---------------------------------------------------------

def test_timed_source_sums_to_measured_wall():
    """The timed source splits the measured wall of the issue by the
    tick's operator shares: the per-phase sum is the recorded wall, and
    the recorded wall is a real measurement of this chunk, within the
    wall measured around the capture."""
    import time

    model = EchoModel()
    sim = harness.make_sim_config(model, OPTS)
    prof = DeviceProfiler("on", model=model, sim=sim, device=CPU)
    assert not prof._try_trace
    from maelstrom_tpu_torch.runtime import make_tick_fn
    tick = make_tick_fn(model, sim, device=CPU)

    def chunk(carry, t0, n):
        for t in range(t0, t0 + n):
            carry, _ = tick(carry, t)
        return carry

    carry = init_carry(model, sim, 3, CPU)
    with torch.no_grad():
        carry, warm = prof.capture(chunk, (carry, 0, 20), 20)
        t0 = time.monotonic()
        carry, rec = prof.capture(chunk, (carry, 20, 20), 20)
        external_ms = (time.monotonic() - t0) * 1000.0
    assert rec["source"] == "timed" and rec["ticks"] == 20
    measured = rec["device-s"] * 1000.0
    assert measured > 0
    assert abs(sum(rec["per-phase-ms"].values()) - measured) \
        <= 0.001 * measured + 1e-3
    assert measured <= external_ms + 1e-6
    assert set(rec["per-phase-ms"]) == set(phase_weights(model, sim))


@pytest.mark.parametrize("case", ["echo", "echo-device-lanes",
                                  "echo-fault-plan"])
def test_phase_weights_cover_the_ticks_phases(case):
    """The timed source's weights are a partition over exactly the phases
    the configuration's tick runs: the phases of the JAX cost model's
    trace of the same tick."""
    opts = dict(ECHO_OPTS)
    if case == "echo-device-lanes":
        opts["check_mode"] = "device"
    if case == "echo-fault-plan":
        opts["fault_plan"] = {"phases": [{"until": 100, "crash": [0]}]}
    model = EchoModel()
    w = phase_weights(model, harness.make_sim_config(model, opts))
    assert abs(sum(w.values()) - 1.0) < 1e-9
    jm = JEcho()
    want = jprofiler.phase_weights(jm, jmake_sim_config(jm, opts))
    assert set(w) == set(want)
    assert ("check_summary" in w) == (case == "echo-device-lanes")
    assert ("faults" in w) == (case == "echo-fault-plan")
    assert profiler.hot_scope(w) is not None


def _host_marks(monkeypatch):
    """The marks source on the host clock (the card's events are not
    here): the marks' teardown and sums without a card."""
    monkeypatch.setenv("MAELSTROM_DEVICE_TRACE", "1")
    monkeypatch.setattr(profiler, "_TRACE_FAILED", [False])
    monkeypatch.setattr(profiler, "_new_marks",
                        lambda devs: profiler._Marks(devs, host_clock=True))


def test_capture_teardown_on_exception(monkeypatch):
    """A chunk that raises mid-capture propagates, and leaves no armed
    marks and no current phase behind: the next capture is clean."""
    _host_marks(monkeypatch)
    prof = DeviceProfiler("on")
    assert prof._try_trace

    class Boom(Exception):
        pass

    def bad_fn():
        with phase("node_phase"):
            raise Boom

    with pytest.raises(Boom):
        prof.capture(bad_fn, (), 1)
    assert profiler._MARKS[0] is None
    assert profiler._CURRENT[0] == "other"
    assert not prof.records

    def fn(x):
        with phase("deliver"):
            x = x * 2
        with phase("node_phase"):
            x = x + 1
        return x

    out, rec = prof.capture(fn, (torch.ones(64),), 2)
    assert float(out.sum()) == 192.0
    assert rec["source"] == "trace"
    assert {"deliver", "node_phase", "other"} == set(rec["per-phase-ms"])
    assert abs(sum(rec["per-phase-ms"].values())
               - rec["device-s"] * 1000.0) <= 1.2e-2
    assert profiler._MARKS[0] is None


def test_trace_failure_latches_to_timed(monkeypatch):
    """A forced trace attempt without a card (no CUDA events to record)
    falls back to the timed source, latches the process-wide flag, and
    still records the measured wall; a later profiler does not try
    again."""
    monkeypatch.setenv("MAELSTROM_DEVICE_TRACE", "1")
    monkeypatch.setattr(profiler, "_TRACE_FAILED", [False])
    prof = DeviceProfiler("on")
    out, rec = prof.capture(lambda x: torch.sum(x * 2.0),
                            (torch.ones(64),), 4)
    assert float(out) == 128.0
    assert rec["source"] == "timed" and rec["device-s"] >= 0.0
    assert profiler._TRACE_FAILED[0]

    def no_attempt(devs):
        raise AssertionError("the latch was not honoured")

    monkeypatch.setattr(profiler, "_new_marks", no_attempt)
    _, rec = DeviceProfiler("on").capture(lambda: 1, (), 1)
    assert rec["source"] == "timed"
    monkeypatch.setenv("MAELSTROM_DEVICE_TRACE", "0")
    assert not DeviceProfiler("on", device="cuda")._try_trace


# --- campaigns ---------------------------------------------------------------

def test_campaign_device_columns_match_jax(tmp_path):
    """A port-written campaign of one profiled echo item: its report's
    and status table's device columns equal the JAX report's on the same
    campaign dir."""
    spec = {"name": "prof", "items": [
        dict(OPTS, time_limit=0.1, workload="echo", check_workers=0,
             heartbeat=True, device_profile="on")]}
    cdir = cqueue.submit_campaign(spec, str(tmp_path))
    summary = run_campaign(cdir, log=lambda *a, **k: None, device="cpu")
    assert summary["done"] == 1
    rep = campaign_report(cdir, static_cost=False, write=False)
    want = jreport(cdir, static_cost=False, write=False)
    row, jrow = rep["items"][0], want["items"][0]
    assert row["device-ms-per-tick"] == jrow["device-ms-per-tick"] > 0
    assert row["device-phases"] == jrow["device-phases"]
    for k in ("device-ms-per-tick-mean", "device-phases-mean"):
        assert rep["trends"]["echo"][k] == want["trends"]["echo"][k]
    assert rep["trends"]["echo"]["device-phases-mean"]
    dev_lines = lambda text: [ln for ln in text.splitlines()
                              if "device ms/tick" in ln]
    assert dev_lines(render_report(rep)) == dev_lines(jrender_report(want))
    assert dev_lines(render_report(rep))
    status, jst = campaign_status(cdir), jstatus(cdir)
    assert status["items"][0]["live"]["device-hot"] == \
        jst["items"][0]["live"]["device-hot"]
    assert render_status(status) == jrender_status(jst)
    assert "dev[" in render_status(status)
    assert jqueue.load_campaign(cdir)["n-items"] == 1
