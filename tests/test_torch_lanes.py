"""The port's lane-liveness pass (``maelstrom_tpu_torch/analysis/
lane_liveness.py``) against the live JAX analyzer
(``maelstrom_tpu/analysis/lane_liveness.py``).

- **Parity.** For every registered model (``cost_specs()``) in both
  carry layouts, with the same audit options, the port's live header
  lanes, live and dead body lanes, dead carry leaves, dead stores and
  resolution equal JAX's ``analyze_model(model, n, layout)``.
- **Fixtures.** Each lane fixture of ``models/ir_hazards.py`` trips its
  rule as ``tests/test_analysis_lanes.py:49-134`` asserts for JAX's
  (LNE601/602 on the dead lanes and leaves, LNE603 on the dead store,
  LNE604 as an error on the overread), an index read from message data
  widens the model to all-live (LNE605), and echo resolves exactly.
- **Manifest.** Round trip, drift, missing and stale entries, the
  toolchain downgrade, and ``lint --lanes --update-manifest`` through
  the CLI; the checked-in manifest covers the registry.
- **Narrowing.** Narrowing ``IrDeadLane``'s ``body_lanes`` to its live
  set leaves the port's trajectory bit-identical (events, stats,
  violations, the live lanes of the pool), as
  ``tests/test_analysis_lanes.py:321-377`` asserts for JAX.

Sizes: the lint's audit config; the narrowing runs 16 instances for 100
ticks on the CPU. Exact sets.
"""

import json

import numpy as np
import pytest
import torch

from maelstrom_tpu.analysis import lane_liveness as jlanes
from maelstrom_tpu.models import get_model as jget_model
from maelstrom_tpu_torch import harness, runtime, wire
from maelstrom_tpu_torch.__main__ import main as cli
from maelstrom_tpu_torch.analysis import cost_model
from maelstrom_tpu_torch.analysis.lane_liveness import (
    LaneReport, analyze_model, compare_manifest, findings_of_report,
    lane_stats, load_lane_manifest, save_lane_manifest)
from maelstrom_tpu_torch.models import get_model
from maelstrom_tpu_torch.models.echo import EchoModel
from maelstrom_tpu_torch.models.ir_hazards import (LANE_FIXTURE_MODELS,
                                                   IrDeadLane, IrDeadStore,
                                                   IrLaneOverread)

from torch_static_cases import static_traces  # noqa: F401 (fixture)
from torch_tutorial_cases import one_torch_thread  # noqa: F401 (autouse)

SPECS = cost_model.cost_specs()
# every registered model x layout: the lead cases keep their ids
LAYOUT_SPECS = [(wl, n, lay) for lay in cost_model.AUDIT_LAYOUTS
                for wl, n in SPECS]
FIELDS = ("live_header_lanes", "live_body_lanes", "dead_body_lanes",
          "dead_carry_leaves", "dead_stores", "resolution")


def _rules(findings):
    return {f.rule for f in findings}


# --- parity with the live JAX analyzer ----------------------------------------


# in reverse order: test_torch_cost.py walks the registry forward, lead
# then minor, so under xdist each file loads the graphs the other
# recorded once they meet (torch_static_cases)
@pytest.mark.parametrize(
    "wl,n,layout", LAYOUT_SPECS[::-1],
    ids=[f"{wl}-{n}" + ("" if lay == "lead" else f"-{lay}")
         for wl, n, lay in LAYOUT_SPECS[::-1]])
def test_lanes_equal_the_jax_analyzer(wl, n, layout, static_traces):
    mine = analyze_model(get_model(wl, n, "grid"), n, layout,
                         trace_cache=static_traces).to_entry()
    theirs = jlanes.analyze_model(jget_model(wl, n, "grid"), n,
                                  layout).to_entry()
    assert {k: mine[k] for k in FIELDS} == {k: theirs[k] for k in FIELDS}


# --- the fixtures trip their rules ------------------------------------------


def test_dead_lane_trips_lne601_and_602():
    rep = analyze_model(IrDeadLane(), 2, "lead")
    fs = findings_of_report(IrDeadLane(), rep)
    assert {"LNE601", "LNE602"} <= _rules(fs)
    assert not rep.conservative
    assert rep.live_body_lanes == [0]
    assert rep.dead_body_lanes == [1, 2, 3]
    assert rep.dead_bytes_est > 0
    dead = set(rep.dead_carry_leaves)
    assert any("seen" in p for p in dead)
    assert any("ballast" in p for p in dead)


def test_dead_store_trips_lne603():
    rep = analyze_model(IrDeadStore(), 2, "lead")
    fs = findings_of_report(IrDeadStore(), rep)
    assert "LNE603" in _rules(fs)
    assert (wire.BODY + 1, "node_phase") in rep.dead_stores
    assert 1 in rep.dead_body_lanes


def test_lane_overread_trips_lne604_as_error():
    rep = analyze_model(IrLaneOverread(), 2, "lead")
    fs = findings_of_report(IrLaneOverread(), rep)
    overreads = [f for f in fs if f.rule == "LNE604"]
    assert overreads and all(f.severity == "error" for f in overreads)
    assert rep.lanes in {lane for lane, _ in rep.overreads}


def test_unresolvable_index_falls_back_conservative():
    """LNE605: a lane index computed from message data cannot be
    resolved statically — the model widens to all-live."""

    class DataIndexed(EchoModel):
        name = "echo-data-indexed"

        def handle(self, row, node_idx, msg, t, keys, cfg, params):
            row, out = super().handle(row, node_idx, msg, t, keys, cfg,
                                      params)
            lane = (msg[:, wire.BODY:wire.BODY + 1] % cfg.lanes).long()
            out[:, 0, wire.BODY] += msg.gather(1, lane)[:, 0] * 0
            return row, out

    rep = analyze_model(DataIndexed(), 2, "lead")
    assert rep.conservative
    assert rep.live_lanes == set(range(rep.lanes))
    assert _rules(findings_of_report(DataIndexed(), rep)) == {"LNE605"}
    assert not rep.dead_body_lanes


def test_honest_echo_is_exact():
    rep = analyze_model(get_model("echo", 2), 2, "lead")
    assert not rep.conservative, rep.notes
    assert not rep.overreads
    assert rep.live_body_lanes == [0]


def test_fixtures_never_registered():
    for kind in LANE_FIXTURE_MODELS:
        with pytest.raises(ValueError):
            get_model(f"echo-ir-{kind}", 2)


# --- manifest io + drift gate ----------------------------------------------


def _fake_report(**kw):
    defaults = dict(label="echo/n=2/lead", lanes=10, body_lanes=2,
                    live_lanes=set(range(8)) | {wire.BODY})
    defaults.update(kw)
    return LaneReport(**defaults)


def test_manifest_roundtrip_and_gate(tmp_path):
    rep = _fake_report()
    path = str(tmp_path / "m.json")
    save_lane_manifest({"echo/n=2/lead": rep.to_entry()}, path)
    manifest = load_lane_manifest(path)
    assert manifest["torch-version"] == cost_model.toolchain()
    entry = manifest["entries"]["echo/n=2/lead"]
    assert entry["live_body_lanes"] == [0]
    assert entry["dead_body_lanes"] == [1]
    assert entry["resolution"] == "exact"
    paths = {"echo/n=2/lead": ("p.py", "EchoModel")}
    assert compare_manifest({"echo/n=2/lead": rep}, manifest, paths) == []
    # drift: a lane went live
    wide = _fake_report(live_lanes=set(range(10)))
    (f,) = compare_manifest({"echo/n=2/lead": wide}, manifest, paths)
    assert f.rule == "LNE606" and f.severity == "error"
    # under another torch the drift is a re-record warning
    old = dict(manifest, **{"torch-version": "0.0.1"})
    (f,) = compare_manifest({"echo/n=2/lead": wide}, old, paths)
    assert f.severity == "warning" and "--update-manifest" in f.message
    # missing and stale
    other = _fake_report(label="g/n=3/lead")
    fs = compare_manifest({"g/n=3/lead": other}, manifest,
                          {"g/n=3/lead": ("g.py", "G")})
    assert sorted(f.rule for f in fs) == ["LNE607", "LNE608"]
    fs = compare_manifest({"g/n=3/lead": other}, manifest,
                          {"g/n=3/lead": ("g.py", "G")},
                          full_universe=False)
    assert [f.rule for f in fs] == ["LNE607"]
    fs = compare_manifest({}, manifest, {}, errored={"echo/n=2/lead"})
    assert fs == []


def test_update_manifest_roundtrips_through_the_cli(tmp_path, monkeypatch,
                                                    capsys):
    from maelstrom_tpu_torch.models import ir_hazards
    monkeypatch.setattr(cost_model, "cost_specs", lambda: [("echo", 2)])
    monkeypatch.setattr(ir_hazards, "LANE_FIXTURE_MODELS", {})
    path = str(tmp_path / "lanes.json")
    assert cli(["lint", "--json", "--update-manifest", "--lane-manifest",
                path]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["passes"] == ["lanes"]
    assert [f["rule"] for f in out["findings"]] == ["LNE600"]
    assert list(load_lane_manifest(path)["entries"]) == ["echo/n=2/lead",
                                                         "echo/n=2/minor"]
    assert cli(["lint", "--json", "--strict", "--lanes", "--lane-manifest",
                path]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["findings"] == []


def test_checked_in_manifest_covers_the_registry():
    entries = load_lane_manifest()["entries"]
    assert sorted(entries) == sorted(
        cost_model.entry_key(wl, n, lay) for wl, n, lay in LAYOUT_SPECS)
    assert all(e["resolution"] == "exact" for e in entries.values())


def test_lane_stats_of_a_run_config():
    model = get_model("echo", 2)
    sim = cost_model.audit_sim(model, 2)
    st = lane_stats(model, sim)
    assert st == {"lanes_live": 9, "lanes_dead": 1,
                  "lanes_dead_bytes": analyze_model(
                      model, 2).dead_bytes_est}


# --- the narrow-layout safety proof ------------------------------------------


def _run(model):
    opts = dict(node_count=2, concurrency=4, n_instances=16,
                record_instances=4, inbox_k=1, pool_slots=12,
                time_limit=0.1, rate=200.0, latency=5.0, rpc_timeout=1.0,
                nemesis=[], seed=11)
    sim = harness.make_sim_config(model, opts)
    carry, ys = runtime.run_sim(model, sim, opts["seed"],
                                torch.device("cpu"))
    return carry, ys


def test_narrowing_to_live_set_is_trajectory_preserving():
    wide = IrDeadLane()
    rep = analyze_model(wide, 2, "lead")
    assert not rep.conservative
    live = rep.live_body_lanes
    assert live == [0]
    narrow_cls = type("IrDeadLaneNarrow", (IrDeadLane,),
                      {"body_lanes": max(live) + 1})
    wide_c, wide_ys = _run(wide)
    nar_c, nar_ys = _run(narrow_cls())
    assert torch.equal(wide_ys.events, nar_ys.events)
    for name in ("stats", "violations"):
        a, b = getattr(wide_c, name), getattr(nar_c, name)
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y), name
    keep = list(range(wire.BODY)) + [wire.BODY + lane for lane in live]
    np.testing.assert_array_equal(wide_c.pool[..., keep].numpy(),
                                  nar_c.pool[..., keep].numpy())
    assert int(wide_c.stats.delivered) > 10


def test_dead_bytes_shrink_when_narrowed():
    wide_rep = analyze_model(IrDeadLane(), 2, "lead")
    narrow_cls = type("IrDeadLaneNarrow", (IrDeadLane,), {"body_lanes": 1})
    narrow_rep = analyze_model(narrow_cls(), 2, "lead")
    assert narrow_rep.ir_bytes_est < wide_rep.ir_bytes_est
    assert narrow_rep.dead_bytes_est < wide_rep.dead_bytes_est
