"""The port's static cost model (``maelstrom_tpu_torch/analysis/
cost_model.py``) and its cost gate (``ir_lint.compare_costs``) against
the JAX package's.

- **Cost gate parity.** On the same synthetic reports and baselines,
  the port's ``compare_costs`` gives JAX's findings: the same rule,
  severity, symbol and message for COST501 (above 10%, and clean within
  it), COST502, COST503 (only on the full universe), COST504 and
  COST505; the baseline io round-trips, and ``lint --cost
  --update-baseline`` re-records a file the gate then passes.
- **Phase coverage.** For every registered model in both carry layouts
  the phases with operators (over the tick variants) are the JAX scopes
  (``KNOWN_SCOPES``) with equations in its jaxpr of the same model and
  layout.
- **The trace cache.** One cache holds a lead and a minor sim's graphs
  apart: the minor tick's cost from it is a fresh cache's.
- **Consistency with the profiler.** The cost pass's per-phase
  operator counts at tick 0 equal ``telemetry/profiler.
  phase_op_counts``, an independent count of the operators the eager
  tick dispatches (no functionalization, no write-back dropped).
- **Tick variants.** A nemesis config's heal, partition and final-read
  ticks are traced apart; the partition tick counts more operators
  than the heal tick; a scripted schedule gives one variant per phase.
- **The consumers.** The bench line's static fields on a small sim,
  ``BENCH_LANES=0`` and a failing trace, and on a minor sim its own
  tick's lanes and ranges; ``profile_tick.static_ops``.

Sizes: the lint's audit config (four instances a model). Exact counts.
"""

import json

import pytest
import torch

from maelstrom_tpu.analysis import cost_model as jcost
from maelstrom_tpu.analysis import ir_lint as jir
from maelstrom_tpu.models import get_model as jget_model
from maelstrom_tpu_torch import harness
from maelstrom_tpu_torch.__main__ import main as cli
from maelstrom_tpu_torch.analysis import cost_model, ir_lint
from maelstrom_tpu_torch.models import get_model
from maelstrom_tpu_torch.telemetry import profiler

from torch_static_cases import static_traces  # noqa: F401 (fixture)
from torch_tutorial_cases import one_torch_thread  # noqa: F401 (autouse)

SPECS = cost_model.cost_specs()
# every registered model x layout: the lead cases keep their ids
LAYOUT_SPECS = [(wl, n, lay) for lay in cost_model.AUDIT_LAYOUTS
                for wl, n in SPECS]
LAYOUT_IDS = [f"{wl}-{n}" + ("" if lay == "lead" else f"-{lay}")
              for wl, n, lay in LAYOUT_SPECS]


@pytest.fixture(scope="module")
def traces(static_traces):
    """One trace of every registered model's tick variants, shared by
    the file's tests and the other static-pass test files
    (``torch_static_cases``; the lint's own cache convention)."""
    return static_traces


def _report(traces, wl, n, layout="lead"):
    model = get_model(wl, n, "grid")
    sim = cost_model.audit_sim(model, n, layout)
    return model, sim, cost_model.cost_of_variants(
        cost_model.trace_variants(model, sim, cache=traces))


# --- the cost gate ------------------------------------------------------------


def _pair(eqns, hbm, phases=None, unattributed=0, unknown=()):
    """The same synthetic live report in both packages."""
    kw = dict(eqns=eqns, hbm_bytes=hbm, phases=phases or {"node_phase":
                                                          eqns},
              unattributed_eqns=unattributed, unknown_scopes=unknown)
    return jcost.CostReport(**kw), cost_model.CostReport(**kw)


def _entry(eqns, hbm, phases=None, unattributed=None):
    e = {"eqns": eqns, "hbm-bytes-per-tick": hbm,
         "phases": phases or {"node_phase": eqns}}
    if unattributed is not None:
        e["unattributed-eqns"] = unattributed
    return e


def _view(findings):
    return [(f.rule, f.severity, f.symbol, f.message) for f in findings]


GATE_CASES = {
    # key: (live reports {key: args}, baseline entries, full universe,
    #       expected rules)
    "regression-above-10%": ({"m/n=1/lead": (1200, 100)},
                             {"m/n=1/lead": _entry(1000, 100)}, True,
                             ["COST501"]),
    "bytes-regression": ({"m/n=1/lead": (1000, 130, {"enqueue": 1000})},
                         {"m/n=1/lead": _entry(1000, 100)}, True,
                         ["COST501"]),
    "within-10%": ({"m/n=1/lead": (1090, 109)},
                   {"m/n=1/lead": _entry(1000, 100)}, True, []),
    "missing": ({"m/n=1/lead": (10, 10), "k/n=2/lead": (10, 10)},
                {"m/n=1/lead": _entry(10, 10)}, True, ["COST502"]),
    "stale-full": ({"m/n=1/lead": (10, 10)},
                   {"m/n=1/lead": _entry(10, 10), "gone/n=3/lead":
                    _entry(5, 5)}, True, ["COST503"]),
    "stale-restricted": ({"m/n=1/lead": (10, 10)},
                         {"m/n=1/lead": _entry(10, 10), "gone/n=3/lead":
                          _entry(5, 5)}, False, []),
    "improvement": ({"m/n=1/lead": (800, 90)},
                    {"m/n=1/lead": _entry(1000, 100)}, True, ["COST504"]),
    "scope-coverage": ({"m/n=1/lead": (1000, 100, None, 40, ("nemsis",))},
                       {"m/n=1/lead": _entry(1000, 100, unattributed=2)},
                       True, ["COST505"]),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_compare_costs_matches_jax(case):
    live_args, entries, full, rules = GATE_CASES[case]
    jlive, tlive, paths = {}, {}, {}
    for key, args in live_args.items():
        jlive[key], tlive[key] = _pair(*args)
        paths[key] = ("models/m.py", "M")
    baseline = {"version": 1, "tolerance": 0.10, "entries": entries}
    want = jir.compare_costs(jlive, baseline, paths, full_universe=full)
    got = ir_lint.compare_costs(tlive, baseline, paths, full_universe=full)
    assert sorted(f.rule for f in got) == rules
    assert _view(got) == _view(want)


def test_toolchain_drift_downgrades_to_a_warning():
    _, live = _pair(1200, 100)
    baseline = {"torch-version": "0.0.1", "tolerance": 0.10,
                "entries": {"m/n=1/lead": _entry(1000, 100)}}
    (f,) = ir_lint.compare_costs({"m/n=1/lead": live}, baseline,
                                 {"m/n=1/lead": ("m.py", "M")})
    assert f.rule == "COST501" and f.severity == "warning"
    assert "recorded under torch 0.0.1" in f.message
    baseline["torch-version"] = cost_model.toolchain()
    (f,) = ir_lint.compare_costs({"m/n=1/lead": live}, baseline,
                                 {"m/n=1/lead": ("m.py", "M")})
    assert f.severity == "error"


def test_baseline_io_roundtrip(tmp_path):
    path = str(tmp_path / "cost.json")
    _, rep = _pair(10, 20, {"deliver": 4, "other": 6}, 6)
    entries = {"echo/n=2/lead": rep.to_entry()}
    cost_model.save_cost_baseline(entries, path)
    data = cost_model.load_cost_baseline(path)
    assert data["entries"] == entries
    assert data["tolerance"] == cost_model.DEFAULT_TOLERANCE
    assert data["torch-version"] == cost_model.toolchain()
    assert set(entries["echo/n=2/lead"]) == {
        "eqns", "hbm-bytes-per-tick", "fusion-breakers",
        "unattributed-eqns", "phases", "variants"}
    missing = cost_model.load_cost_baseline(str(tmp_path / "none.json"))
    assert missing["entries"] == {}


def test_update_baseline_roundtrips_through_the_cli(tmp_path, monkeypatch,
                                                    capsys):
    """``lint --cost --update-baseline`` records every model of the
    universe; the gate on the recorded file is clean."""
    monkeypatch.setattr(cost_model, "cost_specs",
                        lambda: [("echo", 2), ("unique-ids", 3)])
    path = str(tmp_path / "cost.json")
    assert cli(["lint", "--json", "--update-baseline", "--cost-baseline",
                path]) == 0
    out = json.loads(capsys.readouterr().out)
    assert [f["rule"] for f in out["findings"]] == ["COST500"]
    assert sorted(cost_model.load_cost_baseline(path)["entries"]) == \
        ["echo/n=2/lead", "echo/n=2/minor", "unique-ids/n=3/lead",
         "unique-ids/n=3/minor"]
    assert cli(["lint", "--json", "--strict", "--cost", "--cost-baseline",
                path]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["passes"] == ["cost"] and out["findings"] == []


def test_checked_in_baseline_covers_the_registry():
    entries = cost_model.load_cost_baseline()["entries"]
    assert sorted(entries) == sorted(
        cost_model.entry_key(wl, n, lay) for wl, n, lay in LAYOUT_SPECS)
    for e in entries.values():
        assert e["fusion-breakers"] == 0 and e["eqns"] > 0
        assert e["eqns"] == max(e["variants"].values())


# --- phase coverage and the profiler ------------------------------------------


@pytest.mark.parametrize("wl,n,layout", LAYOUT_SPECS, ids=LAYOUT_IDS)
def test_phase_coverage_matches_jax_scopes(traces, wl, n, layout):
    _, _, rep = _report(traces, wl, n, layout)
    jm = jget_model(wl, n, "grid")
    jrep = jcost.tick_cost(jm, jcost.audit_sim(jm, n, layout))
    mine = {s for s, c in rep.scopes.items()
            if s in cost_model.KNOWN_SCOPES and c}
    theirs = {s for s, c in jrep.scopes.items()
              if s in jcost.KNOWN_SCOPES and c}
    assert mine == theirs
    assert rep.loops == 0 and rep.unknown_scopes == ()
    assert rep.eqns == sum(rep.phases.values())


def test_trace_cache_keeps_the_layouts_apart(traces):
    """A cache shared across layouts, as the lint's is: lin-kv's minor
    tick read from it costs what a fresh cache's does, and not what the
    lead tick costs."""
    model = get_model("lin-kv", 5, "grid")
    lead, minor = (cost_model.audit_sim(model, 5, lay)
                   for lay in ("lead", "minor"))
    lead_cost = cost_model.tick_cost(model, lead, cache=traces)
    shared = cost_model.tick_cost(model, minor, cache=traces)
    fresh = cost_model.tick_cost(model, minor, cache={})
    assert shared.to_entry() == fresh.to_entry()
    assert shared.to_entry() != lead_cost.to_entry()
    assert shared.eqns != lead_cost.eqns


# the profiler check on one model of each family (the phase check above
# covers every model)
PROFILER_SPECS = [("echo", 2), ("unique-ids", 3), ("broadcast", 5),
                  ("g-counter", 3), ("lin-kv", 5), ("txn-list-append", 3),
                  ("kafka", 1), ("lin-kv-bug-stale-read", 5)]


@pytest.mark.parametrize("wl,n", PROFILER_SPECS,
                         ids=[f"{wl}-{n}" for wl, n in PROFILER_SPECS])
def test_phase_counts_equal_the_profilers(traces, wl, n):
    model = get_model(wl, n, "grid")
    sim = cost_model.audit_sim(model, n)
    rep = cost_model.cost_of_graph(cost_model.trace_tick(
        model, sim, 0, cache=traces, variant="heal"))
    mine = {(s or "other"): c for s, c in rep.scopes.items()}
    assert mine == profiler.phase_op_counts(model, sim)


# --- tick variants ------------------------------------------------------------


NEMESIS_OPTS = dict(node_count=3, concurrency=2, time_limit=1.0, rate=50.0,
                    latency=5.0, n_instances=4, record_instances=2,
                    nemesis=["partition"], nemesis_interval=0.2,
                    recovery_time=0.3)


def test_nemesis_variants_heal_partition_final():
    model = get_model("lin-kv", 3, "grid")
    sim = harness.make_sim_config(model, NEMESIS_OPTS)
    variants = cost_model.tick_variants(sim)
    assert variants == {"heal": 0, "partition": 200,
                        "final": sim.client.final_start}
    assert sim.client.final_start >= sim.nemesis.stop_tick
    for t, name in ((0, "heal"), (199, "heal"), (200, "partition"),
                    (399, "partition"), (400, "heal"), (600, "partition"),
                    (sim.nemesis.stop_tick, "heal"),
                    (sim.client.final_start, "final")):
        assert cost_model.variant_tick(sim, t) == name, t
    rep = cost_model.tick_cost(model, sim)
    assert rep.variants["partition"] > rep.variants["heal"]
    assert rep.variant == "partition" and rep.eqns == rep.variants[
        "partition"]
    # the grudge draws are the nemesis phase's
    heal = cost_model.cost_of_graph(cost_model.trace_tick(model, sim, 0))
    part = cost_model.cost_of_graph(cost_model.trace_tick(model, sim, 200))
    assert part.phases["nemesis"] > heal.phases["nemesis"]
    assert {k: v for k, v in part.phases.items() if k != "nemesis"} == \
        {k: v for k, v in heal.phases.items() if k != "nemesis"}


def test_scripted_schedule_gives_one_variant_per_phase():
    from maelstrom_tpu_torch import fleets
    model = get_model("lin-kv-bug-no-term-guard", 5, "grid")
    sched = fleets.rotating_majorities(5, 50, 150)
    sim = harness.make_sim_config(model, dict(
        NEMESIS_OPTS, node_count=5, time_limit=0.3, recovery_time=0.05,
        nemesis_kind="scripted", nemesis_schedule=sched))
    variants = cost_model.tick_variants(sim)
    assert list(variants)[:3] == ["scripted-0", "scripted-1", "scripted-2"]
    assert [variants[f"scripted-{i}"] for i in range(3)] == [0, 50, 100]
    assert cost_model.variant_tick(sim, 75) == "scripted-1"


# --- the consumers ------------------------------------------------------------


def _small_bench_sim(layout="lead"):
    from maelstrom_tpu_torch import fleets
    model, opts = fleets.fleet("lin-kv")
    opts.update(n_instances=8, time_limit=1.0, layout=layout)
    return model, harness.make_sim_config(model, opts)


def test_bench_static_fields(monkeypatch):
    from maelstrom_tpu_torch import bench
    model, sim = _small_bench_sim()
    f = bench.static_fields(model, sim)
    assert f["ir_eqns"] == cost_model.tick_cost(model, sim).eqns
    assert all(isinstance(f[k], int) for k in f)
    assert f["lanes_live"] + f["lanes_dead"] == sim.net.lanes
    # the range field has its own test (test_torch_ranges.py); the runs
    # below check the cost fields without its fixed points
    monkeypatch.setenv("BENCH_RANGES", "0")
    monkeypatch.setenv("BENCH_LANES", "0")
    f0 = bench.static_fields(model, sim)
    assert f0["lanes_live"] is None and f0["ir_eqns"] == f["ir_eqns"]

    def broken(*a, **k):
        raise RuntimeError("no trace")
    monkeypatch.setattr(cost_model, "tick_cost", broken)
    assert bench.static_fields(model, sim)["ir_eqns"] is None


def test_bench_static_fields_of_a_minor_sim(monkeypatch):
    """A minor sim's lanes and ranges fields are those of its own tick,
    and no lead graph is recorded for them. The passes' own run below
    reads the graphs the bench recorded (one recording per variant)."""
    from maelstrom_tpu_torch import bench
    from maelstrom_tpu_torch.analysis import absint, lane_liveness
    model, sim = _small_bench_sim("minor")
    recorded, graphs = [], {}
    record_tick = cost_model.record_tick

    def spy(model, sim, t):
        recorded.append(sim.layout)
        if t not in graphs:
            graphs[t] = record_tick(model, sim, t)
        return graphs[t]
    monkeypatch.setattr(cost_model, "record_tick", spy)
    f = bench.static_fields(model, sim)
    assert recorded and set(recorded) == {"minor"}
    n = sim.net.n_nodes
    cache: dict = {}
    lanes = lane_liveness.analyze_model(model, n, "minor", sim=sim,
                                        trace_cache=cache)
    ranges = absint.analyze_model(model, n, "minor", sim=sim,
                                  trace_cache=cache)
    assert f["lanes_live"] == len(lanes.live_lanes)
    assert f["lanes_dead"] == lanes.lanes - len(lanes.live_lanes)
    assert f["lanes_dead_bytes"] == lanes.dead_bytes_est
    assert f["ovf_margin_bits"] == ranges.ovf_margin_bits
    assert None not in (f["lanes_live"], f["ovf_margin_bits"])
    assert set(recorded) == {"minor"}


def test_profile_tick_static_ops():
    from maelstrom_tpu_torch import profile_tick
    model, sim = _small_bench_sim()
    st = profile_tick.static_ops(model, sim, 410)
    assert st["variant"] == "partition"
    assert set(st["phases"]) == set(profile_tick.PHASES) | {"other"}
    assert sum(st["phases"].values()) == st["ops_per_tick"]
    assert st["ops_per_tick"] == cost_model.tick_cost(
        model, sim).variants["partition"]


def _check_meta_memo(wl, n, layout, monkeypatch):
    """Record the model's tick at t=0 twice with an empty memo, the
    second time computing each memoised output's meta version beside it;
    then without the memo. Returns how many memoised outputs were
    checked."""
    model = get_model(wl, n, "grid")
    sim = cost_model.audit_sim(model, n, layout)
    monkeypatch.setattr(cost_model, "_META_OUTS", {})
    cost_model.record_tick(model, sim, 0)
    real = cost_model._meta_key
    checked = []

    def checking(func, args, kwargs):
        key = real(func, args, kwargs)
        hit = cost_model._META_OUTS.get(key) if key is not None else None
        if hit is not None:
            ref = func(*args, **kwargs)
            assert hit == (ref.shape, ref.stride(), ref.dtype), func
            checked.append(func)
        return key
    monkeypatch.setattr(cost_model, "_meta_key", checking)
    g = cost_model.record_tick(model, sim, 0)
    monkeypatch.setattr(cost_model, "_meta_key",
                        lambda func, args, kwargs: None)
    plain = cost_model.record_tick(model, sim, 0)
    assert [n.name for n in g.nodes] == [n.name for n in plain.nodes]
    assert [(v.shape, v.dtype) for v in g.values] == \
        [(v.shape, v.dtype) for v in plain.values]
    return len(checked)


@pytest.mark.parametrize("layout", cost_model.AUDIT_LAYOUTS)
def test_memoised_meta_outputs_equal_the_meta_versions(layout, monkeypatch):
    """The recorder memoises a pointwise operator's meta output: in
    lin-kv's tick every memoised output has the meta version's shape,
    strides and dtype, and the graph is the one recorded without the
    memo."""
    assert _check_meta_memo("lin-kv", 5, layout, monkeypatch) > 1000


@pytest.mark.slow
@pytest.mark.parametrize("wl,n,layout", [
    (wl, n, lay) for wl, n in cost_model.cost_specs()
    for lay in cost_model.AUDIT_LAYOUTS if (wl, n) != ("lin-kv", 5)],
    ids=str)
def test_memoised_meta_outputs_of_every_model(wl, n, layout, monkeypatch):
    """As above for every other registered model x layout."""
    assert _check_meta_memo(wl, n, layout, monkeypatch) > 0


def test_recording_touches_no_device():
    """The trace runs on meta tensors: no CUDA context, no tensor with
    values on any device."""
    model = get_model("echo", 2, "grid")
    g = cost_model.record_tick(model, cost_model.audit_sim(model, 2), 0)
    assert g.nodes and not torch.cuda.is_initialized()
