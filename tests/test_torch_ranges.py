"""The port's value-range pass (``maelstrom_tpu_torch/analysis/absint.py``)
against the JAX package's (``maelstrom_tpu/analysis/absint.py``).

The oracle is the live JAX analyzer with its ``jit`` equations routed
to the handlers ``absint.py:478`` gives ``pjit`` (and with them the lane
tagger's constant folding, which dispatches on the same name): jax 0.9
names the call primitive ``jit``. Unrouted, every ``jit`` output widens
to dtype-full and no model is proven (the four failing tests of
``tests/test_analysis_ranges.py``); routed in the interpreter alone, the
folding still cannot see through the ``jnp.where`` steps of
``jnp.power``'s pow-by-squaring (``2 ** arange(1, 16)`` at
``telemetry/recorder.py:102``) and reads their dead last product as an
int32 overflow at T = 1. Routed in both (the primitive named ``pjit``
for the test), live JAX reproduces the checked-in JAX manifest entries
(``test_routed_jax_reproduces_its_manifest``), so the tier-1 cases
compare the port with live JAX where it is cheap (the fixtures, echo)
and with those checked-in lead entries where it is not.

- **Fixtures.** Each range fixture gives the same rule, the same leaf or
  site, the same minimal overflowing T and the same ABS702 reason as
  JAX's fixture under live JAX.
- **Real models.** echo n=2 and lin-kv n=5 (every registered model in
  the ``slow`` sweep), in the lead layout against the checked-in JAX
  entry and in the minor one against live JAX (the checked-in minor
  entry in the sweep): ``proven``, ``max_safe_horizon_log2``,
  ``min_overflow_t``, ``scatter_race``, ``ovf_margin_bits`` and
  unique-ids' ``flake`` verdict equal the reference's; the counters are
  equal leaf for leaf except the leaves named in ``LEAF_CAUSES``, each
  with its cause and both values, in either layout.
- **Horizon refusal.** The port's ``make_sim_config`` and JAX's, on the
  same temporary manifest, refuse and let through the same horizons,
  name the model, let an unproven entry cap nothing, and read the
  minimum across entries; the audit config opts out.
- **Manifest gate.** Round trip, drift (ABS705), the toolchain
  downgrade, missing and stale entries (ABS706/707), ``--update-ranges``
  through the CLI, a tampered manifest, the synthetic 2^31 probe, and
  the checked-in manifest's coverage of the registry.
- **Soundness.** lin-kv and kafka run 200 ticks at the audit config on
  the CPU: every int32 carry leaf's observed min and max lies inside
  the pass's interval at T = 200.
- **The abstract t.** The recorder's ``TickInt`` turns ``8 + t % 4``
  into an expression the pass evaluates over ``[0, T)``.

Sizes: the lint's audit config (four instances a model).
"""

import json

import numpy as np
import pytest
import torch

from maelstrom_tpu.analysis import absint as jabsint
from maelstrom_tpu.models import get_model as jget_model
from maelstrom_tpu.models import ir_hazards as jhazards
from maelstrom_tpu_torch import harness, runtime
from maelstrom_tpu_torch.__main__ import main as cli
from maelstrom_tpu_torch.analysis import absint, cost_model
from maelstrom_tpu_torch.analysis.absint import (
    PRODUCTION_LOG2, RangeReport, analyze_model, compare_manifest,
    findings_of_report, load_range_manifest, proven_horizon_log2,
    run_range_lint, save_range_manifest)
from maelstrom_tpu_torch.analysis.findings import Baseline, fingerprint_pass
from maelstrom_tpu_torch.models import get_model
from maelstrom_tpu_torch.models.ir_hazards import (RANGE_FIXTURE_MODELS,
                                                   IrCounterOverflow,
                                                   IrOobGather,
                                                   IrScatterRace)

from torch_static_cases import static_traces  # noqa: F401 (fixture)
from torch_tutorial_cases import one_torch_thread  # noqa: F401 (autouse)

SPECS = cost_model.cost_specs()
# every registered model x layout: the lead cases keep their ids
LAYOUT_SPECS = [(wl, n, lay) for lay in cost_model.AUDIT_LAYOUTS
                for wl, n in SPECS]
VERDICT = ("proven", "max_safe_horizon_log2", "min_overflow_t",
           "scatter_race", "ovf_margin_bits")

_PARTITION = (
    "nemesis off under the audit config: the port's partition matrix is "
    "the constant all-false tensor its folding resolves, so part_active "
    "is 0 and the counter never moves; JAX's reduce_or transfer returns "
    "[0, 1] for any boolean output without reading its operand")
_LANES = (
    "JAX's composed-gather delivery hands the node phase inbox rows whose "
    "header lanes are joined (SRC reads like the MSGID and TYPE lanes), "
    "so a field copied from a message grows with them; the port's plain "
    "delivery gathers whole pool rows along the slot axis and each lane "
    "keeps its own range (SRC stays a node id)")
_SCAN = (
    "JAX walks the loop as a lax.scan whose abstract fixed point joins "
    "five trips before extrapolating by the length (+8 a tick where "
    "apply_max = 2 steps add 2); the port unrolls the loop, +2 a tick")
# leaf -> (port headroom bits, JAX headroom bits, cause), per model
LEAF_CAUSES = {
    "echo/n=2": {
        ".telemetry.nemesis_epochs": (26, 10, _PARTITION),
        ".telemetry.partition_ticks": (26, 10, _PARTITION),
    },
    "lin-kv/n=5": {
        ".telemetry.nemesis_epochs": (26, 10, _PARTITION),
        ".telemetry.partition_ticks": (26, 10, _PARTITION),
        ".node_state.leader_hint": (26, 10, _LANES),
        ".node_state.voted_for": (26, 10, _LANES),
        ".node_state.term": (10, 7, _LANES),
        ".node_state.log_term": (10, 7, _LANES),
        ".node_state.last_applied": (9, 7, _SCAN),
    },
}
_RAFT = LEAF_CAUSES["lin-kv/n=5"]
_TXN = {
    **{k: v for k, v in _RAFT.items() if k not in (".node_state.term",
                                                   ".node_state.log_term")},
    ".node_state.term": (7, 4, _LANES),
    ".node_state.log_term": (7, 4, _LANES),
    ".node_state.kv": (7, 4, _LANES + "; and " + _SCAN),
    ".node_state.log_body": (7, 4, _LANES + "; and " + _SCAN),
    ".pool": (6, 4, _LANES),
}
# the slow sweep's other models: the same three causes
for _wl, _n in SPECS:
    _key = f"{_wl}/n={_n}"
    if _key in LEAF_CAUSES:
        continue
    if _wl.startswith("lin-kv"):
        LEAF_CAUSES[_key] = _RAFT
    elif _wl == "txn-list-append" or _wl.startswith("txn-list-append-"):
        LEAF_CAUSES[_key] = _TXN
    elif _wl.startswith("txn-rw-register"):
        LEAF_CAUSES[_key] = {k: _RAFT[k] for k in (
            ".telemetry.nemesis_epochs", ".telemetry.partition_ticks",
            ".node_state.leader_hint", ".node_state.voted_for",
            ".node_state.last_applied")}
    else:
        LEAF_CAUSES[_key] = LEAF_CAUSES["echo/n=2"]

# unique-ids' flake: the verdict (bits, fits) is equal; the proven
# ceiling is not — JAX's lax.scan over the eight inbox slots
# (tpu/runtime.py:589-611) extrapolates the counter to +14 a tick, the
# port's eight unrolled handles add exactly 8
FLAKE_MAX = {"port": 8 * (1 << 20) + 320, "jax": 14 * (1 << 20) + 560}


@pytest.fixture
def jax_routed(monkeypatch):
    """Live JAX with ``jit`` routed as ``pjit`` (the primitive's name is
    what the analyzer and its tagger dispatch on)."""
    from jax._src import pjit
    monkeypatch.setattr(pjit.jit_p, "name", "pjit")


def _jax_manifest_entry(wl, n, layout="lead"):
    man = json.load(open(jabsint.DEFAULT_RANGE_MANIFEST))
    return man["entries"][f"{wl}/n={n}/{layout}"]


def _rules(findings):
    return {f.rule for f in findings}


def _compare(mine, ref, key):
    assert {k: mine[k] for k in VERDICT} == {k: ref[k] for k in VERDICT}
    diffs = {leaf: (mine["counters"].get(leaf), ref["counters"].get(leaf))
             for leaf in set(mine["counters"]) | set(ref["counters"])
             if mine["counters"].get(leaf) != ref["counters"].get(leaf)}
    named = {leaf: (p, j) for leaf, (p, j, _) in LEAF_CAUSES[key].items()}
    assert diffs == named, key
    if "flake" in ref:
        assert {k: mine["flake"][k] for k in ("bits", "fits")} == \
            {k: ref["flake"][k] for k in ("bits", "fits")}
        assert mine["flake"]["proven_counter_max"] == FLAKE_MAX["port"]
        assert ref["flake"]["proven_counter_max"] == FLAKE_MAX["jax"]


# --- the oracle --------------------------------------------------------------


def test_routed_jax_reproduces_its_manifest(jax_routed):
    """Routed, live JAX gives the checked-in JAX entry of echo n=2 field
    for field (lin-kv n=5 reproduces too: 14 s, left to the slow
    sweep's reference)."""
    theirs = jabsint.analyze_model(jget_model("echo", 2, "grid"), 2,
                                   "lead").to_entry()
    assert theirs == _jax_manifest_entry("echo", 2)


def test_unrouted_jax_proves_nothing():
    """Why the routing: unrouted, the ``jit`` equations are unmodeled
    and the proof is void."""
    rep = jabsint.analyze_model(jget_model("echo", 2, "grid"), 2, "lead")
    assert not rep.proven
    assert rep.notes == ["unmodeled primitive 'jit' — outputs widened to "
                         "dtype-full"]


# --- the fixtures ------------------------------------------------------------


def _both(kind, jax_routed):
    mine = analyze_model(RANGE_FIXTURE_MODELS[kind](), 2, "lead")
    theirs = jabsint.analyze_model(jhazards.RANGE_FIXTURE_MODELS[kind](),
                                   2, "lead")
    return mine, theirs


def test_counter_overflow_trips_abs701(jax_routed):
    mine, theirs = _both("counter-overflow", jax_routed)
    fs = findings_of_report(IrCounterOverflow(), mine)
    jfs = jabsint.findings_of_report(jhazards.IrCounterOverflow(), theirs)
    assert "ABS701" in _rules(fs) and "ABS701" in _rules(jfs)
    assert mine.max_safe_horizon_log2 == theirs.max_safe_horizon_log2 \
        == PRODUCTION_LOG2 - 1
    assert mine.min_overflow_t == theirs.min_overflow_t
    assert 0 < (1 << 20) - mine.min_overflow_t <= 64
    leaf = [s for s in mine.overflow_sites if s.get("kind") == "leaf"]
    jleaf = [s for s in theirs.overflow_sites if s.get("kind") == "leaf"]
    assert leaf[0] == jleaf[0]
    assert leaf[0]["leaf"] == ".node_state"
    msg = next(f for f in fs if f.rule == "ABS701").message
    assert str(mine.min_overflow_t) in msg and ".node_state" in msg


def test_scatter_race_trips_abs702(jax_routed):
    mine, theirs = _both("scatter-race", jax_routed)
    assert "ABS702" in _rules(findings_of_report(IrScatterRace(), mine))
    assert mine.race_status == theirs.race_status == "racing"
    whys = {s["why"] for s in mine.race_sites}
    assert whys == {s["why"] for s in theirs.race_sites} == \
        {"constant index rows contain duplicates"}
    assert {s["rows"] for s in mine.race_sites} == {3}
    # the race is the only defect: the counters still prove
    assert mine.max_safe_horizon_log2 == theirs.max_safe_horizon_log2 \
        >= PRODUCTION_LOG2


def test_oob_gather_trips_abs703(jax_routed):
    mine, theirs = _both("oob-gather", jax_routed)
    fs = findings_of_report(IrOobGather(), mine)
    assert "ABS703" in _rules(fs) and "ABS701" not in _rules(fs)
    site, jsite = mine.oob_sites[0], theirs.oob_sites[0]
    # the index before its clamp is 8 + (t % 4) over every tick: [8, 11]
    # exactly (JAX's hi over-approximates through the vmap plumbing)
    assert (site["lo"], site["hi"], site["axis_size"]) == (8, 11, 8)
    assert (jsite["lo"], jsite["axis_size"]) == (8, 8) and \
        jsite["hi"] >= 11
    assert "before its clamp" in site["what"]
    assert mine.max_safe_horizon_log2 == theirs.max_safe_horizon_log2


def test_fixtures_are_expected_and_never_registered():
    from maelstrom_tpu_torch.models import MUTANTS, WORKLOADS
    bl = Baseline.load()
    names = {cls.name for cls in RANGE_FIXTURE_MODELS.values()}
    assert not names & (set(WORKLOADS) | set(MUTANTS))
    for rule, cls in (("ABS701", IrCounterOverflow),
                      ("ABS702", IrScatterRace), ("ABS703", IrOobGather)):
        fp = f"{rule}:maelstrom_tpu_torch/models/ir_hazards.py:" \
             f"{cls.__name__}"
        assert bl.entries[fp].status == "expected"
        assert fingerprint_pass(fp) == "ranges"


def test_tick_int_makes_t_abstract():
    """The fixture's ``8 + t % 4`` reaches the graph as an expression of
    t, and the pass reads it over every tick, not at the recorded one."""
    model = IrOobGather()
    g = cost_model.record_tick(model, cost_model.audit_sim(model, 2), 5)
    full = [n for n in g.nodes if n.name == "full" and n.sym]
    assert [n.sym for n in full] == [{1: ("+", 8, ("%", ("t",), 4))}]
    assert full[0].args[1] == 9                    # the value at t = 5
    assert absint.expr_itv(full[0].sym[1], (0, 1 << 20)) == (8, 11)
    # the functionalized write-back of `series[window] += row` keeps its
    # index as t // stride too
    lin = get_model("lin-kv", 5, "grid")
    g = cost_model.record_tick(lin, cost_model.audit_sim(lin, 5), 7)
    assert any(n.name == "select_scatter" and n.sym == {3: ("//", ("t",),
                                                            1)}
               for n in g.nodes)
    assert any(n.name == "le" and n.sym == {1: ("t",)} for n in g.nodes)


# --- real models -------------------------------------------------------------


@pytest.mark.parametrize("wl,n", [("echo", 2), ("lin-kv", 5)])
def test_real_models_equal_the_reference(wl, n, static_traces):
    model = get_model(wl, n, "grid")
    rep = analyze_model(model, n, "lead", trace_cache=static_traces)
    _compare(rep.to_entry(), _jax_manifest_entry(wl, n), f"{wl}/n={n}")
    assert rep.proven and rep.race_status == "race-free"
    assert rep.max_safe_horizon_log2 >= PRODUCTION_LOG2
    assert rep.ovf_margin_bits >= 1
    # the scatter census: the plain delivery's one scatter_add_ (the
    # taken-slot count: integer, commutative); enqueue writes the
    # deadline lane through a view, no scatter
    assert rep.scatter_census.get("deliver") == 1
    assert rep.scatter_census.get("enqueue", 0) == 0
    assert rep.to_entry()["netsim_scatters"] == 1
    fs = findings_of_report(model, rep)
    assert not [f for f in fs if f.severity == "error"], \
        [f.message for f in fs]


@pytest.mark.parametrize("wl,n", [("echo", 2), ("lin-kv", 5)])
def test_real_models_on_minor_equal_live_jax(wl, n, jax_routed,
                                             static_traces):
    """The minor tick against the live JAX pass on minor: the lead
    verdict, and the counters differ only where the lead ones do."""
    rep = analyze_model(get_model(wl, n, "grid"), n, "minor",
                        trace_cache=static_traces)
    theirs = jabsint.analyze_model(jget_model(wl, n, "grid"), n,
                                   "minor").to_entry()
    _compare(rep.to_entry(), theirs, f"{wl}/n={n}")
    assert rep.proven and rep.race_status == "race-free"
    assert rep.scatter_census.get("deliver") == 1


@pytest.mark.slow
@pytest.mark.parametrize(
    "wl,n,layout", LAYOUT_SPECS,
    ids=[f"{wl}-{n}" + ("" if lay == "lead" else f"-{lay}")
         for wl, n, lay in LAYOUT_SPECS])
def test_every_model_equals_the_reference(wl, n, layout, static_traces):
    rep = analyze_model(get_model(wl, n, "grid"), n, layout,
                        trace_cache=static_traces)
    _compare(rep.to_entry(), _jax_manifest_entry(wl, n, layout),
             f"{wl}/n={n}")


def test_checked_in_manifest_matches_the_reference_and_the_registry():
    """Every registered model has a proven entry in each layout,
    race-free, with headroom, whose verdict equals the JAX manifest's
    entry of that layout and whose counters differ only where
    ``LEAF_CAUSES`` says; stamped with the torch version that recorded
    it."""
    man = load_range_manifest()
    keys = {cost_model.entry_key(wl, n, lay) for wl, n, lay in LAYOUT_SPECS}
    assert set(man["entries"]) == keys
    assert man["torch-version"]
    for wl, n, lay in LAYOUT_SPECS:
        e = man["entries"][cost_model.entry_key(wl, n, lay)]
        assert e["proven"] is True and e["scatter_race"] == "race-free"
        assert e["max_safe_horizon_log2"] >= PRODUCTION_LOG2
        assert e["netsim_scatters"] == 1 and e["ovf_margin_bits"] >= 1
        _compare(e, _jax_manifest_entry(wl, n, lay), f"{wl}/n={n}")


# --- the horizon refusal -----------------------------------------------------


def _report(label="echo/n=2/lead", **kw):
    rep = RangeReport(label=label, probe_log2=24, proven=True,
                      max_safe_horizon_log2=21)
    rep.counters = {".stats.sent": 4}
    for k, v in kw.items():
        setattr(rep, k, v)
    return rep


@pytest.fixture
def both_manifests(tmp_path, monkeypatch):
    """Point both packages at one temporary manifest."""
    path = str(tmp_path / "ranges.json")
    monkeypatch.setattr(absint, "DEFAULT_RANGE_MANIFEST", path)
    monkeypatch.setattr(jabsint, "DEFAULT_RANGE_MANIFEST", path)
    absint._MANIFEST_CACHE.clear()
    jabsint._MANIFEST_CACHE.clear()
    yield path
    absint._MANIFEST_CACHE.clear()
    jabsint._MANIFEST_CACHE.clear()


def _configs(opts):
    from maelstrom_tpu.tpu.harness import make_sim_config as jmake
    out = []
    for make, model in ((harness.make_sim_config, get_model("echo", 2)),
                        (jmake, jget_model("echo", 2, "grid"))):
        try:
            out.append(("ok", make(model, dict(opts)).n_ticks))
        except ValueError as e:
            out.append(("refused", str(e)))
    return out


def test_refusal_at_the_proven_bound_by_name(both_manifests):
    save_range_manifest({"echo/n=2/lead": _report(
        max_safe_horizon_log2=12).to_entry()}, both_manifests)
    # 4096 ticks = 2^12: refused by both; 4095 let through by both
    refused = _configs(dict(node_count=2, time_limit=4.096, ms_per_tick=1.0))
    assert [r[0] for r in refused] == ["refused", "refused"]
    for _, msg in refused:
        assert "'echo'" in msg and "PROVEN" in msg and "2^12" in msg
        assert "4096 ticks" in msg and "--update-ranges" in msg
    assert _configs(dict(node_count=2, time_limit=0.4095, ms_per_tick=0.1)) \
        == [("ok", 4095), ("ok", 4095)]
    # the static passes' own config opts out
    sim = harness.make_sim_config(get_model("echo", 2), dict(
        node_count=2, time_limit=5.0, ms_per_tick=1.0,
        range_horizon_check=False))
    assert sim.n_ticks == 5000
    assert cost_model.audit_sim(get_model("echo", 2), 2).n_ticks == 250


def test_unproven_entry_caps_nothing(both_manifests):
    save_range_manifest({"echo/n=2/lead": _report(
        max_safe_horizon_log2=3, proven=False).to_entry()}, both_manifests)
    assert _configs(dict(node_count=2, time_limit=5.0, ms_per_tick=1.0)) \
        == [("ok", 5000), ("ok", 5000)]


def test_proven_horizon_is_the_minimum_across_entries(both_manifests):
    save_range_manifest({
        "echo/n=2/lead": _report().to_entry(),
        "echo/n=1/lead": _report(label="echo/n=1/lead",
                                 max_safe_horizon_log2=13).to_entry(),
        "g-set/n=5/lead": _report(label="g-set/n=5/lead",
                                  max_safe_horizon_log2=2).to_entry()},
        both_manifests)
    assert proven_horizon_log2("echo") == \
        jabsint.proven_horizon_log2("echo") == 13
    assert _configs(dict(node_count=2, time_limit=8.192,
                         ms_per_tick=1.0))[0][0] == "refused"


# --- the manifest gate -------------------------------------------------------


def test_roundtrip_and_entry_contract(tmp_path):
    path = str(tmp_path / "ranges.json")
    rep = _report()
    save_range_manifest({"echo/n=2/lead": rep.to_entry()}, path)
    man = load_range_manifest(path)
    e = man["entries"]["echo/n=2/lead"]
    assert e == {"proven": True, "max_safe_horizon_log2": 21,
                 "min_overflow_t": None, "scatter_race": "race-free",
                 "netsim_scatters": 0, "ovf_margin_bits": 4,
                 "counters": {".stats.sent": 4}}
    assert man["torch-version"] == cost_model.toolchain()
    assert man["production_horizon_log2"] == PRODUCTION_LOG2
    assert compare_manifest({"echo/n=2/lead": rep}, man,
                            {"echo/n=2/lead": ("p.py", "E")}) == []


@pytest.mark.parametrize("version,severity", [(None, "error"),
                                              ("0.0.0", "warning")])
def test_drift_and_the_toolchain_downgrade(version, severity):
    rep = _report()
    man = {"torch-version": version or cost_model.toolchain(),
           "entries": {"echo/n=2/lead": {**rep.to_entry(),
                                         "ovf_margin_bits": 30}}}
    fs = compare_manifest({"echo/n=2/lead": rep}, man,
                          {"echo/n=2/lead": ("p.py", "E")})
    assert [f.rule for f in fs] == ["ABS705"]
    assert fs[0].severity == severity
    assert "ovf_margin_bits" in fs[0].message
    if version:
        assert "--update-ranges" in fs[0].message


def test_missing_stale_and_errored_entries():
    rep = _report()
    man = {"torch-version": cost_model.toolchain(),
           "entries": {"gone/n=9/lead": _report().to_entry()}}
    fs = compare_manifest({"echo/n=2/lead": rep}, man,
                          {"echo/n=2/lead": ("p.py", "E")})
    assert {f.rule for f in fs} == {"ABS706", "ABS707"}
    assert compare_manifest({}, man, {}, errored={"gone/n=9/lead"}) == []
    assert compare_manifest({"echo/n=2/lead": rep}, man,
                            {"echo/n=2/lead": ("p.py", "E")},
                            full_universe=False)[0].rule == "ABS706"


def test_update_ranges_through_the_cli_then_tamper(tmp_path, monkeypatch,
                                                   capsys, static_traces):
    from maelstrom_tpu_torch.models import ir_hazards
    monkeypatch.setattr(cost_model, "cost_specs", lambda: [("echo", 2)])
    monkeypatch.setattr(ir_hazards, "RANGE_FIXTURE_MODELS", {})
    path = str(tmp_path / "ranges.json")
    assert cli(["lint", "--json", "--update-ranges", "--range-manifest",
                path]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["passes"] == ["ranges"]
    assert [f["rule"] for f in payload["findings"]] == ["ABS700"]
    recorded = load_range_manifest(path)["entries"]
    checked_in = load_range_manifest()["entries"]
    assert recorded == {k: checked_in[k]
                        for k in ("echo/n=2/lead", "echo/n=2/minor")}
    assert cli(["lint", "--strict", "--ranges", "--range-manifest",
                path]) == 0
    capsys.readouterr()
    man = json.load(open(path))
    man["entries"]["echo/n=2/lead"]["ovf_margin_bits"] += 7
    json.dump(man, open(path, "w"))
    fs = run_range_lint(workloads=[("echo", 2)], manifest_path=path,
                        trace_cache=static_traces)
    errs = [f for f in fs if f.rule == "ABS705"]
    assert errs and errs[0].severity == "error"


def test_synthetic_horizon_trips_abs701(static_traces):
    fs = run_range_lint(workloads=[("echo", 2)], probe_log2=31,
                        trace_cache=static_traces)
    assert any(f.rule == "ABS701" and f.severity == "error" for f in fs)


def test_shard_and_aot_still_refused(capsys, monkeypatch):
    """The shard and aot passes, refused until they were ported, now run
    from the CLI (the universe cut to echo at two nodes, no fixtures)."""
    from maelstrom_tpu_torch.models import ir_hazards
    monkeypatch.setattr(cost_model, "cost_specs", lambda: [("echo", 2)])
    monkeypatch.setattr(ir_hazards, "SHARD_FIXTURE_MODELS", {})
    for argv, name in ((["--shard"], "shard"), (["--pass", "aot"], "aot")):
        assert cli(["lint", "--json"] + argv) == 0
        payload = json.loads(capsys.readouterr().out)
        assert payload["passes"] == [name]
        assert payload["summary"]["errors"] == 0


# --- the trace cache and the bench -------------------------------------------


def test_the_ranges_pass_reuses_the_other_passes_traces(monkeypatch):
    """After the lanes pass traced echo, the ranges pass records only
    the init graph."""
    from maelstrom_tpu_torch.analysis.lane_liveness import run_lane_lint
    cache: dict = {}
    run_lane_lint(workloads=[("echo", 2)], trace_cache=cache,
                  include_fixtures=False)
    calls = []
    orig = cost_model.record_tick
    monkeypatch.setattr(cost_model, "record_tick",
                        lambda *a, **k: calls.append(a) or orig(*a, **k))
    run_range_lint(workloads=[("echo", 2)], trace_cache=cache,
                   include_fixtures=False)
    assert calls == []
    assert "echo/n=2/lead::init" in cache


def test_bench_field(monkeypatch):
    from maelstrom_tpu_torch import bench
    model = get_model("echo", 2)
    sim = cost_model.audit_sim(model, 2)
    out = bench.static_fields(model, sim)
    assert out["ovf_margin_bits"] == 1
    monkeypatch.setenv("BENCH_RANGES", "0")
    monkeypatch.setenv("BENCH_LANES", "0")
    assert bench.static_fields(model, sim)["ovf_margin_bits"] is None


# --- soundness against concrete runs -----------------------------------------


@pytest.mark.parametrize("wl,n", [("lin-kv", 5), ("kafka", 1)])
def test_concrete_run_stays_inside_the_intervals(wl, n, static_traces):
    model = get_model(wl, n, "grid")
    sim = cost_model.audit_sim(model, n)
    T = 200
    bounds = absint.leaf_ranges(model, sim, T, trace_cache=static_traces)
    carry = runtime.init_carry(model, sim, 7, "cpu")
    tick = runtime.make_tick_fn(model, sim, None, "cpu")
    seen = {}

    def note(c):
        for p, x in cost_model.flatten_paths(c):
            if x.dtype == torch.int32 and x.numel():
                lo, hi = int(x.min()), int(x.max())
                o = seen.get(p, (lo, hi))
                seen[p] = (min(o[0], lo), max(o[1], hi))

    note(carry)
    with torch.no_grad():
        for t in range(T):
            carry, _ = tick(carry, t)
            note(carry)
    assert set(seen) <= set(bounds)
    outside = {p: (seen[p], bounds[p]) for p in seen
               if not bounds[p][0] <= seen[p][0] <= seen[p][1]
               <= bounds[p][1]}
    assert not outside, outside
    # the run moved: the check is not vacuous
    assert seen[".stats.delivered"][1] > 0
    assert np.isfinite(seen[".telemetry.series"][1])
