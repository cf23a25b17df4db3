"""The port's shard pass (``maelstrom_tpu_torch/analysis/shard_audit.py``,
``lint --shard``, SHD800-809) against the live JAX shard audit.

The oracle is ``maelstrom_tpu/analysis/shard_audit.py`` itself. On this
toolchain (jax 0.9) its ``_abstract_mesh`` calls ``AbstractMesh`` with
the older one-argument signature and raises at the first trace; a
module fixture routes it through ``AbstractMesh(axis_sizes,
axis_names)`` — the test's patch, no JAX file changes — and the live
JAX audit then runs as its own tests expect.

- **Census parity.** For every registered model at the audit config,
  in both carry layouts (in tier-1 the minor one for the five models
  of ``MINOR_TIER1``, all 24 under ``slow``), the port's census (the
  tick from the recorded tick variants, the dispatch from one shard's
  chunk end) equals JAX's census of its
  sharded chunk: the entry at S = 1, 2, 4 and 8 (tick and dispatch
  counts exact, ICI bytes within the manifest tolerance, 0.10), and
  every model's wire carry round-trips 4 -> 2 -> 4 and 4 -> 1 -> 4
  (SHD809 clean). The single-dispatch runner's ``psum`` x6 and its ICI
  bytes equal JAX's.
- **Rules.** The shard fixtures trip the rules JAX's trip in both
  layouts (SHD801+803, SHD802), a small per-instance table under the
  16 KiB floor does not, broken kind metadata trips SHD809, the census
  is size-invariant, the manifest cases (SHD805-808) behave as JAX's.
- **Wiring.** One recording per model through the shared cache, the
  rule families' passes, the checked-in manifest covering the registry.

Sizes: the audit config (4 instances a shard, 250 ticks; the runner's
census runs 4 ticks on CPU shards). Tolerance: exact counts, 0.10 on
bytes.
"""

import json

import numpy as np
import pytest
import torch

from torch_static_cases import static_traces  # noqa: F401 — fixture
from torch_tutorial_cases import one_torch_thread  # noqa: F401 — autouse

from maelstrom_tpu.analysis import cost_model as jcost
from maelstrom_tpu.analysis import shard_audit as jshard
from maelstrom_tpu.models import get_model as jget_model
from maelstrom_tpu.models import ir_hazards as jhaz
from maelstrom_tpu_torch.analysis import cost_model, shard_audit
from maelstrom_tpu_torch.analysis.findings import fingerprint_pass
from maelstrom_tpu_torch.analysis.shard_audit import (
    DEFAULT_SHARD_MANIFEST, DEFAULT_TOLERANCE, MESH_SIZES, chunk_census,
    compare_manifest, entry_of_census, ici_bytes_of, load_shard_manifest,
    reshard_findings, run_shard_lint, save_shard_manifest, shard_stats,
    size_key, trace_sharded_chunk, trace_sharded_run)
from maelstrom_tpu_torch.models import get_model
from maelstrom_tpu_torch.models import ir_hazards as thaz
from maelstrom_tpu_torch.models.echo import EchoModel


@pytest.fixture(scope="module", autouse=True)
def jax_abstract_mesh():
    """The JAX audit's AbstractMesh call, on jax 0.9's signature."""
    from jax.sharding import AbstractMesh
    from maelstrom_tpu.parallel import mesh as jmesh
    mp = pytest.MonkeyPatch()
    mp.setattr(jshard, "_abstract_mesh",
               lambda size: AbstractMesh((int(size),), (jmesh.AXIS,)))
    yield
    mp.undo()


def _rules(findings):
    return {f.rule for f in findings}


def _close(a, b, tol=DEFAULT_TOLERANCE):
    return abs(a - b) <= max(abs(b), 1) * tol


def _same_entry(got, want):
    for field in ("tick-collectives", "dispatch-collectives"):
        assert got[field] == want[field], field
    for field in ("ici-bytes-per-tick", "ici-bytes-per-dispatch",
                  "tick-collective-bytes"):
        assert _close(got[field], want[field]), (field, got, want)


def _jax_census(wl, n, layout="lead"):
    model = jget_model(wl, n, "grid")
    sim = jcost.audit_sim(model, n, layout)
    return jshard.census_of_jaxpr(jshard.trace_sharded_chunk(model,
                                                             sim)[0])


# --- census parity, every registered model -----------------------------------


# every registered model x layout: the lead cases keep their ids
LAYOUT_SPECS = [(wl, n, lay) for lay in cost_model.AUDIT_LAYOUTS
                for wl, n in cost_model.cost_specs()]
# the minor census in tier-1: one model of each tick family and a
# mutant (the whole minor half, ~40 s more, is `slow`)
MINOR_TIER1 = {("echo", 2), ("lin-kv", 5), ("kafka", 1),
               ("txn-list-append", 3), ("lin-kv-bug-double-vote", 5)}


@pytest.mark.parametrize(
    "wl,n,layout",
    [pytest.param(w, n, lay, marks=() if lay == "lead"
                  or (w, n) in MINOR_TIER1 else pytest.mark.slow)
     for w, n, lay in LAYOUT_SPECS],
    ids=[f"{w}-n{n}" + ("" if lay == "lead" else f"-{lay}")
         for w, n, lay in LAYOUT_SPECS])
def test_census_equals_jax_at_every_mesh_size(wl, n, layout,
                                              static_traces):
    model = get_model(wl, n, "grid")
    sim = cost_model.audit_sim(model, n, layout)
    got = chunk_census(model, sim, cache=static_traces)
    want = _jax_census(wl, n, layout)
    for s in MESH_SIZES:
        _same_entry(entry_of_census(got, s), entry_of_census(want, s))
    # every wire leaf has a reshard kind and round-trips across counts
    assert reshard_findings(model, sim, f"{wl}/n={n}") == []


def test_runner_psums_equal_jax(static_traces):
    model = get_model("echo", 2, "grid")
    sim = cost_model.audit_sim(model, 2)
    got = trace_sharded_run(model, sim, cache=static_traces)
    jm = jget_model("echo", 2, "grid")
    want = jshard.census_of_jaxpr(jshard.trace_sharded_run(
        jm, jcost.audit_sim(jm, 2, "lead")))
    assert got["dispatch"]["psum"]["count"] == 6
    assert got == want
    for s in MESH_SIZES:
        assert entry_of_census(got, s) == entry_of_census(want, s)


def test_ici_ring_formulas_equal_jax():
    for prim in shard_audit.ALL_COLLECTIVES + ("unknown",):
        for s in (1, 2, 3, 4, 8):
            for b in (0, 4, 1000, 8020):
                assert ici_bytes_of(prim, b, s) == \
                    jshard.ici_bytes_of(prim, b, s), (prim, s, b)
    assert shard_audit.REDUCTION_COLLECTIVES == \
        jshard.REDUCTION_COLLECTIVES
    assert shard_audit.DATA_COLLECTIVES == jshard.DATA_COLLECTIVES


# --- the fixtures trip JAX's rules -------------------------------------------


@pytest.mark.parametrize(
    "kind,layout", [(k, lay) for lay in cost_model.AUDIT_LAYOUTS
                    for k in sorted(thaz.SHARD_FIXTURE_MODELS)],
    ids=[k + ("" if lay == "lead" else f"-{lay}")
         for lay in cost_model.AUDIT_LAYOUTS
         for k in sorted(thaz.SHARD_FIXTURE_MODELS)])
def test_fixture_trips_the_rules_jax_trips(kind, layout):
    tm = thaz.SHARD_FIXTURE_MODELS[kind]()
    tsim = cost_model.audit_sim(tm, 2, layout)
    got = chunk_census(tm, tsim, cache={})
    tf = (shard_audit.hot_loop_findings(tm, got, kind, kind)
          + shard_audit.replicated_leaf_findings(tm, tsim, kind))
    jm = jhaz.SHARD_FIXTURE_MODELS[kind]()
    jsim = jcost.audit_sim(jm, 2, layout)
    want = jshard.census_of_jaxpr(jshard.trace_sharded_chunk(jm, jsim)[0])
    jf = (jshard.hot_loop_findings(jm, want, kind, kind)
          + jshard.replicated_leaf_findings(jm, jsim, kind))
    assert sorted((f.rule, f.severity) for f in tf) == \
        sorted((f.rule, f.severity) for f in jf)
    assert {k: v["count"] for k, v in got["tick"].items()} == \
        {k: v["count"] for k, v in want["tick"].items()}
    assert all(f.symbol == type(tm).__name__ for f in tf)


def test_small_per_instance_leaf_is_under_the_floor():
    class SmallLeaf(EchoModel):
        name = "echo-shard-small-leaf"

        def make_params(self, n_nodes, device=None):
            return {"t": torch.zeros((4, 8), dtype=torch.int32)}

    model = SmallLeaf()
    sim = cost_model.audit_sim(model, 2)
    assert shard_audit.replicated_leaf_findings(model, sim, "lead") == []


def test_honest_echo_is_clean(static_traces):
    model = EchoModel()
    sim = cost_model.audit_sim(model, 2)
    census = chunk_census(model, sim, cache=static_traces)
    assert census == {"tick": {}, "dispatch": {}}
    assert shard_audit.hot_loop_findings(model, census, "lead",
                                         "echo") == []


def test_cross_device_copy_and_classic_api_are_counted():
    """A copy to another card and the classic c10d operators are named
    as JAX names them (a synthetic graph: no card here)."""
    from maelstrom_tpu_torch.analysis.cost_model import (TickGraph, TNode,
                                                        TValue)
    g = TickGraph(t=0)
    g.values = [TValue(0, (4, 2), torch.int32, "input"),
                TValue(1, (4, 2), torch.int32, "op", 0),
                TValue(2, (4, 2), torch.int32, "op", 1)]
    g.nodes = [
        TNode(0, torch.ops.aten._to_copy.default, "_to_copy", (), {
            "device": torch.device("cuda", 1)}, [0], [1], "deliver"),
        TNode(1, torch.ops.c10d.allreduce_.default, "allreduce_", (),
              {}, [1], [2], "deliver")]
    census = shard_audit.census_of_graph(g)["tick"]
    assert census == {"ppermute": {"count": 1, "bytes": 32},
                      "psum": {"count": 1, "bytes": 32}}


# --- SHD809, size invariance ------------------------------------------------


def test_broken_kind_metadata_trips_shd809():
    model = EchoModel()
    sim = cost_model.audit_sim(model, 2)
    from maelstrom_tpu_torch.parallel import mesh as mesh_mod
    kinds = mesh_mod.wire_leaf_kinds(model, sim)
    fs = reshard_findings(model, sim, "lead", kinds=kinds[:-1])
    assert _rules(fs) == {"SHD809"}
    assert "cannot be resharded" in fs[0].message
    # a kind that does not fit its leaf: the reshard itself raises
    fs = reshard_findings(model, sim, "lead",
                          kinds=["key"] + kinds[1:])
    assert _rules(fs) == {"SHD809"}


def test_census_is_mesh_size_invariant():
    model = EchoModel()
    sim = cost_model.audit_sim(model, 2)
    a = shard_audit.census_of_graph(trace_sharded_chunk(model, sim, 2)[0])
    b = shard_audit.census_of_graph(trace_sharded_chunk(model, sim, 8)[0])
    assert a == b
    assert shard_audit._verify_size_invariance(model, sim, "echo",
                                               (2, 8)) == []


def test_shard_stats_surface():
    model = thaz.IrShardCrossTalk()
    sim = cost_model.audit_sim(model, 2)
    cache = {}
    st = shard_stats(model, sim, cache=cache)
    assert st["collectives_per_tick"] == 2 and st["ici_bytes_est"] > 0
    assert any(k.startswith("shard-sim:") for k in cache)
    assert shard_stats(model, sim, cache=cache) == st
    assert cost_model.tick_shard_stats(model, sim, cache=cache) == st


# --- the manifest gate --------------------------------------------------------


def _echo_live(static_traces):
    model = EchoModel()
    census = chunk_census(model, cost_model.audit_sim(model, 2),
                          cache=static_traces)
    live, paths = {}, {}
    for s in MESH_SIZES:
        key = size_key("echo", 2, "lead", s)
        live[key] = entry_of_census(census, s)
        paths[key] = ("maelstrom_tpu_torch/models/echo.py", "EchoModel")
    return live, paths


def test_manifest_roundtrip_and_clean_compare(tmp_path, static_traces):
    live, paths = _echo_live(static_traces)
    p = str(tmp_path / "m.json")
    save_shard_manifest(live, p)
    data = load_shard_manifest(p)
    assert data["torch-version"] == cost_model.toolchain()
    assert data["entries"] == live
    assert compare_manifest(live, data, paths) == []


@pytest.mark.parametrize("case", ["bytes", "count", "skew", "missing",
                                  "errored"])
def test_manifest_cases_equal_jax(case, static_traces):
    """Each SHD805/806/807 case gives the rules and severities JAX's
    compare_manifest gives on the same entries."""
    live, paths = _echo_live(static_traces)
    entries = {k: dict(v) for k, v in live.items()}
    key8 = size_key("echo", 2, "lead", 8)
    errored = frozenset()
    full = True
    tver, jver = cost_model.toolchain(), None
    if case == "bytes":
        entries[key8]["ici-bytes-per-dispatch"] = 4096
    elif case == "count":
        entries[size_key("echo", 2, "lead", 2)]["tick-collectives"] = {
            "all_gather": 1}
    elif case == "skew":
        entries[key8]["ici-bytes-per-dispatch"] += 10 ** 9
        tver = jver = "0.0.1-not-this-toolchain"
    elif case == "missing":
        entries = {"ghost/n=9/lead/s=2": {}}
    else:
        errored = frozenset({size_key("echo", 2, "lead", 3)})
        entries[size_key("echo", 2, "lead", 3)] = {}
    tf = compare_manifest(live, {"torch-version": tver, "entries": entries},
                          paths, full_universe=full, errored=errored)
    import jax
    jf = jshard.compare_manifest(
        live, {"jax-version": jver or jax.__version__, "entries": entries},
        paths, full_universe=full, errored=errored)
    assert sorted((f.rule, f.severity) for f in tf) == \
        sorted((f.rule, f.severity) for f in jf)
    if case == "skew":
        assert "--update-shard-manifest" in tf[0].message
    if case == "missing":
        restricted = compare_manifest(live, {"entries": entries}, paths,
                                      full_universe=False)
        assert _rules(restricted) == {"SHD805"}


def test_checked_in_manifest_covers_the_registry():
    entries = load_shard_manifest(DEFAULT_SHARD_MANIFEST)["entries"]
    for wl, n, lay in LAYOUT_SPECS:
        for s in MESH_SIZES:
            assert size_key(wl, n, lay, s) in entries
    assert len(entries) == len(LAYOUT_SPECS) * len(MESH_SIZES) + \
        len(MESH_SIZES)
    run = entries["run:echo/n=2/lead/s=2"]
    assert run["dispatch-collectives"] == {"psum": 6}
    assert run["ici-bytes-per-dispatch"] == 8020


def test_update_records_and_regates_clean(tmp_path, static_traces):
    p = str(tmp_path / "m.json")
    fs = run_shard_lint(workloads=[("echo", 2)], manifest_path=p,
                        update_manifest=True, trace_cache=static_traces)
    assert _rules(fs) == {"SHD808"}
    assert run_shard_lint(workloads=[("echo", 2)], manifest_path=p,
                          trace_cache=static_traces) == []
    data = json.load(open(p))
    data["entries"][size_key("echo", 2, "lead", 8)][
        "ici-bytes-per-dispatch"] += 10 ** 9
    json.dump(data, open(p, "w"))
    fs = run_shard_lint(workloads=[("echo", 2)], manifest_path=p,
                        trace_cache=static_traces)
    assert _rules(fs) == {"SHD807"}
    # the checked-in manifest gates the restricted run clean
    assert run_shard_lint(workloads=[("echo", 2)],
                          trace_cache=static_traces) == []


def test_model_failure_trips_shd800():
    fs = run_shard_lint(workloads=[("no-such-workload", 2)])
    assert "SHD800" in _rules(fs)
    assert not any(f.rule == "SHD806" for f in fs)


# --- wiring -------------------------------------------------------------------


def test_one_recording_per_model_through_the_shared_cache(monkeypatch):
    """After the cost pass recorded echo's tick variants, the shard pass
    records only the chunk end (``record_call``, a few operators), and a
    second shard run records nothing."""
    from maelstrom_tpu_torch.analysis.ir_lint import run_ir_lint
    cache: dict = {}
    run_ir_lint(".", hazards=False, cost=True, workloads=[("echo", 2)],
                trace_cache=cache, include_fixtures=False)

    def boom(*a, **k):
        raise AssertionError("the tick was recorded again")
    monkeypatch.setattr(cost_model, "record_tick", boom)
    assert [f for f in run_shard_lint(workloads=[("echo", 2)],
                                      trace_cache=cache)
            if f.severity == "error"] == []
    assert "shard:echo/n=2/lead" in cache
    monkeypatch.setattr(cost_model, "record_call", boom)
    assert run_shard_lint(workloads=[("echo", 2)], trace_cache=cache) == []


def test_rule_families_map_to_their_passes():
    from maelstrom_tpu_torch.analysis.runner import ALL_PASSES, EXTRA_PASSES
    assert fingerprint_pass("SHD801:maelstrom_tpu_torch/models/"
                            "ir_hazards.py:IrShardCrossTalk") == "shard"
    assert fingerprint_pass("EXE901:x:y") == "aot"
    assert {"shard", "aot"} <= set(EXTRA_PASSES)
    assert not {"shard", "aot"} & set(ALL_PASSES)


def test_fixture_findings_are_expected_baseline_entries():
    from maelstrom_tpu_torch.analysis.findings import Baseline
    b = Baseline.load()
    for fp in ("SHD801:maelstrom_tpu_torch/models/ir_hazards.py:"
               "IrShardCrossTalk",
               "SHD803:maelstrom_tpu_torch/models/ir_hazards.py:"
               "IrShardCrossTalk",
               "SHD802:maelstrom_tpu_torch/models/ir_hazards.py:"
               "IrShardReplicatedLeaf"):
        assert b.entries[fp].status == "expected"
    assert np.isfinite(DEFAULT_TOLERANCE)
