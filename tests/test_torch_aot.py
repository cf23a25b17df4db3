"""The port's certified store of kernel libraries
(``maelstrom_tpu_torch/aot_store.py``) and ``lint --aot``
(``analysis/aot_audit.py``, EXE900-906), against the JAX package's store
and audit.

- **Keys.** ``_canon`` and ``store_key`` equal JAX's on the same
  signature dicts; the fingerprint is stable within and across processes
  and moves with every static knob of the chunk dispatch (chunk length,
  scan width, event capacity, fleet size, node count, the NetStats
  copy, the device); the certificate (``graph_digest``) is stable across
  recordings and moves with the dispatch.
- **Runs.** A cold and a warm store give the results of a run without
  the store (the CPU dispatch launches no kernel: an entry holds the
  certificate and no library); the warm run hits every length; the
  heartbeat's ``aot-fingerprint`` is the dispatch's key; a prewarm
  populates exactly the keys a run reads; a store that cannot be
  written leaves the run as it was.
- **Refusals.** A library byte flipped (EXE901) and another toolchain
  or device kind (EXE904) are refused by name at load and counted as a
  miss (a planted library file stands in for ``nvcc``'s, as there is
  no ``nvcc`` here).
- **Audit.** Each EXE900/901/903/904/905/906 scenario of
  ``tests/test_aot.py`` gives the rules and severities JAX's audit gives
  on its own store; the audit loads no library and creates no CUDA
  context; the checked-in manifest certifies current source.
- **Gates.** ``triage`` and ``campaign resume`` pass on a matching
  fingerprint, refuse a drift naming EXE901, skip under
  ``MAELSTROM_AOT=0``, and refuse a JAX-written fingerprint by name.

The suite runs with ``MAELSTROM_AOT=0`` (``tests/conftest.py``); this
module turns the store on, with explicit directories. Sizes: echo at 2
nodes, 4 instances, 250 ticks. Tolerance: exact.
"""

import collections
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_tutorial_cases import one_torch_thread  # noqa: F401 — autouse

from maelstrom_tpu.analysis import aot_audit as jaudit
from maelstrom_tpu.tpu import aot_store as jstore
from maelstrom_tpu_torch import aot_store, harness
from maelstrom_tpu_torch.aot_store import (AotStore, graph_digest,
                                           pipelined_fingerprint,
                                           prewarm_pipelined,
                                           resolve_store_dir, store_key)
from maelstrom_tpu_torch.analysis import aot_audit
from maelstrom_tpu_torch.analysis.aot_audit import (load_aot_manifest,
                                                    run_aot_lint)
from maelstrom_tpu_torch.analysis.findings import SEV_ERROR, SEV_WARNING
from maelstrom_tpu_torch.models import get_model

pytestmark = pytest.mark.aot

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

OPTS = dict(node_count=2, concurrency=2, time_limit=0.25, rate=50.0,
            latency=5.0, n_instances=4, record_instances=2,
            journal_instances=0, seed=3)
RUN = dict(OPTS, pipeline="on", chunk_ticks=50, device_profile="off",
           check_workers=0)

# one recording of each side's audit subjects, shared by this module
TRACE_CACHE: dict = {}
JTRACE_CACHE: dict = {}


@pytest.fixture(scope="module", autouse=True)
def _aot_enabled():
    """conftest.py turns the store off suite-wide; this module is the
    store's coverage."""
    prev = os.environ.pop("MAELSTROM_AOT", None)
    yield
    if prev is not None:
        os.environ["MAELSTROM_AOT"] = prev


def _setup(**over):
    model = get_model("echo", over.get("node_count", 2))
    sim = harness.make_sim_config(model, {**OPTS, **over})
    return model, sim


def _strip(res):
    return {k: v for k, v in res.items() if k not in ("perf", "store-dir")}


def _errors(findings):
    return [f for f in findings if f.severity == SEV_ERROR]


def _pairs(findings):
    return sorted({(f.rule, f.severity) for f in findings})


# --- keys ---------------------------------------------------------------------


Point = collections.namedtuple("Point", "x y")


@dataclasses.dataclass
class Knobs:
    a: int
    b: float


SIGS = [
    {"b": 1, "a": 2},
    {"x": np.arange(3), "y": np.zeros((2, 2), np.int32)},
    {"f": 1.5, "s": {3, 1, 2}, "t": (1, "a", None, True),
     "nested": {"k": [1, 2, {"z": np.int32(3)}]}},
    {"p": Point(1, 2.5), "d": Knobs(3, 0.25), "fn": len},
    {"sim": Point(Point(1, 2), (Point(3, 4),)), "empty": {}, "l": []},
]


@pytest.mark.parametrize("i", range(len(SIGS)))
def test_canon_and_store_key_equal_jax(i):
    sig = SIGS[i]
    assert aot_store._canon(sig) == jstore._canon(sig)
    assert store_key(sig) == jstore.store_key(sig)


def test_store_key_canonicalization():
    assert store_key({"b": 1, "a": 2}) == store_key({"a": 2, "b": 1})
    assert store_key({"x": np.arange(3)}) != store_key({"x": np.arange(3)
                                                        + 1})
    # a CPU tensor is hashed as its numpy array is
    assert store_key({"x": torch.arange(3)}) == store_key({"x":
                                                           np.arange(3)})


def test_fingerprint_stable_and_sensitive_to_static_knobs():
    model, sim = _setup()
    base = pipelined_fingerprint(model, sim)
    assert base == pipelined_fingerprint(model, sim)
    assert len(base) == 32 and int(base, 16) >= 0
    model3, sim3 = _setup(node_count=3)
    model8, sim8 = _setup(n_instances=8)
    variants = {
        "chunk": pipelined_fingerprint(model, sim, chunk=7),
        "scan-k": pipelined_fingerprint(model, sim, scan_k=9),
        "event-cap": pipelined_fingerprint(model, sim, event_cap=48),
        "stats": pipelined_fingerprint(model, sim, stats=False),
        "device": pipelined_fingerprint(model, sim,
                                        device_sig=("cuda", "a card")),
        "nodes": pipelined_fingerprint(model3, sim3),
        "fleet": pipelined_fingerprint(model8, sim8),
    }
    for knob, key in variants.items():
        assert key != base, knob
    assert len(set(variants.values())) == len(variants)


def test_fingerprint_and_entry_follow_the_layout():
    """A minor dispatch is certified under its own key and label, and
    "auto" keys a run as the device it runs on resolves it: lead on the
    CPU, minor on a card (JAX's entry key and ``carry-layout``)."""
    model, sim = _setup()
    assert sim.layout == "lead"
    minor = sim._replace(layout="minor")
    assert pipelined_fingerprint(model, minor) != \
        pipelined_fingerprint(model, sim)
    assert aot_store.entry_label(model, minor, "pipelined") == \
        jstore.entry_label(model, minor, "pipelined") == \
        "echo/n=2/minor/pipelined"
    assert aot_store.entry_label(model, minor, "sharded", 2) == \
        jstore.entry_label(model, minor, "sharded", 2)
    card = ("cuda", "a card")
    fp = {lay: harness.aot_fingerprint_for(model, dict(RUN, layout=lay),
                                           device_sig=card)
          for lay in ("auto", "lead", "minor")}
    assert fp["auto"] == fp["minor"] != fp["lead"]
    assert harness.aot_fingerprint_for(model, RUN, device="cpu") == \
        harness.aot_fingerprint_for(model, dict(RUN, layout="lead"),
                                    device="cpu")
    sig = aot_store.pipelined_signature(
        model, minor, np.arange(4), 64, 8, 50,
        aot_store._meta_carry(model, minor), True, card)
    meta = aot_store.build_meta(sig, "key", "entry", "digest", {}, [])
    assert meta["fingerprint"]["carry-layout"] == "minor"


_CHILD = """
import json, sys
from maelstrom_tpu_torch import harness
from maelstrom_tpu_torch.models import get_model
model = get_model("echo", 2)
print(harness.aot_fingerprint_for(model, json.loads(sys.argv[1]),
                                  device="cpu"))
"""


def test_fingerprint_stable_across_processes():
    env = {k: v for k, v in os.environ.items() if k != "MAELSTROM_AOT"}
    env["PYTHONPATH"] = REPO
    got = [subprocess.run([sys.executable, "-c", _CHILD, json.dumps(RUN)],
                          cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300).stdout.strip()
           for _ in range(2)]
    mine = harness.aot_fingerprint_for(get_model("echo", 2), RUN,
                                       device="cpu")
    assert got == [mine, mine] and len(mine) == 32


def test_graph_digest_stable_and_sensitive():
    from maelstrom_tpu_torch.analysis.cost_model import META, record_call
    x = torch.empty(8, dtype=torch.int32, device=META)
    a = graph_digest(record_call(lambda c: torch.cumsum(c * 2, 0), x))
    assert a == graph_digest(record_call(lambda c: torch.cumsum(c * 2, 0),
                                         x))
    assert a != graph_digest(record_call(lambda c: torch.cumsum(c * 3, 0),
                                         x))
    model, sim = _setup()
    g1 = aot_store.record_dispatch("pipelined", model, sim, cap=64)
    g2 = aot_store.record_dispatch("pipelined", model, sim, cap=64)
    assert graph_digest(g1) == graph_digest(g2)
    assert graph_digest(g1) != graph_digest(
        aot_store.record_dispatch("pipelined", model, sim, cap=128))


def test_resolve_store_dir_and_kill_switch(tmp_path, monkeypatch):
    d = str(tmp_path / "s")
    assert resolve_store_dir(d) == os.path.abspath(d)
    for off in ("off", "0", ""):
        assert resolve_store_dir(off) is None
    assert resolve_store_dir("auto") == resolve_store_dir(None) \
        == aot_store.DEFAULT_DIR
    assert aot_store.DEFAULT_DIR == os.path.join(REPO, "build", "aot")
    monkeypatch.setenv("MAELSTROM_AOT", "0")
    assert not aot_store.aot_enabled()
    assert resolve_store_dir(d) is None and resolve_store_dir("auto") is None
    assert harness.aot_fingerprint_for(get_model("echo", 2), RUN) is None
    assert aot_store.wrap_pipelined(
        None, model=None, sim=None, instance_ids=None, cap=1, scan_k=1,
        stats=True, device=None, store_dir=None) == (None, None)


# --- runs ---------------------------------------------------------------------


def test_pipelined_cold_warm_equal_the_storeless_run(tmp_path):
    model = get_model("echo", 2)
    store = str(tmp_path / "store")
    base = harness.run_torch_test(model, dict(RUN, aot_store="off"),
                                  device="cpu")
    assert "aot" not in base["perf"]["phases"]
    cold = harness.run_torch_test(model, dict(
        RUN, aot_store=store, store_root=str(tmp_path / "runs")),
        device="cpu")
    # a stored run copies the fleet's NetStats each chunk (its heartbeat):
    # the same dispatch, the same key
    warm = harness.run_torch_test(model, dict(
        RUN, aot_store=store, store_root=str(tmp_path / "runs")),
        device="cpu")
    rc, rw = cold["perf"]["phases"]["aot"], warm["perf"]["phases"]["aot"]
    assert rc["hit"] is False and set(rc["lengths"].values()) == {
        "populated"}
    assert rw["hit"] is True and set(rw["lengths"].values()) == {"hit"}
    assert rw["load-s"] > 0 and rw["nvcc"] == rc["nvcc"] == 0
    assert rc["refused"] == rw["refused"] == []
    assert _strip(cold) == _strip(warm) == _strip(base)
    # the heartbeat's provenance key is the dispatch's key
    with open(os.path.join(cold["store-dir"], "heartbeat.jsonl")) as f:
        start = json.loads(f.readline())
    assert start["aot-fingerprint"] == rc["fingerprint"] == \
        harness.aot_fingerprint_for(model, dict(RUN, aot_store=store),
                                    device="cpu")
    assert start["aot-engine"] == harness.AOT_ENGINE
    assert start["aot-device"] == ["cpu", "cpu"]
    entries = list(AotStore(store).entries())
    assert len(entries) == 1
    meta = entries[0][1]
    assert meta["libraries"] == [] and meta["collectives"] == {}
    assert meta["entry"] == "echo/n=2/lead/pipelined"
    assert meta["fingerprint"]["chunk-length"] == aot_store.AOT_CHUNK_LEN
    assert cold["perf"]["phases"]["pipeline"]["first-dispatch-s"] > 0


def test_sharded_cold_warm_equal_the_storeless_run(tmp_path):
    from maelstrom_tpu_torch.parallel import mesh
    model, sim = _setup()
    m = mesh.make_mesh(devices=[torch.device("cpu")] * 2)
    store = str(tmp_path / "store")
    base = mesh.run_sim_sharded_chunked(model, sim, 3, mesh=m, chunk=50)
    pc, pw = {}, {}
    cold = mesh.run_sim_sharded_chunked(model, sim, 3, mesh=m, chunk=50,
                                        perf=pc, aot_store=store)
    warm = mesh.run_sim_sharded_chunked(model, sim, 3, mesh=m, chunk=50,
                                        perf=pw, aot_store=store)
    assert set(pc["aot"]["lengths"].values()) == {"populated"}
    assert pw["aot"]["hit"] is True
    assert set(pw["aot"]["lengths"].values()) == {"hit"}
    for got in (cold, warm):
        assert got[0] == base[0]
        assert np.array_equal(got[1], base[1])
        assert np.array_equal(got[2], base[2])
    (key, meta), = AotStore(store).entries()
    assert meta["entry"] == "echo/n=2/lead/sharded/s=2"
    assert meta["fingerprint"]["mesh"] == [["instances", 2]]


def test_prewarm_populates_the_production_keys(tmp_path):
    model = get_model("echo", 2)
    store = str(tmp_path / "store")
    sim = harness.make_sim_config(model, RUN)
    out = prewarm_pipelined(model, sim, store, chunk=50, scan_k=8)
    assert set(out.values()) == {"populated"}
    res = harness.run_torch_test(model, dict(
        RUN, aot_store=store, store_root=str(tmp_path / "runs")),
        device="cpu")
    rec = res["perf"]["phases"]["aot"]
    assert rec["hit"] is True and set(rec["lengths"]) == set(out)
    assert set(prewarm_pipelined(model, sim, store, chunk=50,
                                 scan_k=8).values()) == {"hit"}


def test_store_failure_leaves_the_run_as_it_was(tmp_path):
    bad = tmp_path / "not-a-dir"
    bad.write_text("x")
    model = get_model("echo", 2)
    base = harness.run_torch_test(model, dict(RUN, aot_store="off"),
                                  device="cpu")
    res = harness.run_torch_test(model, dict(RUN, aot_store=str(bad)),
                                 device="cpu")
    rec = res["perf"]["phases"]["aot"]
    assert set(rec["lengths"].values()) == {"error"} and "error" in rec
    assert _strip(res) == _strip(base)


# --- refusals at load -----------------------------------------------------------


PLANTED = b"\x7fELF planted library bytes " * 64


def _plant(store, key):
    """A library file in ``store`` named by entry ``key`` (as a card's
    entry names the delivery library)."""
    s = AotStore(store)
    lk = "deliver-planted"
    sha = s.put_library(lk, PLANTED, {"name": "deliver"})
    meta = s.meta(key)
    meta["libraries"] = [{"name": "deliver", "key": lk, "sha256": sha}]
    s.put(key, meta)
    return s.lib_path(lk)


def _flip(path, at=-1):
    blob = bytearray(open(path, "rb").read())
    blob[at] ^= 0xFF
    open(path, "wb").write(bytes(blob))


def _edit_meta(store, pick, mutate):
    for key, meta in AotStore(store).entries():
        if pick(meta):
            mutate(meta)
            AotStore(store).put(key, meta)
            return key
    raise AssertionError("no entry matched")


@pytest.fixture(scope="module")
def fresh_store(tmp_path_factory):
    """The audit subjects' entries and a matching manifest, written by
    ``lint --aot --update-aot --aot-store``, with a library planted into
    the pipelined entry; tests copy it, never mutate it."""
    d = tmp_path_factory.mktemp("aot")
    store, manifest = str(d / "store"), str(d / "manifest.json")
    findings = run_aot_lint(repo_root=REPO, manifest_path=manifest,
                            update_manifest=True, store_path=store,
                            trace_cache=TRACE_CACHE)
    assert [f.rule for f in findings] == ["EXE900"]
    entries = dict(AotStore(store).entries())
    assert len(entries) == 3
    _plant(store, next(k for k, m in entries.items()
                       if m["kind"] == "pipelined"))
    return store, manifest


@pytest.fixture(scope="module")
def jax_fresh_store(tmp_path_factory):
    d = tmp_path_factory.mktemp("jaot")
    store, manifest = str(d / "store"), str(d / "manifest.json")
    findings = jaudit.run_aot_lint(repo_root=REPO, manifest_path=manifest,
                                   update_manifest=True, store_path=store,
                                   trace_cache=JTRACE_CACHE)
    assert [f.rule for f in findings] == ["EXE900"]
    return store, manifest


def _copy(fresh, tmp_path, name="store"):
    dst = str(tmp_path / name)
    shutil.copytree(fresh[0], dst)
    return dst


def _pipelined_key(store):
    return next(k for k, m in AotStore(store).entries()
                if m["kind"] == "pipelined")


def test_tampered_library_refused_at_load(fresh_store, tmp_path):
    store = _copy(fresh_store, tmp_path)
    key = _pipelined_key(store)
    s = AotStore(store)
    assert s.load(key, aot_audit.AOT_DEVICE) is not None
    _flip(s.lib_path("deliver-planted"))
    assert s.load_payload(key) is None
    payload, why = s.check(key, aot_audit.AOT_DEVICE)
    assert payload is None and why.startswith("EXE901")
    assert key in why


@pytest.mark.parametrize("field,value", [("torch-version", "0.0.0"),
                                         ("cuda-version", "0.0"),
                                         ("device-kind", "NVIDIA H0")])
def test_foreign_toolchain_refused_at_load(field, value, fresh_store,
                                           tmp_path):
    store = _copy(fresh_store, tmp_path)
    key = _edit_meta(store, lambda m: m["kind"] == "pipelined",
                     lambda m: m.update({field: value}))
    payload, why = AotStore(store).check(key, aot_audit.AOT_DEVICE)
    assert payload is None and why.startswith("EXE904") and field in why
    # the bytes themselves are intact: only the toolchain gate refused
    assert AotStore(store).load_payload(key) is not None


@pytest.mark.parametrize("how", ["toolchain", "tamper"])
def test_refusal_is_named_and_counted_as_a_miss(how, tmp_path):
    """A run whose entry is refused populates it again, and says why."""
    model = get_model("echo", 2)
    store = str(tmp_path / "store")
    opts = dict(RUN, aot_store=store, store_root=str(tmp_path / "runs"))
    base = harness.run_torch_test(model, opts, device="cpu")
    key = base["perf"]["phases"]["aot"]["fingerprint"]
    if how == "toolchain":
        _edit_meta(store, lambda m: True,
                   lambda m: m.update({"torch-version": "0.0.0"}))
    else:
        _flip(_plant(store, key), 3)
    res = harness.run_torch_test(model, opts, device="cpu")
    rec = res["perf"]["phases"]["aot"]
    assert rec["hit"] is False
    assert set(rec["lengths"].values()) == {"populated"}
    want = "EXE904" if how == "toolchain" else "EXE901"
    assert len(rec["refused"]) == 1 and rec["refused"][0].startswith(want)
    assert _strip(res) == _strip(base)
    # populated again: the next run hits
    again = harness.run_torch_test(model, opts, device="cpu")
    assert again["perf"]["phases"]["aot"]["hit"] is True


# --- the audit (EXE9xx) against JAX's -----------------------------------------


def _scenario(case, store, manifest, tmp_path, jax_side):
    """Apply one tests/test_aot.py scenario to a copy of a fresh store;
    returns (store, manifest) to lint."""
    if case == "fresh":
        return store, manifest
    if case == "tamper":
        if jax_side:
            key = next(iter(jstore.AotStore(store).entries()))[0]
            path = os.path.join(store, key + ".bin")
        else:
            path = AotStore(store).lib_path("deliver-planted")
        _flip(path, len(open(path, "rb").read()) // 2)
        return store, manifest
    if case == "drift":
        field = "jaxpr-digest" if jax_side else "graph-digest"

        def drift(meta):
            d = meta["fingerprint"][field]
            meta["fingerprint"][field] = ("0" if d[0] != "0" else "1") + d[1:]
        _edit_json(store, lambda m: m["kind"] == "pipelined", drift)
        return store, manifest
    if case == "smuggled":
        name = "all-to-all" if jax_side else "all_to_all"
        _edit_json(store, lambda m: m["kind"] == "pipelined",
                   lambda m: m.update({"collectives": {name: 2}}))
        return store, manifest
    if case == "toolchain":
        field = "jax-version" if jax_side else "torch-version"
        _edit_json(store, lambda m: True,
                   lambda m: m.update({field: "0.0.0"}))
        return store, manifest
    if case == "missing":
        return "off", str(tmp_path / "absent.json")
    # stale: a manifest entry no subject has
    data = (jaudit if jax_side else aot_audit).load_aot_manifest(manifest)
    data["entries"]["ghost/n=9/lead/pipelined"] = {
        "graph-digest": "0" * 32, "jaxpr-digest": "0" * 32,
        "chunk-length": 4, "donated-leaves": 1, "kind": "pipelined"}
    path = str(tmp_path / f"{'j' if jax_side else 't'}-manifest.json")
    with open(path, "w") as f:
        json.dump(data, f)
    return "off", path


def _edit_json(store, pick, mutate):
    """Rewrite the first entry sidecar ``pick`` accepts (either store's
    ``<key>.json`` layout)."""
    for name in sorted(os.listdir(store)):
        if not name.endswith(".json"):
            continue
        path = os.path.join(store, name)
        meta = json.load(open(path))
        if pick(meta):
            mutate(meta)
            json.dump(meta, open(path, "w"))
            return
    raise AssertionError("no entry matched")


CASES = ["fresh", "tamper", "drift", "smuggled", "toolchain", "missing",
         "stale"]
WANT = {"fresh": [], "tamper": [("EXE901", "error")],
        "drift": [("EXE901", "error")], "smuggled": [("EXE903", "error")],
        "toolchain": [("EXE904", "error")],
        "missing": [("EXE905", "error")],
        "stale": [("EXE906", "warning")]}


@pytest.mark.parametrize("case", CASES)
def test_audit_rules_equal_jax(case, fresh_store, jax_fresh_store,
                               tmp_path):
    tstore, tman = _scenario(case, _copy(fresh_store, tmp_path, "t"),
                             fresh_store[1], tmp_path, False)
    jstore_dir, jman = _scenario(case, _copy(jax_fresh_store, tmp_path,
                                             "j"),
                                 jax_fresh_store[1], tmp_path, True)
    tf = run_aot_lint(repo_root=REPO, manifest_path=tman,
                      store_path=tstore, trace_cache=TRACE_CACHE)
    jf = jaudit.run_aot_lint(repo_root=REPO, manifest_path=jman,
                             store_path=jstore_dir,
                             trace_cache=JTRACE_CACHE)
    assert _pairs(tf) == _pairs(jf) == WANT[case]
    if case == "tamper":
        assert "tamper" in _errors(tf)[0].message
    if case == "drift":
        assert _errors(tf)[0].symbol == "issue_chunk"
    if case == "toolchain":
        # refused by name and FINAL: nothing else piles onto the entries
        assert all(f.rule == "EXE904" for f in tf)
        assert "torch-version" in tf[0].message


def test_audit_loads_no_library_and_creates_no_cuda_context(fresh_store,
                                                            tmp_path):
    from maelstrom_tpu_torch.kernels import build
    store = _copy(fresh_store, tmp_path)
    before = dict(build._loaded)
    assert run_aot_lint(repo_root=REPO, manifest_path=fresh_store[1],
                        store_path=store, trace_cache=TRACE_CACHE) == []
    assert build._loaded == before
    assert not torch.cuda.is_initialized()


def test_checked_in_manifest_matches_current_source():
    assert run_aot_lint(repo_root=REPO, store_path="off",
                        trace_cache=TRACE_CACHE) == []
    data = load_aot_manifest()
    assert set(data["entries"]) == {"echo/n=2/lead/pipelined",
                                    "echo/n=2/minor/pipelined",
                                    "echo/n=2/lead/sharded/s=1"}


def test_minor_subject_is_certified_under_its_own_entry():
    """The pipelined dispatch of the minor carry is a subject of its own,
    as in JAX's audit: a minor sim, the entry label a minor run's store
    entry carries, and a certificate and configuration of its own,
    pinned in the checked-in manifest."""
    subjects = {s["label"]: s for s in aot_audit.audit_subjects()}
    assert sorted(subjects) == sorted(s["label"]
                                      for s in jaudit.audit_subjects())
    label = "echo/n=2/minor/pipelined"
    minor = subjects[label]
    assert minor["kind"] == "pipelined" and minor["sim"].layout == "minor"
    assert aot_store.entry_label(minor["model"], minor["sim"],
                                 "pipelined") == label
    live, _, failures = aot_audit.live_entries(list(subjects.values()),
                                               trace_cache=TRACE_CACHE)
    assert failures == []
    lead = live["echo/n=2/lead/pipelined"]
    assert live[label]["graph-digest"] != lead["graph-digest"]
    assert live[label]["config-digest"] != lead["config-digest"]
    entry = load_aot_manifest()["entries"][label]
    assert entry == {k: live[label][k] for k in entry}
    assert entry["graph-digest"] == live[label]["graph-digest"]


# --- the gates in triage and campaign resume ------------------------------------


@pytest.fixture(scope="module")
def stored_run(tmp_path_factory):
    """A stored, checkpointed echo run with the store on: its run-start
    record carries the port's fingerprint."""
    d = tmp_path_factory.mktemp("gate")
    res = harness.run_torch_test(get_model("echo", 2), dict(
        RUN, checkpoint_every=2, aot_store=str(d / "store"),
        store_root=str(d / "runs")), device="cpu")
    return res["store-dir"]


def _with_header(run_dir, tmp_path, **edit):
    d = str(tmp_path / "run")
    shutil.copytree(run_dir, d)
    path = os.path.join(d, "heartbeat.jsonl")
    lines = open(path).readlines()
    start = json.loads(lines[0])
    for k, v in edit.items():
        if v is None:
            start.pop(k, None)
        else:
            start[k] = v
    lines[0] = json.dumps(start) + "\n"
    open(path, "w").writelines(lines)
    return d


def test_triage_gate(stored_run, tmp_path, monkeypatch):
    from maelstrom_tpu_torch.checkers.triage import TriageError, triage_run
    ok = triage_run(_with_header(stored_run, tmp_path), ids=[0],
                    device="cpu")
    assert len(ok["triaged"]) == 1
    drifted = _with_header(stored_run, tmp_path / "d",
                           **{"aot-fingerprint": "0" * 32})
    with pytest.raises(TriageError, match="EXE901"):
        triage_run(drifted, ids=[0], device="cpu")
    jax_written = _with_header(stored_run, tmp_path / "j",
                               **{"aot-engine": None})
    with pytest.raises(TriageError, match="JAX package"):
        triage_run(jax_written, ids=[0], device="cpu")
    monkeypatch.setenv("MAELSTROM_AOT", "0")
    assert len(triage_run(drifted, ids=[0], device="cpu")["triaged"]) == 1


def test_campaign_resume_gate(stored_run, tmp_path, monkeypatch):
    from maelstrom_tpu_torch.campaign.checkpoint import CheckpointError
    from maelstrom_tpu_torch.campaign.runner import resume_run
    res = resume_run(_with_header(stored_run, tmp_path), device="cpu")
    assert res["valid?"] is True
    drifted = _with_header(stored_run, tmp_path / "d",
                           **{"aot-fingerprint": "0" * 32})
    with pytest.raises(CheckpointError, match="EXE901"):
        resume_run(drifted, device="cpu")
    monkeypatch.setenv("MAELSTROM_AOT", "0")
    assert resume_run(drifted, device="cpu")["valid?"] is True
