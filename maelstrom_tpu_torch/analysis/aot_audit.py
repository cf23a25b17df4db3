"""Certified-store auditor: ``lint --aot`` (pass 9).

Counterpart of ``maelstrom_tpu/analysis/aot_audit.py``. The store
(``aot_store.py``) lets a run load its kernel libraries without
building them, which makes the store a place where drift can hide: a
library whose bytes changed, an entry recorded under another toolchain,
an entry whose dispatch no longer is what the source records, or one
carrying a collective the shard pass never certified. This pass checks
them without loading a library and without creating a CUDA context:

- For the audit subjects (``echo`` at two nodes: the pipelined chunk
  dispatch in each carry layout, and one shard's chunk on a one-shard
  mesh in the lead layout) it re-records the
  dispatch on ``meta`` tensors at ``aot_store.AOT_CHUNK_LEN`` ticks and
  derives its certificate (``aot_store.graph_digest``), pinned in the
  checked-in, torch-version-stamped ``analysis/aot_manifest.json``.
- Every entry of the store (``build/aot`` by default, or ``--aot-store
  DIR``) is audited: its libraries re-hashed against the recorded sha256
  (the bytes are read, never loaded), its recorded toolchain matched
  against the running one, its certificate compared with the subject's
  where the entry was recorded for the subject's configuration
  (``fingerprint.config-digest``), and its collective census checked
  against what ``analysis/shard_manifest.json`` certifies.

Rules (EXE9xx):

=======  ===========================  ========  ========================
rule     name                         severity  what it flags
=======  ===========================  ========  ========================
EXE900   aot-manifest-updated         info      ``--update-aot``
                                                rewrote the manifest
EXE901   executable-fingerprint-      error     a stored / manifested
         drift                                  certificate no longer
                                                matches the graph the
                                                current source records
                                                (or a library whose
                                                bytes fail their sha256
                                                — tamper)
EXE903   stored-collective-census-    error     an entry's dispatch
         drift                                  holds a collective the
                                                shard manifest never
                                                certified (pipelined
                                                entries: any at all)
EXE904   toolchain-incompatible-      error     an entry recorded under
         entry                                  another torch or CUDA
                                                version or device kind
                                                — refused by name; the
                                                runtime treats it as a
                                                miss
EXE905   aot-manifest-missing         error     an audit subject has no
                                                manifest entry
EXE906   aot-manifest-stale           warning   a manifest entry
                                                matches no audit subject
=======  ===========================  ========  ========================

EXE902 (donation lost in a stored executable) has no counterpart: the
port's executors donate nothing (``analysis/ir_lint.py``, JXP403). The
device kind of a card's entry is judged where this process already has
a CUDA context; the lint creates none, so a card entry audited on a host
that sees no card is held to its toolchain and bytes, and the runtime
refuses a foreign device kind at load.

``--update-aot`` re-records the manifest from current source (recording
only); with an explicit ``--aot-store DIR`` it also populates that store
with the subjects' entries (for this host, the CPU: no library). An
entry that is merely absent is never a finding: the store is a cache
and a fresh checkout must lint green.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

from . import cost_model
from .findings import Finding, SEV_ERROR, SEV_INFO, SEV_WARNING

PASS_NAME = "aot"

DEFAULT_AOT_MANIFEST = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "aot_manifest.json")

# the subjects' workload: the JAX audit's donation workload
DONATION_WORKLOAD = ("echo", 2)

# the subjects' event capacity, as JAX's audit lowers them
AOT_CAP = 64

# mesh size of the sharded subject (the census is size-invariant,
# checked by the shard pass)
AOT_MESH_SIZE = 1

# the subjects are keyed for the host the lint runs on: it touches no card
AOT_DEVICE = ("cpu", "cpu")

_PIPELINE_PATH = "maelstrom_tpu_torch/pipeline.py"
_MESH_PATH = "maelstrom_tpu_torch/parallel/mesh.py"
_STORE_PATH = "maelstrom_tpu_torch/aot_store.py"
_MANIFEST_REPO_PATH = "maelstrom_tpu_torch/analysis/aot_manifest.json"


def _finding(rule, name, severity, path, symbol, message) -> Finding:
    return Finding(rule=rule, name=name, severity=severity,
                   pass_name=PASS_NAME, path=path, line=0,
                   symbol=symbol, message=message)


# --- the audit subjects -----------------------------------------------------


def audit_subjects() -> List[Dict[str, Any]]:
    """The subject list (nothing recorded yet): per subject the model,
    sim, label, kind and the (path, symbol) its findings point at. The
    pipelined dispatch is audited in every layout, the sharded one in
    the lead layout."""
    from ..models import get_model
    wl, n = DONATION_WORKLOAD
    model = get_model(wl, n)
    subjects = [
        {"model": model, "sim": cost_model.audit_sim(model, n, layout),
         "kind": "pipelined", "label": f"{wl}/n={n}/{layout}/pipelined",
         "path": _PIPELINE_PATH, "symbol": "issue_chunk"}
        for layout in cost_model.AUDIT_LAYOUTS]
    subjects.append(
        {"model": model, "sim": cost_model.audit_sim(model, n, "lead"),
         "kind": "sharded",
         "label": f"{wl}/n={n}/lead/sharded/s={AOT_MESH_SIZE}",
         "path": _MESH_PATH, "symbol": "shard_chunk"})
    return subjects


def _subject_sig(subject: Dict[str, Any]) -> Dict[str, Any]:
    """The store signature of a subject's dispatch, keyed for this
    host."""
    import numpy as np
    from .. import aot_store
    from ..pipeline import DEFAULT_SCAN_TOP_K
    model, sim = subject["model"], subject["sim"]
    carry = aot_store._meta_carry(model, sim)
    if subject["kind"] == "pipelined":
        return aot_store.pipelined_signature(
            model, sim, np.arange(sim.n_instances, dtype=np.int32),
            AOT_CAP, DEFAULT_SCAN_TOP_K, aot_store.AOT_CHUNK_LEN, carry,
            True, AOT_DEVICE)
    return aot_store.sharded_signature(
        model, sim, AOT_MESH_SIZE, DEFAULT_SCAN_TOP_K,
        aot_store.AOT_CHUNK_LEN, carry, AOT_DEVICE)


def trace_subject(subject: Dict[str, Any]
                  ) -> Tuple[Dict[str, Any], str, Dict[str, int]]:
    """Record one subject's dispatch: ``(store signature, graph digest,
    collective census)`` — nothing built, nothing loaded."""
    from .. import aot_store
    from ..pipeline import DEFAULT_SCAN_TOP_K
    g = aot_store.record_dispatch(
        subject["kind"], subject["model"], subject["sim"], cap=AOT_CAP,
        scan_k=DEFAULT_SCAN_TOP_K, stats=True, mesh_size=AOT_MESH_SIZE)
    return (_subject_sig(subject), aot_store.graph_digest(g),
            aot_store._census(g))


def live_entries(subjects: Optional[List[Dict[str, Any]]] = None,
                 trace_cache=None) -> Tuple[Dict[str, Dict[str, Any]],
                                            Dict[str, Tuple[str, str]],
                                            List[Finding]]:
    """Record every subject into the manifest-shaped live map ``label ->
    {graph-digest, chunk-length, kind, config-digest}``; returns ``(live,
    anchors, failures)``. The recordings ride ``trace_cache`` under
    ``aot:<label>`` keys."""
    from ..aot_store import AOT_CHUNK_LEN, config_digest
    subjects = audit_subjects() if subjects is None else subjects
    live: Dict[str, Dict[str, Any]] = {}
    anchors: Dict[str, Tuple[str, str]] = {}
    failures: List[Finding] = []
    for subject in subjects:
        label = subject["label"]
        cached = (trace_cache.get("aot:" + label)
                  if trace_cache is not None else None)
        try:
            if cached is None:
                cached = trace_subject(subject)
                if trace_cache is not None:
                    trace_cache["aot:" + label] = cached
        except Exception as e:
            failures.append(_finding(
                "EXE901", "executable-fingerprint-drift", SEV_ERROR,
                subject["path"], subject["symbol"],
                f"[{label}] recording the audit subject raised "
                f"{type(e).__name__}: {e} — the dispatch no longer "
                f"records, so no stored entry for it can be certified"))
            continue
        sig, digest, _census = cached
        live[label] = {"graph-digest": digest,
                       "chunk-length": AOT_CHUNK_LEN,
                       "kind": subject["kind"],
                       "config-digest": config_digest(sig)}
        anchors[label] = (subject["path"], subject["symbol"])
    return live, anchors, failures


# --- manifest io + compare --------------------------------------------------


def load_aot_manifest(path: Optional[str] = None) -> Dict[str, Any]:
    path = path or DEFAULT_AOT_MANIFEST
    if not os.path.exists(path):
        return {"version": 1, "entries": {}}
    with open(path) as f:
        data = json.load(f)
    data.setdefault("entries", {})
    return data


def save_aot_manifest(entries: Dict[str, Dict[str, Any]],
                      path: Optional[str] = None) -> str:
    path = path or DEFAULT_AOT_MANIFEST
    payload = {
        "version": 1,
        "_comment": (
            "Certificates of the chunk dispatches for `python -m "
            "maelstrom_tpu_torch lint --aot`. Keys: <workload>/n=<nodes>/"
            "<layout>/<pipelined|sharded>[/s=<mesh>]; graph-digest = "
            "aot_store.graph_digest of the dispatch's aten graph recorded "
            "on meta tensors at chunk-length ticks. A stored entry (or "
            "this manifest) whose certificate no longer matches current "
            "source fails the gate (EXE901). Regenerate after an "
            "INTENTIONAL dispatch change with `lint --aot --update-aot`. "
            "torch-version records the toolchain: under another torch "
            "the gate downgrades drift to a re-record warning."),
        "torch-version": cost_model.toolchain(),
        "entries": {k: {f: entries[k][f] for f in
                        ("graph-digest", "chunk-length", "kind")}
                    for k in sorted(entries)},
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")
    return path


def compare_manifest(live: Dict[str, Dict[str, Any]],
                     manifest: Dict[str, Any],
                     anchors: Dict[str, Tuple[str, str]]
                     ) -> List[Finding]:
    """EXE905/901/906: the live certificates against the checked-in
    manifest."""
    entries = manifest.get("entries", {})
    note = cost_model.toolchain_note(manifest.get("torch-version"),
                                     "the AOT manifest", "--update-aot")
    findings: List[Finding] = []
    for label in sorted(live):
        path, symbol = anchors[label]
        base = entries.get(label)
        if base is None:
            findings.append(_finding(
                "EXE905", "aot-manifest-missing", SEV_ERROR, path, symbol,
                f"[{label}] no AOT-manifest entry — record one with "
                f"`lint --aot --update-aot`"))
            continue
        if base.get("graph-digest") != live[label]["graph-digest"]:
            findings.append(_finding(
                "EXE901", "executable-fingerprint-drift",
                SEV_WARNING if note else SEV_ERROR, path, symbol,
                f"[{label}] the graph current source records "
                f"({live[label]['graph-digest']}) no longer matches the "
                f"certified manifest digest ({base.get('graph-digest')}) "
                f"— the chunk dispatch changed; stored entries keyed on "
                f"the old source certify other code than a fresh build "
                f"would run. If intentional, re-record with --update-aot "
                f"and justify it in the PR"
                + (f" ({note})" if note else "")))
    for label in sorted(set(entries) - set(live)):
        findings.append(_finding(
            "EXE906", "aot-manifest-stale", SEV_WARNING,
            _MANIFEST_REPO_PATH, "",
            f"[{label}] manifest entry matches no audit subject — remove "
            f"or re-record it"))
    return findings


# --- the store audit --------------------------------------------------------


def _entry_anchor(meta: Dict[str, Any]) -> Tuple[str, str]:
    if meta.get("kind") == "sharded":
        return _MESH_PATH, "shard_chunk"
    return _PIPELINE_PATH, "issue_chunk"


def _promised(meta: Dict[str, Any]) -> Optional[set]:
    """The collectives the shard manifest certifies for this entry
    (none for a pipelined entry: one device has no peer). None when the
    entry's configuration has no shard-manifest entry to judge by."""
    if meta.get("kind") != "sharded":
        return set()
    # <wl>/n=<n>/lead/sharded/s=<size> -> <wl>/n=<n>/lead/s=<size>
    parts = (meta.get("entry") or "").split("/")
    if len(parts) != 5:
        return None
    from .shard_audit import load_shard_manifest
    entry = load_shard_manifest().get("entries", {}).get(
        "/".join(parts[:3] + parts[4:]))
    if entry is None:
        return None
    return set(entry.get("tick-collectives", {})) \
        | set(entry.get("dispatch-collectives", {}))


def _running_kind(platform: str) -> Optional[str]:
    """The device kind this process runs ``platform`` on, when it can
    tell without creating a CUDA context; else None (not judged)."""
    if platform == "cpu":
        return "cpu"
    if platform == "cuda":
        import torch
        if torch.cuda.is_initialized():
            from ..aot_store import _device_sig
            return _device_sig("cuda")[1]
    return None


def audit_store(store_dir: str, live: Dict[str, Dict[str, Any]]
                ) -> List[Finding]:
    """EXE901/903/904 over every entry of one store: bytes re-hashed,
    sidecars read, nothing loaded."""
    from ..aot_store import AotStore, toolchain

    store = AotStore(store_dir)
    findings: List[Finding] = []
    for key, meta in store.entries():
        entry = meta.get("entry", key)
        path, symbol = _entry_anchor(meta)
        where = f"store entry {key} ({entry}) in {store_dir}"

        # EXE904: another toolchain's or device's entry — refused by
        # name, never read further
        running = dict(toolchain())
        kind = _running_kind(meta.get("platform", ""))
        if kind is not None:
            running["device-kind"] = kind
        mismatches = [f"{field} {meta.get(field)!r} != {cur!r}"
                      for field, cur in running.items()
                      if meta.get(field) != cur]
        if mismatches:
            findings.append(_finding(
                "EXE904", "toolchain-incompatible-entry", SEV_ERROR,
                _STORE_PATH, "AotStore",
                f"{where}: recorded toolchain no longer matches the "
                f"running one ({'; '.join(mismatches)}) — the runtime "
                f"refuses this entry by name (treated as a miss); delete "
                f"it or re-populate the store"))
            continue

        # EXE901 (payload face): every library's bytes must still hash
        # to the recorded sha256
        if store.load_payload(key) is None:
            findings.append(_finding(
                "EXE901", "executable-fingerprint-drift", SEV_ERROR,
                _STORE_PATH, "AotStore",
                f"{where}: a library is missing, unreadable, or no longer "
                f"matches its recorded sha256 — the entry was tampered "
                f"with or truncated; the runtime refuses it, delete and "
                f"re-populate"))
            continue

        # EXE901 (source face): the certificate against the graph the
        # current source records, for an entry of the subject's config
        fp = meta.get("fingerprint", {})
        subject = live.get(entry)
        if (subject is not None
                and fp.get("chunk-length") == subject["chunk-length"]
                and fp.get("config-digest") == subject["config-digest"]
                and fp.get("graph-digest") != subject["graph-digest"]):
            findings.append(_finding(
                "EXE901", "executable-fingerprint-drift", SEV_ERROR, path,
                symbol,
                f"{where}: stored certificate {fp.get('graph-digest')} no "
                f"longer matches the graph current source records "
                f"({subject['graph-digest']}) — the store would serve "
                f"libraries for a dispatch the current tree does not "
                f"describe; delete the entry or re-populate"))

        # EXE903: collectives in the entry's dispatch the shard pass
        # never certified
        promised = _promised(meta)
        if promised is not None:
            smuggled = sorted(set(meta.get("collectives", {})) - promised)
            if smuggled:
                findings.append(_finding(
                    "EXE903", "stored-collective-census-drift", SEV_ERROR,
                    path, symbol,
                    f"{where}: the stored dispatch contains collective(s) "
                    f"{smuggled} that "
                    + ("a single-device pipelined dispatch must not "
                       "contain at all" if meta.get("kind") != "sharded"
                       else "shard_manifest.json does not certify for "
                            "this config")
                    + " — communication smuggled in through the store; "
                      "re-run `lint --shard` and re-populate"))
    return findings


# --- populate (--update-aot --aot-store DIR) --------------------------------


def populate_store(store_dir: str, subjects: List[Dict[str, Any]],
                   trace_cache=None) -> Dict[str, str]:
    """Write every subject's entry (keyed for this host) into the store;
    ``label -> key`` of what was written."""
    from ..aot_store import (AotStore, build_meta, dispatch_libraries,
                             ensure_libraries, entry_label, store_key)
    store = AotStore(store_dir)
    written: Dict[str, str] = {}
    for subject in subjects:
        label = subject["label"]
        cached = (trace_cache.get("aot:" + label)
                  if trace_cache is not None else None)
        if cached is None:
            cached = trace_subject(subject)
            if trace_cache is not None:
                trace_cache["aot:" + label] = cached
        sig, digest, census = cached
        key = store_key(sig)
        libraries = ensure_libraries(store, dispatch_libraries(
            sig["platform"]), (sig["platform"], sig["device-kind"]))
        store.put(key, build_meta(
            sig, key, entry_label(
                subject["model"], subject["sim"], subject["kind"],
                mesh_size=AOT_MESH_SIZE
                if subject["kind"] == "sharded" else None),
            digest, census, libraries))
        written[label] = key
    return written


# --- orchestration ----------------------------------------------------------


def run_aot_lint(repo_root: str = ".",
                 manifest_path: Optional[str] = None,
                 update_manifest: bool = False,
                 store_path: Optional[str] = None,
                 trace_cache=None) -> List[Finding]:
    """The aot pass: record the subjects, gate the checked-in manifest
    (or re-record it under ``update_manifest``), and audit every entry
    of the resolved store (``store_path=None`` is ``auto``; an absent
    store dir audits nothing). ``update_manifest`` with an explicit
    ``store_path`` also populates that store."""
    from ..aot_store import resolve_store_dir

    subjects = audit_subjects()
    live, anchors, findings = live_entries(subjects,
                                           trace_cache=trace_cache)
    if update_manifest:
        path = save_aot_manifest(live, manifest_path)
        n_store = 0
        resolved = (resolve_store_dir(store_path)
                    if store_path is not None else None)
        if resolved is not None:
            n_store = len(populate_store(resolved, subjects,
                                         trace_cache=trace_cache))
        findings.append(_finding(
            "EXE900", "aot-manifest-updated", SEV_INFO,
            os.path.relpath(path, os.path.abspath(repo_root))
            if os.path.isabs(path) else path, "",
            f"recorded {len(live)} AOT-manifest entr"
            f"{'y' if len(live) == 1 else 'ies'}"
            + (f" and populated {n_store} store entr"
               f"{'y' if n_store == 1 else 'ies'} in {resolved}"
               if n_store else "")))
        return findings

    manifest = load_aot_manifest(manifest_path)
    findings.extend(compare_manifest(live, manifest, anchors))
    resolved = resolve_store_dir(store_path)
    if resolved is not None and os.path.isdir(resolved):
        findings.extend(audit_store(resolved, live))
    return findings
