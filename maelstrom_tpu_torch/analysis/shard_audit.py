"""Shard auditor: ``lint --shard`` (pass 8) over the port's mesh executor.

Counterpart of ``maelstrom_tpu/analysis/shard_audit.py``. The other
passes audit one device's tick; none of them sees what a shard does
beside its peers. Three refactors would pass every test that runs at
S = 1: a collective or a cross-device copy inside a shard's tick, a
per-instance table smuggled into the params every shard holds whole,
a wire-carry leaf without a reshard kind. This pass finds them without
a device:

- For every registered model in both carry layouts it takes a
  **collective census** of the recorded graphs
  (``cost_model.record_tick`` / ``record_call`` on ``meta`` tensors):
  *tick* holds each ``torch.distributed`` operator (the functional
  collectives ``_c10d_functional.*`` and the ``c10d.*`` ops behind the
  classic API) or cross-device copy in a shard's recorded tick, per
  tick (the heaviest tick variant's count), named in JAX's vocabulary
  (:data:`REDUCTION_COLLECTIVES`, :data:`DATA_COLLECTIVES`); *dispatch*
  holds the executor's cross-shard reductions at the dispatch boundary,
  counted as JAX's ``psum``: for the single-dispatch runner
  (``mesh.run_sim_sharded``) the host sums of the five NetStats
  counters and of the telemetry series (``mesh._psum``, counted under
  ``mesh.reduction_census``), for a shard's chunk
  (``mesh.shard_chunk``) the collectives of its chunk end. The host
  joins the JAX executor makes through ``shard_map``'s ``out_specs``
  (the chunk snapshots, scans, events and the final wire gathered per
  shard and merged on the host) and the processes' all-gathers of
  ``mesh._all_rows`` are that boundary: JAX does not count them, and
  neither does the port.
- The census becomes an **ICI-bytes** estimate per mesh size in {1, 2,
  4, 8} (JAX's ring formulas, :func:`ici_bytes_of`), pinned in the
  checked-in ``analysis/shard_manifest.json`` (SHD805-808), with
  ``cost_model.toolchain_note`` under a torch-version skew.
- It proves **cross-mesh resume**: per model the wire carry's per-leaf
  reshard kinds (``mesh.wire_leaf_kinds``) drive
  ``campaign/checkpoint.reshard_carry`` 4 -> 2 -> 4 and 4 -> 1 -> 4 on
  zero-filled templates (SHD809).

The tick census rides the shared trace cache (the tick graphs ``lint
--ir --cost --lanes --ranges`` record), so the combined gate records
each model once per tick variant; the chunk end is recorded apart at
zero ticks (a few operators). The census is the same at every mesh size
(each shard runs the same per-shard program), which the pass checks once
per run by recording the donation subject's whole chunk at two sizes.

Rules (SHD8xx), as in JAX:

=======  ==========================  ========  =========================
rule     name                        severity  what it flags
=======  ==========================  ========  =========================
SHD800   shard-audit-failure         error     a subject failed to
                                               record
SHD801   tick-hot-loop-collective    error     a reduction collective
                                               in a shard's tick beyond
                                               the model's pinned budget
SHD802   replicated-per-instance-    error     a params leaf (every
         leaf                                  shard holds params whole)
                                               whose leading dim is the
                                               per-shard instance count
                                               and size clears 16 KiB
SHD803   cross-shard-dependence      error     a data-moving collective
                                               or a cross-device copy in
                                               a shard's tick
SHD805   shard-manifest-missing      error     a model x size has no
                                               manifest entry
SHD806   shard-manifest-stale        warning   a manifest entry matches
                                               no model x size
SHD807   shard-manifest-drift        error     census or ICI estimate
                                               drifted from the manifest
                                               (warning under torch skew)
SHD808   shard-manifest-updated      info      ``--update-shard-
                                               manifest`` rewrote it
SHD809   carry-not-reshardable       error     a wire-carry leaf cannot
                                               be re-chunked across
                                               shard counts
=======  ==========================  ========  =========================

SHD804 (donation lost under sharding) has no counterpart, for the reason
``analysis/ir_lint.py`` gives for JXP403: the port's executors donate
nothing. The shard fixtures (``models/ir_hazards.py``:
``SHARD_FIXTURE_MODELS``) are audited on full runs; their findings are
``expected`` entries of ``analysis/baseline.json``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from . import cost_model
from .findings import Finding, SEV_ERROR, SEV_INFO, SEV_WARNING

PASS_NAME = "shard"

DEFAULT_SHARD_MANIFEST = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "shard_manifest.json")

# the audited mesh sizes: 1 (the degenerate case moves nothing), 2 and 4
# (the shards of one card in the tests and the smoke), 8 (one node)
MESH_SIZES = (1, 2, 4, 8)

# the size the census is recorded at (it is size-invariant, checked per
# run by _verify_size_invariance)
CENSUS_TRACE_SIZE = 2

# ticks of the recorded chunk (the aot pass certifies the same)
CENSUS_CHUNK_LEN = 4

# manifest tolerance on the byte estimates (counts compare exactly)
DEFAULT_TOLERANCE = 0.10

# SHD802 floor: a smaller params leaf is not worth flagging even when its
# leading dim happens to equal the per-shard instance count
SHD802_FLOOR_BYTES = 16 << 10            # 16 KiB

# JAX's collective vocabulary: reductions merge values (legitimate at a
# dispatch boundary, budgeted in the tick); data movers redistribute
# state across shards (never legitimate in the tick)
REDUCTION_COLLECTIVES = ("pmax", "pmin", "psum")
DATA_COLLECTIVES = ("all_gather", "all_to_all", "pgather", "ppermute",
                    "psum_scatter", "reduce_scatter")
ALL_COLLECTIVES = REDUCTION_COLLECTIVES + DATA_COLLECTIVES

# per-model tick budgets of reduction collectives (SHD801), by workload
# prefix: empty, as in JAX — the shards merge nothing inside a tick
TICK_COLLECTIVE_BUDGETS: Dict[str, Dict[str, int]] = {
    "raft": {},
}

# torch.distributed operator (packet name) -> JAX's name; a reduction's
# name depends on its reduce op (_reduction_name)
_C10D_NAMES = {
    "all_gather_into_tensor": "all_gather",
    "all_gather_into_tensor_coalesced": "all_gather",
    "all_gather_into_tensor_out": "all_gather",
    "allgather_": "all_gather",
    "_allgather_base_": "all_gather",
    "allgather_into_tensor_coalesced_": "all_gather",
    "allgather_coalesced_": "all_gather",
    "broadcast": "all_gather",
    "broadcast_": "all_gather",
    "reduce_scatter_tensor": "psum_scatter",
    "reduce_scatter_tensor_coalesced": "psum_scatter",
    "reduce_scatter_": "psum_scatter",
    "_reduce_scatter_base_": "psum_scatter",
    "reduce_scatter_tensor_coalesced_": "psum_scatter",
    "all_to_all_single": "all_to_all",
    "alltoall_": "all_to_all",
    "alltoall_base_": "all_to_all",
    "send": "ppermute",
    "recv_": "ppermute",
    "recv_any_source_": "ppermute",
}
_REDUCTIONS = ("all_reduce", "all_reduce_", "all_reduce_coalesced",
               "all_reduce_coalesced_", "allreduce_",
               "allreduce_coalesced_", "reduce_")
# bookkeeping, not communication
_C10D_SKIP = ("wait_tensor", "barrier", "monitored_barrier_")

_MESH_PATH = "maelstrom_tpu_torch/parallel/mesh.py"
_MANIFEST_REPO_PATH = "maelstrom_tpu_torch/analysis/shard_manifest.json"


def _model_path(model) -> str:
    return type(model).__module__.replace(".", os.sep) + ".py"


def _finding(rule, name, severity, path, symbol, message) -> Finding:
    return Finding(rule=rule, name=name, severity=severity,
                   pass_name=PASS_NAME, path=path, line=0,
                   symbol=symbol, message=message)


class _SizedMesh:
    """A device-free mesh of ``size`` shards: what ``mesh.wire_template``
    reads (the counterpart of JAX's ``AbstractMesh``)."""

    def __init__(self, size: int):
        self.size = int(size)


# --- collective census ------------------------------------------------------


def _reduction_name(node) -> str:
    op = ""
    for a in list(node.args[1:]) + list(node.kwargs.values()):
        if isinstance(a, str):
            op = a
            break
        if a is not None and "ReduceOp" in type(a).__name__:
            op = str(a)
            break
    op = op.lower()
    if "max" in op:
        return "pmax"
    if "min" in op:
        return "pmin"
    return "psum"


def collective_of(node) -> Optional[str]:
    """JAX's name for what one recorded operator communicates, or None:
    a ``torch.distributed`` operator by its kind, a copy to another
    accelerator (``_to_copy`` with a ``device`` off ``meta`` and the
    CPU) as a ``ppermute``."""
    ns = node.op.namespace if hasattr(node.op, "namespace") else \
        str(node.op).split(".")[0]
    if ns in cost_model.COLLECTIVE_NAMESPACES:
        if node.name in _C10D_SKIP:
            return None
        if node.name in _REDUCTIONS:
            return _reduction_name(node)
        return _C10D_NAMES.get(node.name, "ppermute")
    if node.name == "_to_copy":
        dev = node.kwargs.get("device")
        if dev is not None and str(dev).split(":")[0] not in ("meta",
                                                               "cpu"):
            return "ppermute"
    return None


def census_of_graph(g) -> Dict[str, Dict[str, Dict[str, int]]]:
    """Every collective of one recorded graph: ``{"tick": {name:
    {"count", "bytes"}}, "dispatch": {}}``, ``bytes`` the per-shard
    operand payload (the bytes behind each tensor argument)."""
    out: Dict[str, Dict[str, int]] = {}
    for n in g.nodes:
        name = collective_of(n)
        if name is None:
            continue
        e = out.setdefault(name, {"count": 0, "bytes": 0})
        e["count"] += 1
        e["bytes"] += sum(g.base_bytes(v) for v in n.ins)
    return {"tick": out, "dispatch": {}}


def _max_census(parts) -> Dict[str, Dict[str, int]]:
    """Per primitive, the heaviest of several per-tick censuses."""
    out: Dict[str, Dict[str, int]] = {}
    for part in parts:
        for name, e in part.items():
            cur = out.get(name)
            if cur is None or (e["count"], e["bytes"]) > (cur["count"],
                                                          cur["bytes"]):
                out[name] = dict(e)
    return out


def ici_bytes_of(prim: str, payload: int, size: int) -> int:
    """Estimated inter-device bytes ONE shard moves for one collective
    of per-shard payload ``payload`` on a ``size``-shard ring (JAX's
    ring formulas): all-reduce ``2 b (S-1)/S``; all-gather ``b (S-1)``;
    reduce-scatter and all-to-all ``b (S-1)/S``; ppermute ``b``. Size 1
    moves nothing."""
    if size <= 1:
        return 0
    s = int(size)
    if prim in REDUCTION_COLLECTIVES:
        return int(2 * payload * (s - 1) / s)
    if prim in ("all_gather", "pgather"):
        return int(payload * (s - 1))
    if prim in ("psum_scatter", "reduce_scatter", "all_to_all"):
        return int(payload * (s - 1) / s)
    return int(payload)                  # ppermute and anything else


def _ici_total(bucket: Dict[str, Dict[str, int]], size: int) -> int:
    return sum(ici_bytes_of(p, e["bytes"], size) for p, e in bucket.items())


def entry_of_census(census, size: int) -> Dict[str, Any]:
    """One manifest entry for one model x mesh size."""
    return {
        "tick-collectives": {p: census["tick"][p]["count"]
                             for p in sorted(census["tick"])},
        "tick-collective-bytes": sum(e["bytes"] for e in
                                     census["tick"].values()),
        "dispatch-collectives": {p: census["dispatch"][p]["count"]
                                 for p in sorted(census["dispatch"])},
        "ici-bytes-per-tick": _ici_total(census["tick"], size),
        "ici-bytes-per-dispatch": _ici_total(census["dispatch"], size),
    }


def size_key(workload: str, node_count: int, layout: str,
             size: int) -> str:
    return f"{cost_model.entry_key(workload, node_count, layout)}/s={size}"


# --- recording the sharded subjects -------------------------------------------


def trace_sharded_chunk(model, sim, size: int = CENSUS_TRACE_SIZE,
                        length: int = CENSUS_CHUNK_LEN):
    """The recorded graph of shard 0's chunk of the sharded executor
    (``mesh.shard_chunk`` at ``length`` ticks, ``size`` shards) on
    ``meta`` tensors, and the global wire template at ``size`` shards.
    """
    from ..parallel import mesh as mesh_mod
    g = mesh_mod.record_shard_chunk(model, sim, size, length=length)
    return g, mesh_mod.wire_template(model, sim, _SizedMesh(size))


def chunk_census(model, sim, size: int = CENSUS_TRACE_SIZE, cache=None):
    """The sharded chunk's census: the tick from the recorded tick
    variants (``cost_model.trace_variants``, on the shared cache), the
    dispatch from shard 0's chunk end (``mesh.shard_chunk`` recorded at
    zero ticks)."""
    from ..parallel import mesh as mesh_mod
    graphs = cost_model.trace_variants(model, sim, cache=cache)
    tick = _max_census(census_of_graph(g)["tick"] for g in graphs.values())
    end = mesh_mod.record_shard_chunk(model, sim, size, length=0)
    return {"tick": tick, "dispatch": census_of_graph(end)["tick"]}


def trace_sharded_run(model, sim, size: int = CENSUS_TRACE_SIZE,
                      cache=None):
    """The single-dispatch runner's census: the tick as
    :func:`chunk_census`'s, the dispatch the cross-shard reductions
    ``mesh.run_sim_sharded`` makes (``mesh.reduction_census``), taken
    by running it on ``size`` CPU shards for :data:`CENSUS_CHUNK_LEN`
    ticks with the merged telemetry asked for (the census counts the
    reductions and their shapes, not values)."""
    import torch
    from ..parallel import mesh as mesh_mod
    graphs = cost_model.trace_variants(model, sim, cache=cache)
    tick = _max_census(census_of_graph(g)["tick"] for g in graphs.values())
    short = sim._replace(n_ticks=CENSUS_CHUNK_LEN)
    with mesh_mod.reduction_census() as got:
        mesh_mod.run_sim_sharded(
            model, short, 0,
            mesh=mesh_mod.Mesh([torch.device("cpu")] * int(size)),
            return_telemetry=True)
    dispatch: Dict[str, Dict[str, int]] = {}
    for prim, nbytes in got:
        e = dispatch.setdefault(prim, {"count": 0, "bytes": 0})
        e["count"] += 1
        e["bytes"] += nbytes
    return {"tick": tick, "dispatch": dispatch}


# --- per-model findings -----------------------------------------------------


def _tick_budget(workload: str) -> Dict[str, int]:
    for prefix, budget in TICK_COLLECTIVE_BUDGETS.items():
        if workload.startswith(prefix):
            return budget
    return {}


def hot_loop_findings(model, census, label: str,
                      workload: str) -> List[Finding]:
    """SHD801 (budgeted reductions) and SHD803 (data movers) over one
    tick census."""
    path = _model_path(model)
    cls = type(model).__name__
    budget = _tick_budget(workload)
    out: List[Finding] = []
    for prim in sorted(census["tick"]):
        count = census["tick"][prim]["count"]
        payload = census["tick"][prim]["bytes"]
        if prim in DATA_COLLECTIVES:
            out.append(_finding(
                "SHD803", "cross-shard-dependence", SEV_ERROR, path, cls,
                f"[{label}] {prim} x{count} ({payload} B/tick payload) "
                f"in a shard's tick — a cross-shard data dependence on "
                f"the instance axis; shards must be independent by "
                f"construction (instances are pure functions of (seed, "
                f"global id)), so this either changes results with the "
                f"mesh size or serializes the shards every tick"))
        elif count > budget.get(prim, 0):
            out.append(_finding(
                "SHD801", "tick-hot-loop-collective", SEV_ERROR, path, cls,
                f"[{label}] {prim} x{count} ({payload} B/tick payload) "
                f"in a shard's tick exceeds the model's pinned budget of "
                f"{budget.get(prim, 0)} — a collective on every tick of "
                f"every shard; merge at the dispatch boundary (the "
                f"chunk-end snapshots of parallel/mesh.py) or pin the "
                f"budget in analysis/shard_audit.py with a "
                f"justification"))
    return out


def replicated_leaf_findings(model, sim, label: str) -> List[Finding]:
    """SHD802: every shard builds the model's params whole
    (``runtime.make_tick_fn``), the counterpart of JAX's replicated
    ``P()`` params; a leaf shaped like per-instance state wastes
    O(shards) memory."""
    import torch
    params = model.make_params(sim.net.n_nodes, torch.device("cpu"))
    if params is None:
        return []
    path = _model_path(model)
    cls = type(model).__name__
    out: List[Finding] = []
    for kp, leaf in cost_model.flatten_paths(params):
        shape = tuple(leaf.shape)
        nbytes = leaf.numel() * leaf.element_size()
        if (len(shape) >= 1 and shape[0] == sim.n_instances
                and nbytes >= SHD802_FLOOR_BYTES):
            out.append(_finding(
                "SHD802", "replicated-per-instance-leaf", SEV_ERROR, path,
                cls,
                f"[{label}] params leaf {kp or '<root>'} {shape} "
                f"({nbytes} B) is held whole by every shard (each builds "
                f"the params) but its leading dim equals the per-shard "
                f"instance count ({sim.n_instances}) — per-instance state "
                f"belongs in the sharded carry, not the params: every "
                f"device holds all of it (O(shards) waste) and it "
                f"silently stops scaling with the fleet"))
    return out


def reshard_findings(model, sim, label: str, from_shards: int = 4,
                     to_shards: Sequence[int] = (2, 1),
                     kinds: Optional[List[str]] = None) -> List[Finding]:
    """SHD809: drive ``checkpoint.reshard_carry`` over this model's wire
    template — kinds from ``mesh.wire_leaf_kinds`` (what ``state.npz``
    records), zero-filled leaves at ``from_shards`` — to each target
    and back. ``kinds`` overrides the recorded kinds (the tests' broken
    metadata)."""
    import numpy as np
    from .. import convert
    from ..campaign import checkpoint as ckpt
    from ..parallel import mesh as mesh_mod

    path = _model_path(model)
    cls = type(model).__name__

    def fail(msg):
        return [_finding("SHD809", "carry-not-reshardable", SEV_ERROR,
                         path, cls, f"[{label}] {msg}")]

    try:
        if kinds is None:
            kinds = mesh_mod.wire_leaf_kinds(model, sim)
        wire = mesh_mod.wire_template(model, sim, _SizedMesh(from_shards))
        leaves = [np.zeros(a.shape, a.dtype)
                  for _, a in convert.carry_leaves(wire)]
    except Exception as e:
        return fail(f"wire template / leaf kinds failed to build: "
                    f"{type(e).__name__}: {e}")
    if len(kinds) != len(leaves):
        return fail(f"wire_leaf_kinds records {len(kinds)} kinds but the "
                    f"wire carry has {len(leaves)} leaves — checkpoints "
                    f"written now cannot be resharded")
    meta = {"n-shards": from_shards,
            "instances-per-shard": int(sim.n_instances),
            "interleaved": True, "leaf-kinds": list(kinds)}
    for target in to_shards:
        try:
            new_leaves, new_meta = ckpt.reshard_carry(leaves, meta, target)
            back, _ = ckpt.reshard_carry(new_leaves, new_meta, from_shards)
        except Exception as e:
            return fail(f"reshard_carry {from_shards} -> {target} raised "
                        f"{type(e).__name__}: {e}")
        for i, (a, b) in enumerate(zip(leaves, back)):
            if a.shape != b.shape or a.dtype != b.dtype:
                return fail(
                    f"leaf {i} ({kinds[i]}) did not round-trip "
                    f"{from_shards} -> {target} -> {from_shards}: "
                    f"{a.shape}/{a.dtype} became {b.shape}/{b.dtype}")
    return []


def _verify_size_invariance(model, sim, workload: str,
                            sizes: Tuple[int, int]) -> List[Finding]:
    """The per-size manifest entries come from one census: sound only if
    the census is the same at every size, checked here on the donation
    subject's whole chunk recorded at two sizes."""
    a = census_of_graph(trace_sharded_chunk(model, sim, sizes[0])[0])
    b = census_of_graph(trace_sharded_chunk(model, sim, sizes[1])[0])
    if a == b:
        return []
    return [_finding(
        "SHD800", "shard-audit-failure", SEV_ERROR, _MESH_PATH,
        "shard_chunk",
        f"[{workload}] collective census differs between mesh sizes "
        f"{sizes[0]} and {sizes[1]} ({a} vs {b}) — the census is no "
        f"longer size-invariant, so the per-size manifest entries "
        f"derived from one recording are unsound; shard_audit.py must "
        f"record every size")]


# --- manifest io + drift gate -----------------------------------------------


def load_shard_manifest(path: Optional[str] = None) -> Dict[str, Any]:
    path = path or DEFAULT_SHARD_MANIFEST
    if not os.path.exists(path):
        return {"version": 1, "tolerance": DEFAULT_TOLERANCE,
                "entries": {}}
    with open(path) as f:
        data = json.load(f)
    data.setdefault("tolerance", DEFAULT_TOLERANCE)
    data.setdefault("entries", {})
    return data


def save_shard_manifest(entries: Dict[str, Dict[str, Any]],
                        path: Optional[str] = None,
                        tolerance: float = DEFAULT_TOLERANCE) -> str:
    path = path or DEFAULT_SHARD_MANIFEST
    payload = {
        "version": 1,
        "_comment": (
            "Per-model collective census and ICI estimate for `python -m "
            "maelstrom_tpu_torch lint --shard`. Keys: <workload>/"
            "n=<nodes>/<layout>/s=<mesh size> (plus run:* for the single-"
            "dispatch runner); tick-collectives = collectives in a "
            "shard's recorded tick (the heaviest tick variant), "
            "dispatch-collectives = the executor's cross-shard reductions "
            "at the dispatch boundary, ici-bytes-per-tick = estimated "
            "bytes one shard moves per tick (ring formulas, "
            "shard_audit.ici_bytes_of). Counts compare exactly; byte "
            "estimates drift within `tolerance`. Regenerate after an "
            "INTENTIONAL sharding change with `lint --shard "
            "--update-shard-manifest`; drift fails the gate (SHD807). "
            "torch-version records the toolchain: under another torch "
            "the gate downgrades drift to a re-record warning."),
        "torch-version": cost_model.toolchain(),
        "tolerance": tolerance,
        "entries": {k: entries[k] for k in sorted(entries)},
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")
    return path


def compare_manifest(live: Dict[str, Dict[str, Any]],
                     manifest: Dict[str, Any],
                     paths: Dict[str, Tuple[str, str]],
                     full_universe: bool = True,
                     errored: Set[str] = frozenset(),
                     ) -> List[Finding]:
    """SHD805/806/807: the live entries against the checked-in
    manifest; counts compare exactly, byte estimates within
    ``tolerance``."""
    entries = manifest.get("entries", {})
    tol = float(manifest.get("tolerance", DEFAULT_TOLERANCE))
    note = cost_model.toolchain_note(manifest.get("torch-version"),
                                     "the shard manifest",
                                     "--update-shard-manifest")
    findings: List[Finding] = []
    for key in sorted(live):
        ent = live[key]
        path, symbol = paths[key]
        base = entries.get(key)
        if base is None:
            findings.append(_finding(
                "SHD805", "shard-manifest-missing", SEV_ERROR, path,
                symbol,
                f"[{key}] no shard-manifest entry — record one with "
                f"`lint --shard --update-shard-manifest`"))
            continue
        drifts = []
        for field in ("tick-collectives", "dispatch-collectives"):
            want = base.get(field)
            if want is not None and want != ent[field]:
                drifts.append(f"{field}: live {ent[field]} vs manifest "
                              f"{want}")
        for field in ("ici-bytes-per-tick", "ici-bytes-per-dispatch",
                      "tick-collective-bytes"):
            want = base.get(field)
            got = ent[field]
            if want is None:
                continue
            if abs(got - want) > max(abs(want), 1) * tol:
                drifts.append(
                    f"{field}: live {got} vs manifest {want} "
                    f"({(got - want) / max(abs(want), 1) * 100:+.0f}%)")
        if drifts:
            findings.append(_finding(
                "SHD807", "shard-manifest-drift",
                SEV_WARNING if note else SEV_ERROR, path, symbol,
                f"[{key}] collective census / ICI estimate drifted from "
                f"the checked-in manifest: {'; '.join(drifts)} — the "
                f"sharded step's communication pattern changed; if "
                f"intentional, re-record with --update-shard-manifest "
                f"and justify it in the PR"
                + (f" ({note})" if note else "")))
    if full_universe:
        for key in sorted(set(entries) - set(live) - set(errored)):
            findings.append(_finding(
                "SHD806", "shard-manifest-stale", SEV_WARNING,
                _MANIFEST_REPO_PATH, "",
                f"[{key}] manifest entry matches no registered model x "
                f"mesh size — remove or re-record it"))
    return findings


# --- orchestration ----------------------------------------------------------


def run_shard_lint(repo_root: str = ".",
                   manifest_path: Optional[str] = None,
                   update_manifest: bool = False,
                   workloads: Optional[List[Tuple[str, int]]] = None,
                   mesh_sizes: Sequence[int] = MESH_SIZES,
                   include_fixtures: bool = True,
                   trace_cache=None) -> List[Finding]:
    """The shard pass: census and SHD8xx audit of every registered model
    x layout (or a restricted list), the runner subject, the manifest
    gate, the fixture sweep and the reshardability proof."""
    from ..models import get_model

    full = workloads is None
    specs = cost_model.cost_specs() if full else list(workloads)
    layouts = cost_model.AUDIT_LAYOUTS
    findings: List[Finding] = []
    live: Dict[str, Dict[str, Any]] = {}
    paths: Dict[str, Tuple[str, str]] = {}
    errored: Set[str] = set()
    cache = trace_cache if trace_cache is not None else {}

    for wl, n in specs:
        try:
            model = get_model(wl, n, "grid")
        except Exception as e:
            findings.append(_finding(
                "SHD800", "shard-audit-failure", SEV_ERROR,
                "maelstrom_tpu_torch/models/__init__.py", "get_model",
                f"get_model({wl!r}, {n}) raised: {e!r}"))
            errored.update(size_key(wl, n, lay, s)
                           for lay in layouts for s in mesh_sizes)
            continue
        for layout in layouts:
            label = cost_model.entry_key(wl, n, layout)
            sim = cost_model.audit_sim(model, n, layout)
            census = cache.get("shard:" + label)
            if census is None:
                try:
                    census = chunk_census(model, sim, cache=cache)
                except Exception as e:
                    findings.append(_finding(
                        "SHD800", "shard-audit-failure", SEV_ERROR,
                        _model_path(model), type(model).__name__,
                        f"[{label}] recording the sharded chunk raised "
                        f"{type(e).__name__}: {e}"))
                    errored.update(size_key(wl, n, layout, s)
                                   for s in mesh_sizes)
                    continue
                cache["shard:" + label] = census
            findings.extend(hot_loop_findings(model, census, label, wl))
            findings.extend(replicated_leaf_findings(model, sim, label))
            findings.extend(reshard_findings(model, sim, label))
            for s in mesh_sizes:
                key = size_key(wl, n, layout, s)
                live[key] = entry_of_census(census, s)
                paths[key] = (_model_path(model), type(model).__name__)

    if full:
        # the single-dispatch runner: its dispatch census pins the
        # fleet merge set (one psum per NetStats counter and the series)
        from .aot_audit import DONATION_WORKLOAD
        wl, n = DONATION_WORKLOAD
        try:
            model = get_model(wl, n, "grid")
            sim = cost_model.audit_sim(model, n, "lead")
            run_census = trace_sharded_run(model, sim, cache=cache)
            findings.extend(hot_loop_findings(
                model, run_census, f"run:{wl}/n={n}/lead", wl))
            findings.extend(_verify_size_invariance(
                model, sim, f"{wl}/n={n}", (CENSUS_TRACE_SIZE, 8)))
            for s in mesh_sizes:
                key = f"run:{size_key(wl, n, 'lead', s)}"
                live[key] = entry_of_census(run_census, s)
                paths[key] = (_MESH_PATH, "run_sim_sharded")
        except Exception as e:
            findings.append(_finding(
                "SHD800", "shard-audit-failure", SEV_ERROR, _MESH_PATH,
                "run_sim_sharded",
                f"[run:{wl}/n={n}] the sharded runner's census raised "
                f"{type(e).__name__}: {e}"))

    if full and include_fixtures:
        from ..models.ir_hazards import SHARD_FIXTURE_MODELS
        for kind, cls in sorted(SHARD_FIXTURE_MODELS.items()):
            model = cls()
            for layout in layouts:
                label = f"fixture-{kind}/{layout}"
                try:
                    sim = cost_model.audit_sim(model, 2, layout)
                    census = chunk_census(model, sim, cache=cache)
                except Exception as e:
                    findings.append(_finding(
                        "SHD800", "shard-audit-failure", SEV_ERROR,
                        _model_path(model), type(model).__name__,
                        f"[{label}] recording the fixture's sharded "
                        f"chunk raised {type(e).__name__}: {e}"))
                    continue
                findings.extend(hot_loop_findings(model, census, label,
                                                  kind))
                findings.extend(replicated_leaf_findings(model, sim,
                                                         label))

    if update_manifest:
        path = save_shard_manifest(live, manifest_path)
        findings.append(_finding(
            "SHD808", "shard-manifest-updated", SEV_INFO,
            os.path.relpath(path, os.path.abspath(repo_root))
            if os.path.isabs(path) else path, "",
            f"recorded {len(live)} shard-manifest entr"
            f"{'y' if len(live) == 1 else 'ies'}"))
    else:
        manifest = load_shard_manifest(manifest_path)
        findings.extend(compare_manifest(live, manifest, paths,
                                         full_universe=full,
                                         errored=errored))
    return findings


# --- bench surface ----------------------------------------------------------


def shard_stats(model, sim, mesh_size: int = 8,
                cache=None) -> Dict[str, int]:
    """The bench line's ``collectives_per_tick`` (collectives in a
    shard's tick under ``sim``) and ``ici_bytes_est`` (the per-tick ICI
    estimate at ``mesh_size`` shards). ``sim`` is the per-shard block;
    ``cache`` the shared trace cache (the census rides it under a
    ``shard:``-prefixed key of ``sim``'s own, which is not the audit
    config's)."""
    key = "shard-sim:" + cost_model.entry_key(
        getattr(model, "name", type(model).__name__), sim.net.n_nodes,
        sim.layout)
    census = cache.get(key) if cache is not None else None
    if census is None:
        census = chunk_census(model, sim, cache=cache)
        if cache is not None:
            cache[key] = census
    return {"collectives_per_tick": sum(e["count"]
                                        for e in census["tick"].values()),
            "ici_bytes_est": _ici_total(census["tick"], mesh_size)}
