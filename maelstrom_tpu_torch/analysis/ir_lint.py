"""IR-level hazard lint + cost gate: ``lint --ir --cost``.

Counterpart of ``maelstrom_tpu/analysis/ir_lint.py``, over the port's
aten graph of the tick (``cost_model.TickGraph``, one per tick variant)
instead of a jaxpr. The trace pass (TRC1xx) and the contract audit
(CON2xx) police the *Python* surface of the tick; this pass polices
the operators it actually dispatches, for every registered model on
``meta`` tensors (no device, no values).

Rules (JXP4xx — hazards; COST5xx — the cost budget):

=======  =========================  ========  =============================
rule     name                       severity  what it flags
=======  =========================  ========  =============================
JXP400   ir-trace-failure           error     the tick failed to trace
JXP401   dtype-widening-leak        error     a carry leaf that is not int32
                                              (bit-identity and replay
                                              across platforms assume
                                              integer state), or a 64-bit
                                              output of an operator of the
                                              tick, per issuing function
JXP402   host-round-trip            error     a host read inside the tick
                                              (``.item()``, ``int()``, a
                                              Python branch or index on a
                                              tensor, ``.tolist()``, a
                                              value-dependent shape): on
                                              ``meta`` tensors it raises,
                                              and the trace failure whose
                                              cause is a host read is
                                              reported here, not as JXP400
JXP404   fusion-breaker             warning   a materialised broadcast
                                              larger than 8x the carry and
                                              1 MiB
JXP405   baked-in-constant          warning   a tensor constant of 64 KiB
                                              or more read by the tick
COST500  cost-baseline-updated      info      ``--update-baseline``
                                              rewrote the baseline
COST501  cost-regression            error     operators or output bytes per
                                              tick regressed > tolerance
                                              (10%) vs
                                              ``cost_baseline.json``
COST502  cost-baseline-missing      error     a registered model has no
                                              baseline entry
COST503  cost-baseline-stale        warning   a baseline entry matches no
                                              registered model
COST504  cost-improvement           info      a model got > tolerance
                                              cheaper — refresh the
                                              baseline to bank the win
COST505  scope-coverage-regression  error     operators outside every known
                                              phase grew past the baseline
                                              unattributed-eqns budget
=======  =========================  ========  =============================

Where it differs from the JAX pass:

- **JXP401** keeps JAX's carry half as it is (every carry leaf int32;
  the port's int64 master key is an accepted baseline entry with its
  reason). The in-tick half is one finding per issuing function
  (``cost_model.TNode.site``), so that each site of the RNG's uint32
  emulation, of torch's int64 index tensors or of anything else is
  accepted, or fixed, on its own reason.
- **JXP403** (donation) has no counterpart: the port's executors donate
  nothing and compile nothing, so ``--ir`` emits no JXP403.
- **JXP404** keeps only its broadcast half. Its loop half counts loops
  in the compiled tick; eager Python loops unroll into the graph, so
  there is no loop to count (``CostReport.loops`` is always 0).

The IR-hazard fixtures (``models/ir_hazards.py``) are audited alongside
the registered models; their findings are ``expected`` entries in
``analysis/baseline.json``, asserted by ``tests/test_torch_ir.py``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import cost_model
from .cost_model import CostReport
from .findings import Finding, SEV_ERROR, SEV_INFO, SEV_WARNING

PASS_IR = "ir"
PASS_COST = "cost"

# the runtime's bit-identity envelope: every carry leaf must be one of
# these
ALLOWED_CARRY_DTYPES = ("int32", "uint32")

# the carry leaves the runtime itself owns (the rest are the model's:
# node_state and its snapshot slab)
_RUNTIME_CARRY_FIELDS = ("pool", "client_state", "stats", "violations",
                         "key", "telemetry", "fault_sched",
                         "check_summary")

# what a host read on meta tensors raises with
HOST_READ_MARKERS = (
    "cannot be called on meta tensors",
    "Cannot copy out of meta tensor",
    "can't convert meta device type tensor to numpy",
    "raises unimplemented by default, as a correct data-independent "
    "implementation does not exist",
)

# JXP404 thresholds: a broadcast intermediate larger than BOTH of these
# is flagged (the floor keeps tiny audit-config carries from making
# every legitimate [I, N, N] broadcast look oversized)
BROADCAST_CARRY_MULT = 8
BROADCAST_FLOOR_BYTES = 1 << 20          # 1 MiB

# JXP405 threshold
CONST_WARN_BYTES = 64 << 10              # 64 KiB

_RUNTIME_PATH = "maelstrom_tpu_torch/runtime.py"


def _model_path(model) -> str:
    return type(model).__module__.replace(".", os.sep) + ".py"


def _finding(rule, name, severity, path, symbol, message,
             pass_name=PASS_IR) -> Finding:
    return Finding(rule=rule, name=name, severity=severity,
                   pass_name=pass_name, path=path, line=0,
                   symbol=symbol, message=message)


def is_host_read(e: BaseException) -> bool:
    """Whether a trace failure on ``meta`` tensors is a host read."""
    msg = str(e)
    return any(m in msg for m in HOST_READ_MARKERS)


# --- per-model hazard audit ------------------------------------------------


def audit_model_ir(model, node_count: int, layout: str = "lead",
                   label: Optional[str] = None, trace_cache=None,
                   ) -> Tuple[List[Finding], Optional[CostReport]]:
    """Trace one model's tick (every variant) and audit the graphs.
    Returns (findings, cost report): the report is reused by the cost
    pass and the lanes pass, so each model is traced once per variant
    per run."""
    label = label or getattr(model, "name", type(model).__name__)
    label = f"{label}/{layout}"
    path = _model_path(model)
    cls = type(model).__name__
    findings: List[Finding] = []

    def flag(rule, name, message, severity=SEV_ERROR, symbol=cls,
             where=path):
        findings.append(_finding(rule, name, severity, where, symbol,
                                 f"[{label}] {message}"))

    try:
        sim = cost_model.audit_sim(model, node_count, layout)
        graphs = cost_model.trace_variants(model, sim, cache=trace_cache)
    except Exception as e:
        if is_host_read(e):
            flag("JXP402", "host-round-trip",
                 f"a host read inside the tick: tracing it on meta "
                 f"tensors raised {type(e).__name__}: {e} — on the card "
                 f"the issuing thread waits for the device every tick")
        else:
            flag("JXP400", "ir-trace-failure",
                 f"tracing the tick raised {type(e).__name__}: {e}")
        return findings, None
    report = cost_model.cost_of_variants(graphs)
    if trace_cache is not None:
        # leave the report next to the shared traces so the lanes pass
        # skips the duplicate byte walk in the combined gate
        trace_cache[cost_model.entry_key(
            getattr(model, "name", type(model).__name__), node_count,
            layout) + "::cost"] = report

    # JXP401a: carry leaves outside the integer envelope (the output
    # carry is authoritative: it is what the next tick reads)
    g = next(iter(graphs.values()))
    for p, v in zip(g.output_paths[:g.n_carry_out],
                    g.outputs[:g.n_carry_out]):
        dt = cost_model._dtype_name(g.values[v].dtype)
        if dt in ALLOWED_CARRY_DTYPES:
            continue
        field_name = p.split(".")[1].split("[")[0]
        if field_name in _RUNTIME_CARRY_FIELDS:
            where, symbol = _RUNTIME_PATH, f"Carry.{field_name}"
        else:
            where, symbol = path, cls
        flag("JXP401", "dtype-widening-leak",
             f"carry leaf {p} is {dt} — the carry must stay int32 "
             f"(bit-identity and replay across platforms assume integer "
             f"state)", symbol=symbol, where=where)
    # JXP401b: 64-bit outputs of the tick's operators, per issuing
    # function
    for (site_path, fn), n in sorted(report.wide_sites.items()):
        flag("JXP401", "dtype-widening-leak",
             f"{n} operator(s) issued by {fn} produce 64-bit values "
             f"(twice the bytes of int32, and the card's int64 "
             f"arithmetic is emulated on 32-bit units)",
             symbol=fn, where=site_path)

    # JXP404: an oversized materialised broadcast
    carry = max(report.carry_bytes, 1)
    bcast_limit = max(BROADCAST_CARRY_MULT * carry, BROADCAST_FLOOR_BYTES)
    if report.max_broadcast_bytes > bcast_limit:
        flag("JXP404", "fusion-breaker", severity=SEV_WARNING,
             message=f"a materialised broadcast is "
                     f"{report.max_broadcast_bytes} B — "
                     f"{report.max_broadcast_bytes // carry}x the "
                     f"{report.carry_bytes} B carry (written to "
                     f"device memory and read back by its consumers)")

    # JXP405: baked-in constants
    if report.max_const_bytes >= CONST_WARN_BYTES:
        flag("JXP405", "baked-in-constant", severity=SEV_WARNING,
             message=f"largest tensor constant read by the tick is "
                     f"{report.max_const_bytes} B "
                     f"({report.const_bytes} B total) — copied to the "
                     f"device with every run and invisible to the "
                     f"carry; pass it as params instead")
    return findings, report


# --- the cost gate ---------------------------------------------------------


def compare_costs(live: Dict[str, CostReport],
                  baseline: Dict[str, Any],
                  paths: Dict[str, Tuple[str, str]],
                  full_universe: bool = True) -> List[Finding]:
    """Diff live cost reports against the checked-in baseline: a
    faithful copy of the JAX gate, its rules, tolerance and messages
    (the messages name JAX's CLI and scopes; the port's ``lint --cost
    --update-baseline`` and phase marks are their counterparts).
    ``paths`` maps entry key -> (repo path, class symbol) for finding
    locations; ``full_universe`` gates stale-entry reporting (a
    restricted audit never sees every key)."""
    tol = float(baseline.get("tolerance", cost_model.DEFAULT_TOLERANCE))
    entries = baseline.get("entries", {})
    # the recorded toolchain: under another torch the traced graphs
    # legitimately differ, so drift downgrades from a hard COST501
    # failure to a self-explaining re-record warning
    note = cost_model.toolchain_note(baseline.get("torch-version"),
                                     "the cost baseline")
    findings: List[Finding] = []
    for key in sorted(live):
        rep = live[key]
        path, symbol = paths[key]
        base = entries.get(key)
        if base is None:
            findings.append(_finding(
                "COST502", "cost-baseline-missing", SEV_ERROR, path,
                symbol,
                f"[{key}] no cost-baseline entry — record one with "
                f"`maelstrom lint --cost --update-baseline`",
                pass_name=PASS_COST))
            continue
        regressions = []
        for field_name, got, want in (
                ("eqns", rep.eqns, base.get("eqns")),
                ("hbm-bytes-per-tick", rep.hbm_bytes,
                 base.get("hbm-bytes-per-tick"))):
            if want is None or want <= 0:
                continue
            if got > want * (1 + tol):
                regressions.append((field_name, got, want))
        if regressions:
            worst = _worst_phase_delta(rep.phases, base.get("phases", {}))
            detail = "; ".join(
                f"{f}: {got} vs baseline {want} "
                f"(+{(got / want - 1) * 100:.0f}%)"
                for f, got, want in regressions)
            findings.append(_finding(
                "COST501", "cost-regression",
                SEV_WARNING if note else SEV_ERROR, path, symbol,
                f"[{key}] tick cost regressed past the {tol:.0%} "
                f"budget: {detail}{worst} — make the change cheaper, "
                f"or re-baseline with --update-baseline and justify it "
                f"in the PR" + (f" ({note})" if note else ""),
                pass_name=PASS_COST))
        elif (rep.eqns < base.get("eqns", 0) * (1 - tol)
              and rep.hbm_bytes <= base.get("hbm-bytes-per-tick",
                                            rep.hbm_bytes)):
            findings.append(_finding(
                "COST504", "cost-improvement", SEV_INFO, path, symbol,
                f"[{key}] tick got cheaper: eqns {rep.eqns} vs baseline "
                f"{base['eqns']} — run --update-baseline to bank the "
                f"win", pass_name=PASS_COST))
        # the scope-coverage gate (COST505): eqns the device-time
        # profiler cannot attribute to a known named scope must not
        # grow past the recorded budget — that's how a refactor that
        # drops/renames a jax.named_scope gets caught statically.
        # Entries recorded before the column existed carry no budget
        # and are skipped (re-record with --update-baseline).
        ua_base = base.get("unattributed-eqns")
        if ua_base is not None \
                and rep.unattributed_eqns > ua_base * (1 + tol):
            renamed = (f"; unknown scope roots seen: "
                       f"{', '.join(rep.unknown_scopes)}"
                       if rep.unknown_scopes else "")
            findings.append(_finding(
                "COST505", "scope-coverage-regression",
                SEV_WARNING if note else SEV_ERROR, path, symbol,
                f"[{key}] {rep.unattributed_eqns} fused-tick eqns "
                f"outside every known named scope vs baseline budget "
                f"{ua_base} (+{rep.unattributed_eqns - ua_base}) — a "
                f"refactor likely dropped or renamed a "
                f"jax.named_scope, so device-time attribution "
                f"(telemetry/profiler.py) goes blind there{renamed}; "
                f"restore the scope or re-record with "
                f"--update-baseline and justify it in the PR"
                + (f" ({note})" if note else ""),
                pass_name=PASS_COST))
    if full_universe:
        for key in sorted(set(entries) - set(live)):
            findings.append(_finding(
                "COST503", "cost-baseline-stale", SEV_WARNING,
                "maelstrom_tpu_torch/analysis/cost_baseline.json", "",
                f"[{key}] baseline entry matches no registered "
                f"model x layout — remove or re-record it"
                + (f" ({note})" if note else ""),
                pass_name=PASS_COST))
    return findings


def _worst_phase_delta(live_phases: Dict[str, int],
                       base_phases: Dict[str, int]) -> str:
    worst, delta = None, 0
    for ph in set(live_phases) | set(base_phases):
        d = live_phases.get(ph, 0) - base_phases.get(ph, 0)
        if d > delta:
            worst, delta = ph, d
    return f" (worst phase: {worst} +{delta} eqns)" if worst else ""


# --- orchestration ---------------------------------------------------------


def run_ir_lint(repo_root: str = ".", hazards: bool = True,
                cost: bool = False,
                cost_baseline_path: Optional[str] = None,
                update_baseline: bool = False,
                workloads: Optional[List[Tuple[str, int]]] = None,
                layouts: Sequence[str] = cost_model.AUDIT_LAYOUTS,
                include_fixtures: bool = True,
                trace_cache=None) -> List[Finding]:
    """Run the IR hazard pass and/or the cost gate.

    ``workloads=None`` audits the full registered universe (plus the IR
    fixtures); a restricted list skips fixtures and stale reporting —
    pointing the analyzer at a model means "audit this model", not
    "re-audit the world".
    """
    from ..models import get_model

    full = workloads is None
    specs = cost_model.cost_specs() if full else list(workloads)
    findings: List[Finding] = []
    live: Dict[str, CostReport] = {}
    paths: Dict[str, Tuple[str, str]] = {}

    for wl, n in specs:
        try:
            model = get_model(wl, n, "grid")
        except Exception as e:
            findings.append(_finding(
                "JXP400", "ir-trace-failure", SEV_ERROR,
                "maelstrom_tpu_torch/models/__init__.py", "get_model",
                f"get_model({wl!r}, {n}) raised: {e!r}"))
            continue
        for layout in layouts:
            fs, report = audit_model_ir(model, n, layout,
                                        label=f"{wl}/n={n}",
                                        trace_cache=trace_cache)
            if hazards:
                findings.extend(fs)
            else:
                # a tick that no longer traces is fatal for the cost
                # pass too: without this a cost-only run would drop the
                # broken model from `live` and misreport it as a stale
                # entry (or, with --update-baseline, delete its budget)
                findings.extend(f for f in fs
                                if f.rule in ("JXP400", "JXP402"))
            if report is not None:
                key = cost_model.entry_key(wl, n, layout)
                live[key] = report
                paths[key] = (_model_path(model), type(model).__name__)

    if hazards and full and include_fixtures:
        from ..models.ir_hazards import IR_FIXTURE_MODELS
        for kind, cls in sorted(IR_FIXTURE_MODELS.items()):
            fs, _ = audit_model_ir(cls(), 2, "lead",
                                   label=f"fixture-{kind}")
            findings.extend(fs)

    if cost:
        if update_baseline:
            path = cost_model.save_cost_baseline(
                {k: r.to_entry() for k, r in live.items()},
                cost_baseline_path)
            findings.append(_finding(
                "COST500", "cost-baseline-updated", SEV_INFO,
                os.path.relpath(path, os.path.abspath(repo_root))
                if os.path.isabs(path) else path, "",
                f"recorded {len(live)} cost-baseline entr"
                f"{'y' if len(live) == 1 else 'ies'}",
                pass_name=PASS_COST))
        else:
            baseline = cost_model.load_cost_baseline(cost_baseline_path)
            findings.extend(compare_costs(live, baseline, paths,
                                          full_universe=full))
    return findings
