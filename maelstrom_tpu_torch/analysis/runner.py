"""Orchestration for the port's ``lint``: run passes, apply the baseline.

Counterpart of ``maelstrom_tpu/analysis/runner.py``. ``run_lint`` is the
programmatic face of the CLI subcommand: pick passes, collect findings,
split them into live / baselined / stale, and hand back a
:class:`~.findings.LintReport`. Exit-code policy lives in
``__main__.cmd_lint``: ``--strict`` fails on any unsuppressed
error-severity finding. The opt-in passes run only when named: those
over the aten graph of the tick (``ir``, ``cost``, ``lanes``,
``ranges``), the shard pass over the mesh executor (``shard``) and the
audit of the kernel-library store (``aot``).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

from .findings import (Baseline, DEFAULT_BASELINE, Finding, LintReport,
                       sort_findings)

ALL_PASSES = ("trace", "contract", "schema")

# opt-in passes: the IR hazard audit, the cost gate, the lane-liveness
# slice, the value-range interpreter and the shard pass record every
# registered model, and the aot pass its subjects' chunk dispatches
# (tens of seconds to minutes), so they run only when named (`--ir` /
# `--cost` / `--lanes` / `--ranges` / `--shard` / `--aot` / `--pass
# ir`), never as part of the default sweep
EXTRA_PASSES = ("ir", "cost", "lanes", "ranges", "shard", "aot")


def run_lint(repo_root: str = ".",
             passes: Optional[Sequence[str]] = None,
             paths: Optional[List[str]] = None,
             baseline_path: Optional[str] = DEFAULT_BASELINE,
             cost_baseline_path: Optional[str] = None,
             update_cost_baseline: bool = False,
             lane_manifest_path: Optional[str] = None,
             update_lane_manifest: bool = False,
             range_manifest_path: Optional[str] = None,
             update_range_manifest: bool = False,
             ranges_horizon_log2: Optional[int] = None,
             shard_manifest_path: Optional[str] = None,
             update_shard_manifest: bool = False,
             aot_manifest_path: Optional[str] = None,
             update_aot_manifest: bool = False,
             aot_store_path: Optional[str] = None,
             ) -> LintReport:
    """Run the requested passes and fold in the baseline.

    ``passes=None`` means every default pass (trace/contract/schema;
    the ir, cost and lanes passes are opt-in) — unless ``paths``
    restricts the run to explicit files, in which case only the trace
    pass runs by default (pointing the linter at a file means "lint this
    file", not "re-audit the world"). Passes named explicitly always
    run. ``baseline_path=None`` disables baseline suppression entirely.
    ``cost_baseline_path`` / ``update_cost_baseline`` parameterize the
    cost pass (``analysis/cost_baseline.json`` by default);
    ``lane_manifest_path`` / ``update_lane_manifest`` the lanes pass
    (``analysis/lane_manifest.json``); ``range_manifest_path`` /
    ``update_range_manifest`` / ``ranges_horizon_log2`` the ranges pass
    (``analysis/range_manifest.json``; the horizon override probes a
    synthetic budget); ``shard_manifest_path`` /
    ``update_shard_manifest`` the shard pass
    (``analysis/shard_manifest.json``); ``aot_manifest_path`` /
    ``update_aot_manifest`` / ``aot_store_path`` the aot pass
    (``analysis/aot_manifest.json``, the store it audits or, updating,
    populates).
    """
    repo_root = os.path.abspath(repo_root)
    findings: List[Finding] = []
    if passes is not None:
        effective = tuple(passes)
    elif paths is not None:
        effective = ("trace",)
    else:
        effective = ALL_PASSES
    unknown = [p for p in effective
               if p not in ALL_PASSES + EXTRA_PASSES]
    if unknown:
        raise ValueError(f"unknown lint pass(es) {unknown}; the port has "
                         f"{list(ALL_PASSES + EXTRA_PASSES)}")

    files_scanned = 0
    if "trace" in effective:
        from .trace_lint import default_trace_targets, run_trace_lint
        targets = paths if paths else default_trace_targets(repo_root)
        files_scanned += len(targets)
        findings.extend(run_trace_lint(repo_root, paths=targets))
    if "contract" in effective:
        from .contract_audit import run_contract_audit
        findings.extend(run_contract_audit(repo_root))
    if "schema" in effective:
        from .schema_lint import run_schema_lint
        findings.extend(run_schema_lint(repo_root))
    # the ir/cost, lanes and ranges passes each trace every registered
    # model; a shared cache makes the combined gate pay that sweep once
    trace_cache: dict = {}
    if "ir" in effective or "cost" in effective:
        from .ir_lint import run_ir_lint
        findings.extend(run_ir_lint(
            repo_root,
            hazards="ir" in effective,
            cost="cost" in effective,
            cost_baseline_path=cost_baseline_path,
            update_baseline=update_cost_baseline,
            trace_cache=trace_cache))
    # the ranges pass's workers analyze while the lanes pass runs here
    finish_ranges = None
    if "ranges" in effective:
        from .absint import start_range_lint
        finish_ranges = start_range_lint(
            repo_root,
            manifest_path=range_manifest_path,
            update_manifest=update_range_manifest,
            trace_cache=trace_cache,
            probe_log2=ranges_horizon_log2)
    if "lanes" in effective:
        from .lane_liveness import run_lane_lint
        findings.extend(run_lane_lint(
            repo_root,
            manifest_path=lane_manifest_path,
            update_manifest=update_lane_manifest,
            trace_cache=trace_cache))
    if "shard" in effective:
        from .shard_audit import run_shard_lint
        findings.extend(run_shard_lint(
            repo_root,
            manifest_path=shard_manifest_path,
            update_manifest=update_shard_manifest,
            trace_cache=trace_cache))
    if "aot" in effective:
        from .aot_audit import run_aot_lint
        findings.extend(run_aot_lint(
            repo_root,
            manifest_path=aot_manifest_path,
            update_manifest=update_aot_manifest,
            store_path=aot_store_path,
            trace_cache=trace_cache))
    if finish_ranges is not None:
        findings.extend(finish_ranges())

    baseline = (Baseline.load(baseline_path) if baseline_path
                else Baseline())
    live, suppressed = [], []
    for f in sort_findings(findings):
        entry = baseline.match(f)
        if entry is not None:
            suppressed.append((f, entry))
        else:
            live.append(f)
    # staleness is only meaningful for a full-scope run: a partial
    # invocation (--pass / explicit paths) never sees the findings that
    # out-of-scope baseline entries suppress, and reporting those as
    # stale would tell the user to delete live entries. Staleness is
    # also pass-scoped (findings.fingerprint_pass): a default run must
    # not report the ir/cost/lanes/ranges/shard/aot entries as stale
    # just because those opt-in passes did not run.
    full_scope = set(ALL_PASSES) <= set(effective) and paths is None
    return LintReport(findings=live, suppressed=suppressed,
                      stale=baseline.stale_entries(set(effective))
                      if full_scope else [],
                      files_scanned=files_scanned,
                      passes_run=effective)
