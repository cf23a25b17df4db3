"""Orchestration for the port's ``lint``: run passes, apply the baseline.

Counterpart of ``maelstrom_tpu/analysis/runner.py``. ``run_lint`` is the
programmatic face of the CLI subcommand: pick passes, collect findings,
split them into live / baselined / stale, and hand back a
:class:`~.findings.LintReport`. Exit-code policy lives in
``__main__.cmd_lint``: ``--strict`` fails on any unsuppressed
error-severity finding. The JAX package's opt-in jaxpr passes (``ir``,
``cost``, ``lanes``, ``ranges``, ``shard``, ``aot``) lower JAX IR, which
the eager port does not have; the CLI refuses them by name.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

from .findings import (Baseline, DEFAULT_BASELINE, Finding, LintReport,
                       sort_findings)

ALL_PASSES = ("trace", "contract", "schema")


def run_lint(repo_root: str = ".",
             passes: Optional[Sequence[str]] = None,
             paths: Optional[List[str]] = None,
             baseline_path: Optional[str] = DEFAULT_BASELINE,
             ) -> LintReport:
    """Run the requested passes and fold in the baseline.

    ``passes=None`` means every pass (trace/contract/schema) — unless
    ``paths`` restricts the run to explicit files, in which case only
    the trace pass runs by default (pointing the linter at a file means
    "lint this file", not "re-audit the world"). Passes named explicitly
    always run. ``baseline_path=None`` disables baseline suppression
    entirely.
    """
    repo_root = os.path.abspath(repo_root)
    findings: List[Finding] = []
    if passes is not None:
        effective = tuple(passes)
    elif paths is not None:
        effective = ("trace",)
    else:
        effective = ALL_PASSES
    unknown = [p for p in effective if p not in ALL_PASSES]
    if unknown:
        raise ValueError(f"unknown lint pass(es) {unknown}; the port has "
                         f"{list(ALL_PASSES)}")

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
    # stale would tell the user to delete live entries
    full_scope = set(ALL_PASSES) <= set(effective) and paths is None
    return LintReport(findings=live, suppressed=suppressed,
                      stale=baseline.stale_entries(set(effective))
                      if full_scope else [],
                      files_scanned=files_scanned,
                      passes_run=effective)
