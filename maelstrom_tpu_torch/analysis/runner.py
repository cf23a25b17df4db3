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
import sys
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

# the tick passes' per-model work (the tick variants recorded, then the
# lanes and ranges analyses of them: ~8 s a model and layout on the
# CPU, 48 of them) runs in this many spawned workers while the default
# passes run in the calling process; a run of fewer than twice as many
# models does it all in the passes
STATIC_WORKERS = 4


class _TritonProbe:
    """A meta-path finder that notes the file whose import first asked
    for ``triton``; it finds nothing itself."""
    asked_by: Optional[str] = None

    def find_spec(self, name, path=None, target=None):
        if name == "triton" and _TritonProbe.asked_by is None:
            f = sys._getframe(1)
            while f is not None and (
                    "importlib" in f.f_code.co_filename
                    or f.f_code.co_filename.startswith("<frozen")):
                f = f.f_back
            _TritonProbe.asked_by = f.f_code.co_filename if f else "?"
        return None


def watch_imports() -> None:
    """The probe first on the import path (the static workers'
    initializer)."""
    sys.meta_path.insert(0, _TritonProbe())


def process_state() -> dict:
    """What this process holds that the lint must never need: a CUDA
    context, a kernel library, ``triton`` (and the file that first asked
    for it, where the probe watches) and modules of JAX or the JAX
    package."""
    import torch
    from ..kernels import build
    return {"pid": os.getpid(),
            "cuda-initialized": torch.cuda.is_initialized(),
            "kernel-libraries": sorted(build._loaded),
            "triton-imported": "triton" in sys.modules,
            "triton-importer": _TritonProbe.asked_by,
            "jax-modules": sorted(m for m in sys.modules
                                  if m.split(".")[0] in ("jax",
                                                         "maelstrom_tpu"))}


def merge_states(states: Sequence[dict], lost: int = 0) -> dict:
    """The static workers' :func:`process_state` after each job, as one
    record: the jobs and processes that reported, the jobs lost with a
    worker, and the union of what any of them held."""
    return {"jobs": len(states), "lost-jobs": lost,
            "processes": len({s["pid"] for s in states}),
            "cuda-initialized": any(s["cuda-initialized"] for s in states),
            "kernel-libraries": sorted({k for s in states
                                        for k in s["kernel-libraries"]}),
            "triton-imported": any(s["triton-imported"] for s in states),
            "triton-importers": sorted({s["triton-importer"] for s in states
                                        if s["triton-importer"]}),
            "jax-modules": sorted({m for s in states
                                   for m in s["jax-modules"]})}


def _static_job(spec, n: int, layout: str, label: str, lanes: bool,
                ranges: bool, probe_log2: Optional[int]) -> dict:
    """One model in one layout at the audit config, in a worker: under
    ``graphs`` its recorded graphs by ``cost_model.trace_tick`` key,
    under ``lanes`` its lanes report, under ``ranges`` the ranges pass's
    ``absint.range_job`` result, and under ``process`` the worker's
    :func:`process_state` after the job. ``spec`` is ``("workload",
    name)`` or a ranges fixture ``("fixture", kind)``. What does not
    build, record or analyze is None: the pass that needs it does it
    again and reports why."""
    from . import absint, cost_model, lane_liveness
    out = {"graphs": {}, "lanes": None, "ranges": None}
    try:
        if spec[0] == "workload":
            from ..models import get_model
            model = get_model(spec[1], n, "grid")
        else:
            from ..models.ir_hazards import RANGE_FIXTURE_MODELS
            model = RANGE_FIXTURE_MODELS[spec[1]]()
        cost_model.trace_variants(model, cost_model.audit_sim(
            model, n, layout), cache=out["graphs"])
    except Exception:
        out["graphs"] = {}
    else:
        if lanes:
            try:
                out["lanes"] = lane_liveness.analyze_model(
                    model, n, layout, label=label,
                    trace_cache=out["graphs"])
            except Exception:
                pass
        if ranges:
            out["ranges"] = absint.range_job(spec, n, layout, label,
                                             out["graphs"], probe_log2)
    out["process"] = process_state()
    return out


def start_static_jobs(effective: Sequence[str], trace_cache: dict,
                      probe_log2: Optional[int]):
    """Start :func:`_static_job` for every registered model x layout
    (and the ranges fixtures) that the ``effective`` passes read, in
    :data:`STATIC_WORKERS` spawned workers. Returns the call that waits
    for them, puts their graphs into ``trace_cache`` and returns their
    lanes reports by entry key (``"lanes"``), ranges results by label
    (``"ranges"``) and :func:`merge_states` of the workers
    (``"workers"``, None where no worker ran); with ``cancel=True`` it
    drops what has not started and keeps nothing."""
    from . import cost_model
    lanes, ranges = "lanes" in effective, "ranges" in effective
    jobs = [(("workload", wl), n, lay, cost_model.entry_key(wl, n, lay))
            for wl, n in cost_model.cost_specs()
            for lay in cost_model.AUDIT_LAYOUTS]
    if ranges:
        from ..models.ir_hazards import RANGE_FIXTURE_MODELS
        jobs += [(("fixture", kind), 2, lay, f"fixture-{kind}/{lay}")
                 for kind in sorted(RANGE_FIXTURE_MODELS)
                 for lay in cost_model.AUDIT_LAYOUTS]
    if len(jobs) < 2 * STATIC_WORKERS:
        return lambda cancel=False: {"lanes": {}, "ranges": {},
                                     "workers": None}
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from concurrent.futures.process import BrokenProcessPool
    pool = ProcessPoolExecutor(
        max_workers=STATIC_WORKERS,
        mp_context=multiprocessing.get_context("spawn"),
        initializer=watch_imports)
    try:
        futures = [pool.submit(_static_job, *job, lanes, ranges, probe_log2)
                   for job in jobs]
    except BaseException:
        pool.shutdown(cancel_futures=True)
        raise

    def wait(cancel=False):
        got = {"lanes": {}, "ranges": {}, "workers": None}
        states, lost = [], 0
        try:
            for job, f in zip(jobs, [] if cancel else futures):
                try:
                    out = f.result()
                except BrokenProcessPool:
                    # a lost worker: the passes do what it held
                    lost += 1
                    continue
                trace_cache.update(out["graphs"])
                label = job[-1]
                if out["lanes"] is not None:
                    got["lanes"][label] = out["lanes"]
                if out["ranges"] is not None:
                    got["ranges"][label] = out["ranges"]
                states.append(out["process"])
        finally:
            pool.shutdown(cancel_futures=True)
        if not cancel:
            got["workers"] = merge_states(states, lost)
        return got
    return wait


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

    # the ir/cost, lanes, ranges and shard passes read the tick of every
    # registered model x layout: one shared cache, filled (and the lanes
    # and ranges analyses done) by the static workers while the default
    # passes run here
    trace_cache: dict = {}
    finish_static = None
    if set(effective) & {"ir", "cost", "lanes", "ranges", "shard"}:
        finish_static = start_static_jobs(effective, trace_cache,
                                          ranges_horizon_log2)

    files_scanned = 0
    try:
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
    except BaseException:
        if finish_static is not None:
            finish_static(cancel=True)
        raise
    static = (finish_static() if finish_static is not None
              else {"lanes": {}, "ranges": {}, "workers": None})
    if "ir" in effective or "cost" in effective:
        from .ir_lint import run_ir_lint
        findings.extend(run_ir_lint(
            repo_root,
            hazards="ir" in effective,
            cost="cost" in effective,
            cost_baseline_path=cost_baseline_path,
            update_baseline=update_cost_baseline,
            trace_cache=trace_cache))
    if "ranges" in effective:
        from .absint import run_range_lint
        findings.extend(run_range_lint(
            repo_root,
            manifest_path=range_manifest_path,
            update_manifest=update_range_manifest,
            trace_cache=trace_cache,
            probe_log2=ranges_horizon_log2,
            reports=static["ranges"]))
    if "lanes" in effective:
        from .lane_liveness import run_lane_lint
        findings.extend(run_lane_lint(
            repo_root,
            manifest_path=lane_manifest_path,
            update_manifest=update_lane_manifest,
            trace_cache=trace_cache,
            reports=static["lanes"]))
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
                      passes_run=effective,
                      static_workers=static["workers"])
