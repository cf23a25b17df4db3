"""Finding model + baseline bookkeeping for the port's ``lint``.

A copy of ``maelstrom_tpu/analysis/findings.py`` (the port imports
nothing of the JAX package); its default baseline is the port's own
``maelstrom_tpu_torch/analysis/baseline.json``.

A :class:`Finding` is one lint result: a rule id, a severity, a location
(repo-relative path + line), the enclosing symbol, and a line-free
message. Findings serialize to JSON (machine consumers / the checked-in
baseline) and render as severity-colored text (humans).

The baseline (``baseline.json`` beside this module) is the escape hatch demanded
by the lint workflow: every error-severity finding on the *current* tree
must either be fixed or be listed there with a one-line justification.
Entries match findings by **fingerprint** — ``rule:path:symbol``,
deliberately excluding line numbers so unrelated edits don't invalidate
the baseline. Two entry statuses exist:

- ``accepted`` — justified debt (e.g. a host sync in the eager tick
  that a CUDA graph of the tick would have to remove);
- ``expected`` — the finding is the *point* (the intentional-bug lint
  fixtures in ``models/raft_buggy.py`` and ``models/ir_hazards.py``);
  tests assert these fire.

Baseline entries that match nothing are reported as *stale* so the file
cannot silently rot.
"""

from __future__ import annotations

import json
import os
import sys
from dataclasses import dataclass, field, asdict
from typing import Dict, List, Optional, Tuple

SEV_ERROR = "error"
SEV_WARNING = "warning"
SEV_INFO = "info"

_SEV_ORDER = {SEV_ERROR: 0, SEV_WARNING: 1, SEV_INFO: 2}


@dataclass
class Finding:
    rule: str            # e.g. "TRC101"
    name: str            # short slug, e.g. "traced-branch"
    severity: str        # error / warning / info
    pass_name: str       # trace / contract / schema
    path: str            # repo-relative
    line: int            # 1-based; 0 = whole-file / symbol-level
    symbol: str          # enclosing def/class ("" for file-level)
    message: str         # line-free description

    @property
    def fingerprint(self) -> str:
        return f"{self.rule}:{self.path}:{self.symbol}"

    def to_dict(self) -> dict:
        d = asdict(self)
        d["fingerprint"] = self.fingerprint
        return d

    def location(self) -> str:
        return f"{self.path}:{self.line}" if self.line else self.path


def sort_findings(findings: List[Finding]) -> List[Finding]:
    return sorted(findings, key=lambda f: (_SEV_ORDER.get(f.severity, 9),
                                           f.path, f.line, f.rule))


# --- baseline ---------------------------------------------------------------

DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "baseline.json")


@dataclass
class BaselineEntry:
    fingerprint: str
    reason: str
    status: str = "accepted"     # accepted | expected


# rule-id prefix -> owning pass; staleness checks are scoped to the
# passes that actually RAN (a --pass trace run must not call the
# contract or schema entries stale just because it skipped those
# passes).
_RULE_PASS_PREFIXES = (("TRC", "trace"), ("CON", "contract"),
                       ("SCH", "schema"), ("JXP", "ir"),
                       ("COST", "cost"), ("LNE", "lanes"),
                       ("ABS", "ranges"), ("SHD", "shard"),
                       ("EXE", "aot"))


def fingerprint_pass(fingerprint: str) -> Optional[str]:
    """The pass a baseline fingerprint's rule family belongs to (None
    for an unrecognized prefix — treated as always in scope)."""
    for prefix, pass_name in _RULE_PASS_PREFIXES:
        if fingerprint.startswith(prefix):
            return pass_name
    return None


class Baseline:
    """Fingerprint -> entry map with hit tracking (for staleness)."""

    def __init__(self, entries: Optional[List[BaselineEntry]] = None):
        self.entries: Dict[str, BaselineEntry] = {
            e.fingerprint: e for e in (entries or [])}
        self._hits: Dict[str, int] = {}

    @classmethod
    def load(cls, path: str = DEFAULT_BASELINE) -> "Baseline":
        if not os.path.exists(path):
            return cls()
        with open(path) as f:
            data = json.load(f)
        entries = [BaselineEntry(fingerprint=e["fingerprint"],
                                 reason=e.get("reason", ""),
                                 status=e.get("status", "accepted"))
                   for e in data.get("entries", [])]
        return cls(entries)

    def match(self, finding: Finding) -> Optional[BaselineEntry]:
        e = self.entries.get(finding.fingerprint)
        if e is not None:
            self._hits[e.fingerprint] = self._hits.get(e.fingerprint, 0) + 1
        return e

    def stale_entries(self, passes=None) -> List[BaselineEntry]:
        """Unmatched entries — restricted, when ``passes`` is given, to
        entries whose rule family belongs to a pass that ran."""
        out = []
        for fp, e in sorted(self.entries.items()):
            if fp in self._hits:
                continue
            owner = fingerprint_pass(fp)
            if passes is not None and owner is not None \
                    and owner not in passes:
                continue
            out.append(e)
        return out


# --- report -----------------------------------------------------------------

@dataclass
class LintReport:
    findings: List[Finding] = field(default_factory=list)     # unsuppressed
    suppressed: List[Tuple[Finding, BaselineEntry]] = field(
        default_factory=list)
    stale: List[BaselineEntry] = field(default_factory=list)
    files_scanned: int = 0
    passes_run: Tuple[str, ...] = ()
    # what the lint's static workers held (``runner.merge_states``), None
    # where none ran: the no-device gate covers them too
    static_workers: Optional[dict] = None

    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == SEV_ERROR]

    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == SEV_WARNING]

    def to_json(self) -> dict:
        return {
            "passes": list(self.passes_run),
            "files-scanned": self.files_scanned,
            "findings": [f.to_dict() for f in sort_findings(self.findings)],
            "suppressed": [
                {**f.to_dict(), "baseline-status": e.status,
                 "baseline-reason": e.reason}
                for f, e in self.suppressed],
            "stale-baseline-entries": [asdict(e) for e in self.stale],
            "static-workers": self.static_workers,
            "summary": {
                "errors": len(self.errors()),
                "warnings": len(self.warnings()),
                "suppressed": len(self.suppressed),
                "stale": len(self.stale),
            },
        }


_COLORS = {SEV_ERROR: "\x1b[31m", SEV_WARNING: "\x1b[33m",
           SEV_INFO: "\x1b[36m"}
_RESET = "\x1b[0m"
_DIM = "\x1b[2m"


def render_text(report: LintReport, color: Optional[bool] = None) -> str:
    """Human-readable rendering; color defaults to stdout-is-a-tty."""
    if color is None:
        color = sys.stdout.isatty()

    def paint(code: str, s: str) -> str:
        return f"{code}{s}{_RESET}" if color else s

    lines = []
    for f in sort_findings(report.findings):
        sev = paint(_COLORS.get(f.severity, ""), f.severity.upper())
        sym = f" [{f.symbol}]" if f.symbol else ""
        lines.append(f"{sev} {f.rule} {f.name} {f.location()}{sym}: "
                     f"{f.message}")
    for f, e in sorted(report.suppressed,
                       key=lambda fe: fe[0].fingerprint):
        tag = "expected" if e.status == "expected" else "baselined"
        lines.append(paint(_DIM, f"{tag} {f.rule} {f.location()} "
                                 f"[{f.symbol}]: {e.reason}"))
    for e in report.stale:
        lines.append(paint(_COLORS[SEV_WARNING],
                           f"STALE baseline entry {e.fingerprint!r} "
                           f"matched no finding — remove or re-justify"))
    n_err, n_warn = len(report.errors()), len(report.warnings())
    n_exp = sum(1 for _, e in report.suppressed if e.status == "expected")
    summary = (f"{n_err} error(s), {n_warn} warning(s), "
               f"{len(report.suppressed)} baselined "
               f"({n_exp} expected-fixture), {len(report.stale)} stale "
               f"baseline entr{'y' if len(report.stale) == 1 else 'ies'}; "
               f"{report.files_scanned} file(s), "
               f"passes: {', '.join(report.passes_run) or 'none'}")
    lines.append(summary)
    return "\n".join(lines)
