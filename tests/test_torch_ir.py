"""The port's IR-hazard pass (``maelstrom_tpu_torch/analysis/ir_lint.py``)
over the aten graph of the tick, against the JAX pass's fixtures and
gate.

- **The gate on the tree.** ``lint --strict --json --ir --cost --lanes``
  (a child process, started before the first test of the file) exits 0:
  no error and no warning outside the baseline, every accepted JXP401
  entry with its reason, no ir/cost/lanes baseline entry left unmatched
  (stale), and neither the child nor any of the static workers that
  recorded the ticks for it imported ``jax`` or a module of the JAX
  package, loaded a kernel library or initialised CUDA.
- **Fixtures.** Each of the four IR fixtures of ``models/ir_hazards.py``
  trips its rule, as ``tests/test_analysis_ir.py:52-147`` asserts for
  JAX's: JXP401 on the float32 carry leaf, JXP402 on the host read (and
  the trace pass's TRC104 cannot see it), JXP404 on the 2 MiB broadcast,
  JXP405 on the 128 KiB constant; their findings are ``expected``
  baseline entries; none is registered.
- **Registered models** trip only the accepted JXP401 sites, in both
  carry layouts (echo and lin-kv here; the gate run covers every model
  x layout).
- **The parts with no counterpart.** No JXP403 (the port donates and
  compiles nothing); no loop in an eager tick.

Sizes: the lint's audit config (four instances a model).
"""

import json
import os
import subprocess
import sys

import pytest

from conftest import REPO

from maelstrom_tpu_torch.analysis import cost_model, ir_lint, runner
from maelstrom_tpu_torch.analysis.findings import Baseline
from maelstrom_tpu_torch.analysis.findings import fingerprint_pass
from maelstrom_tpu_torch.models import get_model
from maelstrom_tpu_torch.models.ir_hazards import (IR_FIXTURE_MODELS,
                                                   IrBakedConst, IrFloatLeak,
                                                   IrFusionBreaker,
                                                   IrHostCallback)

from torch_static_cases import static_traces  # noqa: F401 (fixture)
from torch_tutorial_cases import one_thread_env
from torch_tutorial_cases import one_torch_thread  # noqa: F401 (autouse)

# the gate as a user runs it, through runpy so that the child reports,
# after the lint, what it imported and whether CUDA was initialised
GATE_CHILD = """
import json, runpy, sys
sys.argv = ["maelstrom_tpu_torch", "lint", "--strict", "--json", "--ir",
            "--cost", "--lanes"]
try:
    runpy.run_module("maelstrom_tpu_torch", run_name="__main__",
                     alter_sys=True)
    rc = 0
except SystemExit as e:
    rc = e.code or 0
import torch
print(json.dumps({"jax": "jax" in sys.modules,
                  "jax-package": sorted(m for m in sys.modules
                                        if m.split(".")[0] == "maelstrom_tpu"),
                  "cuda-initialized": torch.cuda.is_initialized()}),
      file=sys.stderr)
sys.exit(rc)
"""


@pytest.fixture(scope="module", autouse=True)
def gate_run():
    proc = subprocess.Popen([sys.executable, "-c", GATE_CHILD], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=one_thread_env())
    result = {}

    def wait():
        if not result:
            out, err = proc.communicate(timeout=600)
            result.update(rc=proc.returncode, out=out, err=err)
        return result

    yield wait
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def _accepted(f, baseline=Baseline.load()):
    e = baseline.entries.get(f.fingerprint)
    return e is not None and e.status == "accepted"


def _rules(findings):
    return {f.rule for f in findings if not _accepted(f)}


# --- the fixtures trip their rules ------------------------------------------


def test_float_leak_trips_jxp401():
    fs, report = ir_lint.audit_model_ir(IrFloatLeak(), 2, "lead")
    assert _rules(fs) == {"JXP401"}
    (f,) = [f for f in fs if not _accepted(f)]
    assert f.severity == "error" and f.symbol == "IrFloatLeak"
    assert "drift" in f.message and "float32" in f.message
    assert report is not None and report.eqns > 0


def test_host_callback_trips_jxp402():
    fs, report = ir_lint.audit_model_ir(IrHostCallback(), 2, "lead")
    assert [f.rule for f in fs] == ["JXP402"] and report is None
    assert "meta" in fs[0].message


def test_host_read_is_invisible_to_the_trace_pass():
    """Only the IR pass finds the fixture's host read: the trace pass's
    TRC104 names calls, and the fixture makes none."""
    from maelstrom_tpu_torch.analysis.trace_lint import run_trace_lint
    path = os.path.join(REPO, "maelstrom_tpu_torch", "models",
                        "ir_hazards.py")
    assert run_trace_lint(REPO, paths=[path]) == []


def test_other_trace_failures_are_jxp400():
    from maelstrom_tpu_torch.models.echo import EchoModel

    class Broken(EchoModel):
        name = "echo-broken"

        def tick(self, row, node_idx, t, keys, cfg, params):
            raise ValueError("planted")

    fs, report = ir_lint.audit_model_ir(Broken(), 2, "lead")
    assert [f.rule for f in fs] == ["JXP400"] and report is None
    assert "planted" in fs[0].message


def test_fusion_breaker_trips_jxp404():
    fs, report = ir_lint.audit_model_ir(IrFusionBreaker(), 2, "lead")
    assert _rules(fs) == {"JXP404"}
    assert all(f.severity == "warning" for f in fs if f.rule == "JXP404")
    assert report.max_broadcast_bytes >= 2 << 20


def test_baked_const_trips_jxp405():
    fs, report = ir_lint.audit_model_ir(IrBakedConst(), 2, "lead")
    assert _rules(fs) == {"JXP405"}
    assert report.max_const_bytes >= 128 << 10


def test_fixtures_never_registered():
    for kind in IR_FIXTURE_MODELS:
        with pytest.raises(ValueError):
            get_model(f"echo-ir-{kind}", 2)


def test_fixture_findings_are_expected_not_silent():
    bl = Baseline.load()
    for kind, cls in IR_FIXTURE_MODELS.items():
        fs, _ = ir_lint.audit_model_ir(cls(), 2, "lead",
                                       label=f"fixture-{kind}")
        planted = [f for f in fs if not _accepted(f)]
        assert planted, kind
        for f in planted:
            entry = bl.match(f)
            assert entry is not None and entry.status == "expected", \
                f.fingerprint


@pytest.mark.parametrize(
    "wl,n,layout", [("echo", 2, "lead"), ("lin-kv", 5, "lead"),
                    ("echo", 2, "minor"), ("lin-kv", 5, "minor")],
    ids=["echo-2", "lin-kv-5", "echo-2-minor", "lin-kv-5-minor"])
def test_registered_models_trip_only_accepted_sites(wl, n, layout,
                                                    static_traces):
    fs, report = ir_lint.audit_model_ir(get_model(wl, n), n, layout,
                                        trace_cache=static_traces)
    assert fs and all(f.rule == "JXP401" and _accepted(f) for f in fs), \
        [f.to_dict() for f in fs if not _accepted(f)]
    assert report.loops == 0
    assert set(cost_model.PHASES) <= set(report.phases)
    # the RNG's uint32 emulation is the bulk of the 64-bit census
    rng_ops = sum(c for (path, _), c in report.wide_sites.items()
                  if path.endswith(("rng.py", "xla_math.py")))
    assert rng_ops > sum(report.wide_sites.values()) / 2


# --- the gate on the tree ---------------------------------------------------


def test_gate_is_clean_on_the_tree(gate_run):
    r = gate_run()
    assert r["rc"] == 0, r["out"][-3000:] + r["err"][-3000:]
    rep = json.loads(r["out"])
    assert rep["passes"] == ["ir", "cost", "lanes"]
    assert rep["findings"] == [], rep["findings"]
    assert rep["summary"]["errors"] == 0
    assert not any(f["rule"] == "JXP403" for f in rep["suppressed"])
    bl = Baseline.load()
    hit = {f["fingerprint"] for f in rep["suppressed"]}
    mine = {fp for fp in bl.entries
            if fingerprint_pass(fp) in ("ir", "cost", "lanes")}
    # no entry of the three passes is stale
    assert mine <= hit, sorted(mine - hit)
    for f in rep["suppressed"]:
        if f["rule"] == "JXP401" and f["baseline-status"] == "accepted":
            assert f["baseline-reason"].strip(), f["fingerprint"]
    expected = {f["fingerprint"] for f in rep["suppressed"]
                if f["baseline-status"] == "expected"}
    assert {fp.split(":")[0] for fp in expected
            if "ir_hazards" in fp} == {"JXP401", "JXP402", "JXP404",
                                       "JXP405", "LNE601", "LNE602",
                                       "LNE603", "LNE604"}
    loaded = json.loads(r["err"].strip().splitlines()[-1])
    assert loaded == {"jax": False, "jax-package": [],
                      "cuda-initialized": False}
    # the static workers recorded every model x layout's tick: each job
    # reported, and none of them held what the lint's process may not
    workers = rep["static-workers"]
    assert workers["jobs"] == 2 * len(cost_model.cost_specs()), workers
    assert workers["lost-jobs"] == 0 and 1 <= workers["processes"] <= \
        runner.STATIC_WORKERS, workers
    assert not workers["cuda-initialized"] and not workers[
        "kernel-libraries"] and not workers["jax-modules"], workers
    assert not any("maelstrom_tpu_torch" in f
                   for f in workers["triton-importers"]), workers
