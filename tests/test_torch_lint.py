"""The port's ``lint`` (``maelstrom_tpu_torch/analysis/``) against the JAX
package's ``maelstrom lint``.

- **Trace rules.** Each case of the JAX lint tests
  (``tests/test_analysis_lint.py``) has a torch counterpart snippet; the
  JAX linter on the JAX snippet and the port's on the torch snippet give
  the same rule codes. The torch-only hazards (``.cpu()``,
  ``.tolist()``, ``.numpy()``, ``torch.rand*``, boolean-mask indexing)
  and the tick index ``t`` as a host int (flagged by JAX, not by the
  port) are cases of their own. Both fixtures fire TRC101-107.
- **Contract.** The full sweep over every registered model and mutant
  is clean in both packages, and the planted cases (too many rows, dtype
  drift, op lanes, decode width, a flake split, a raising hook, a host
  read) are flagged with the same rules by both.
- **Schema.** The port's RPC registry equals JAX's namespace by
  namespace and field by field; SCH304 and SCH305 are clean in both, and
  a planted drift is flagged by both.
- **Baseline and CLI.** The baseline bookkeeping of both packages; the
  CLI's ``--strict``, ``--json``, ``--pass``, paths; of the JAX CLI's
  jaxpr passes, ``--ir``, ``--cost`` and ``--lanes`` run with the JAX
  CLI's exit code (``tests/test_torch_ir.py``, ``test_torch_cost.py``,
  ``test_torch_lanes.py`` and ``test_torch_ranges.py`` hold them to
  JAX's), and so do ``--ranges``, ``--shard`` and ``--aot``
  (``tests/test_torch_shard.py`` and ``test_torch_aot.py``); the port's
  tree is
  lint-clean modulo its
  baseline, which holds the fixture's seven findings and the accepted
  ones.

The port's full three-pass run is one ``lint --strict --json`` child
process, started first so that it runs while the JAX contract sweep runs
here. Sizes: the passes' own (four instances a model). Exact rule sets."""

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from conftest import REPO

from maelstrom_tpu.analysis import findings as jfindings
from maelstrom_tpu.analysis import schema_lint as jschema
from maelstrom_tpu.analysis.trace_lint import lint_sources as jlint_sources
from maelstrom_tpu_torch.__main__ import main as cli
from maelstrom_tpu_torch.analysis import findings as tfindings
from maelstrom_tpu_torch.analysis import schema_lint as tschema
from maelstrom_tpu_torch.analysis.trace_lint import (lint_sources as
                                                     tlint_sources)

from torch_tutorial_cases import one_torch_thread  # noqa: F401 (autouse)

FIXTURE = "maelstrom_tpu_torch/models/raft_buggy.py"
FIXTURE_SYMBOL = "RaftTracedHazards.tick"
ACCEPTED = {"TRC104:maelstrom_tpu_torch/parallel/mesh.py:deinterleave",
            "TRC104:maelstrom_tpu_torch/parallel/mesh.py:_np"}
ALL_TRC = ["TRC101", "TRC102", "TRC103", "TRC104", "TRC105", "TRC106",
           "TRC107"]


@pytest.fixture(scope="module", autouse=True)
def cli_run():
    """The port's full run, ``lint --strict --json``, in a child process
    started before the first test of the file."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "maelstrom_tpu_torch", "lint", "--strict",
         "--json"], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    result = {}

    def wait():
        if not result:
            out, err = proc.communicate(timeout=300)
            result.update(rc=proc.returncode, out=out, err=err)
        return result

    yield wait
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def cli_report(cli_run):
    r = cli_run()
    assert r["rc"] == 0, r["out"][-2000:] + r["err"][-2000:]
    return json.loads(r["out"])


def _rules(findings):
    return sorted(f.rule for f in findings)


def _jax(src):
    return jlint_sources({"fixture.py": textwrap.dedent(src)})


def _torch(src):
    return tlint_sources({"fixture.py": textwrap.dedent(src)})


# --- the trace rules: (JAX snippet, torch snippet, JAX rules, port rules) ---

TRACE_CASES = {
    "traced-branch": ("""
        class M:
            def handle(self, row, node_idx, msg, t, key, cfg, params):
                if row > 0:
                    row = row + 1
                return row, None
    """, """
        class M:
            def handle(self, row, node_idx, msg, t, keys, cfg, params):
                if (row > 0).any():
                    row = row + 1
                return row, None
    """, ["TRC101"], ["TRC101"]),
    "static-branch": ("""
        class M:
            vote_check = True
            def handle(self, row, node_idx, msg, t, key, cfg, params):
                if self.vote_check:
                    row = row + 1
                if cfg.n_nodes > 2:
                    row = row - 1
                if params is None:
                    row = row * 2
                return row, None
    """, """
        class M:
            vote_check = True
            def handle(self, row, node_idx, msg, t, keys, cfg, params):
                if self.vote_check:
                    row = row + 1
                if cfg.n_nodes > 2:
                    row = row - 1
                if params is None:
                    row = row * 2
                if row.shape[0] > 1:
                    row = row * 3
                return row, None
    """, [], []),
    "traced-while-and-assert": ("""
        class M:
            def tick(self, row, node_idx, t, key, cfg, params):
                while row > 0:
                    break
                assert t >= 0
                return row, None
    """, """
        class M:
            def tick(self, row, node_idx, t, keys, cfg, params):
                while (row > 0).any():
                    break
                assert (keys >= 0).all()
                return row, None
    """, ["TRC102", "TRC103"], ["TRC102", "TRC103"]),
    "static-loop": ("""
        class M:
            apply_max = 2
            def tick(self, row, node_idx, t, key, cfg, params):
                outs = []
                for _ in range(self.apply_max):
                    outs.append(row)
                assert cfg.n_nodes > 0
                return row, outs
    """, """
        class M:
            apply_max = 2
            def tick(self, row, node_idx, t, keys, cfg, params):
                outs = []
                for _ in range(self.apply_max):
                    outs.append(row)
                assert cfg.n_nodes > 0
                return row, torch.stack(outs, dim=1)
    """, [], []),
    "host-sync": ("""
        import numpy as np
        class M:
            def handle(self, row, node_idx, msg, t, key, cfg, params):
                a = int(msg)
                b = row.item()
                c = np.asarray(row)
                return row, (a, b, c)
    """, """
        import numpy as np
        class M:
            def handle(self, row, node_idx, msg, t, keys, cfg, params):
                a = int(msg[0, 0])
                b = row.sum().item()
                c = np.asarray(row)
                return row, (a, b, c)
    """, ["TRC104"] * 3, ["TRC104"] * 3),
    "host-sync-on-static": ("""
        import numpy as np
        class M:
            def handle(self, row, node_idx, msg, t, key, cfg, params):
                n = int(cfg.latency_mean)
                tbl = np.asarray([1, 2, 3])
                return row, (n, tbl)
    """, """
        import numpy as np
        import torch
        class M:
            def handle(self, row, node_idx, msg, t, keys, cfg, params):
                n = int(cfg.latency_mean)
                b = int(msg.shape[0])
                tbl = torch.as_tensor(np.asarray([1, 2, 3]))
                return row, (n, b, tbl)
    """, [], []),
    "mutable-capture": ("""
        CACHE = []
        class M:
            def tick(self, row, node_idx, t, key, cfg, params):
                CACHE.append(t)
                self.seen = {}
                return row, None
    """, """
        CACHE = []
        class M:
            def tick(self, row, node_idx, t, keys, cfg, params):
                CACHE.append(t)
                self.seen = {}
                return row, None
    """, ["TRC105"] * 2, ["TRC105"] * 2),
    "local-mutation": ("""
        class M:
            def tick(self, row, node_idx, t, key, cfg, params):
                outs = []
                outs.append(row)
                return row, outs
    """, """
        class M:
            def tick(self, row, node_idx, t, keys, cfg, params):
                outs = []
                outs.append(row)
                row[:, 0] = 1
                return row, outs
    """, [], []),
    "data-dependent-shape": ("""
        import jax.numpy as jnp
        class M:
            def invariants(self, node_state, cfg, params):
                bad = jnp.nonzero(node_state)
                alt = jnp.where(node_state > 0)
                return bad, alt
    """, """
        import torch
        class M:
            def invariants(self, node_state, cfg, params):
                bad = torch.nonzero(node_state)
                alt = torch.where(node_state > 0)
                return bad, alt
    """, ["TRC106"] * 2, ["TRC106"] * 2),
    "three-arg-where": ("""
        import jax.numpy as jnp
        class M:
            def invariants(self, node_state, cfg, params):
                return jnp.where(node_state > 0, 1, 0)
    """, """
        import torch
        class M:
            def invariants(self, node_state, cfg, params):
                return torch.where(node_state > 0, 1, 0)
    """, [], []),
    "bare-python-rng": ("""
        import random
        import numpy as np
        class M:
            def sample_op(self, key, uniq, cfg, params):
                a = random.random()
                b = np.random.randint(3)
                return a, b
    """, """
        import random
        import numpy as np
        class M:
            def sample_op(self, keys, uniq, cfg, params):
                a = random.random()
                b = np.random.randint(3)
                return a, b
    """, ["TRC107"] * 2, ["TRC107"] * 2),
    "threefry-rng": ("""
        import jax
        class M:
            def sample_op(self, key, uniq, cfg, params):
                return jax.random.randint(key, (), 0, 5)
    """, """
        from maelstrom_tpu_torch import rng
        class M:
            def sample_op(self, keys, uniq, cfg, params):
                return rng.randint(keys, (), 0, 5)
    """, [], []),
    "for-iterable-expression": ("""
        import numpy as np
        class M:
            def tick(self, row, node_idx, t, key, cfg, params):
                for x in np.asarray(row):
                    pass
                return row, None
    """, """
        import numpy as np
        class M:
            def tick(self, row, node_idx, t, keys, cfg, params):
                for x in np.asarray(row):
                    pass
                return row, None
    """, ["TRC104"], ["TRC104"]),
    "nested-tick-body": ("""
        def make_tick_fn(model, sim, params):
            def tick_fn(carry, t):
                if carry.violations.sum() > 0:
                    carry = carry
                return carry, None
            return tick_fn
    """, """
        def make_tick_fn(model, sim, instance_ids=None, device=None):
            def tick_fn(carry, t):
                if carry.violations.sum() > 0:
                    carry = carry
                return carry, None
            return tick_fn
    """, ["TRC101"], ["TRC101"]),
    # the port's own: the tick index is a host int
    "tick-index-host-int": ("""
        def make_tick_fn(model, sim, params):
            def tick_fn(carry, t):
                if t >= sim.client.final_start:
                    carry = carry
                return carry, None
            return tick_fn
    """, """
        def make_tick_fn(model, sim, instance_ids=None, device=None):
            def tick_fn(carry, t):
                if t >= sim.client.final_start:
                    carry = carry
                return carry, None
            return tick_fn
    """, ["TRC101"], []),
    # the torch-only hazards, each with a JAX spelling the JAX linter
    # rules the same way where it has one
    "torch-host-copies": ("""
        class M:
            def handle(self, row, node_idx, msg, t, key, cfg, params):
                a = row.tolist()
                return row, a
    """, """
        class M:
            def handle(self, row, node_idx, msg, t, keys, cfg, params):
                a = row.cpu()
                b = msg.tolist()
                c = row.detach().numpy()
                return row, (a, b, c)
    """, ["TRC104"], ["TRC104"] * 3),
    "torch-global-generator": ("""
        import numpy as np
        class M:
            def sample_op(self, key, uniq, cfg, params):
                return np.random.rand(3)
    """, """
        import torch
        class M:
            def sample_op(self, keys, uniq, cfg, params):
                a = torch.rand(3)
                b = torch.randint(0, 5, uniq.shape)
                c = torch.zeros(3).bernoulli_(0.5)
                return a, b, c
    """, ["TRC107"], ["TRC107"] * 3),
    "torch-mask-indexing": ("""
        import jax.numpy as jnp
        class M:
            def invariants(self, node_state, cfg, params):
                return jnp.unique(node_state)
    """, """
        import torch
        class M:
            def invariants(self, node_state, cfg, params):
                live = node_state > 0
                a = node_state[live]
                node_state[~live & (node_state < 3)] = 0
                b = node_state.unique()
                c = torch.masked_select(node_state, live)
                return a, b, c
    """, ["TRC106"], ["TRC106"] * 4),
}


@pytest.mark.parametrize("case", sorted(TRACE_CASES))
def test_trace_rules_match_jax(case):
    jsrc, tsrc, jwant, twant = TRACE_CASES[case]
    assert _rules(_jax(jsrc)) == sorted(jwant)
    assert _rules(_torch(tsrc)) == sorted(twant)
    for f in _torch(tsrc):
        assert f.severity == ("warning" if f.rule == "TRC106" else "error")


def test_helper_reached_via_fixpoint():
    """A helper called from a hook inherits tracedness in both linters;
    a host-side decoder of the same shape does not."""
    src = """
        class M:
            def handle(self, row, node_idx, msg, t, {k}, cfg, params):
                return self._bump(row), None
            def _bump(self, value):
                if {cond}:
                    return value + 1
                return value
            def complete_record(self, f, a, b, c, etype):
                if f == 1:
                    return {{"v": int(a)}}
                return None
    """
    want = [("TRC101", "M._bump")]
    assert [(f.rule, f.symbol) for f in _jax(src.format(
        k="key", cond="value > 0"))] == want
    assert [(f.rule, f.symbol) for f in _torch(src.format(
        k="keys", cond="(value > 0).any()"))] == want


def test_annotated_scalars_and_isinstance_are_static():
    """The port's own: a parameter annotated ``int`` is a host value, and
    so is a name in the ``else`` of ``isinstance(x, torch.Tensor)``."""
    fs = _torch("""
        import torch
        def randint_bits(keys, lo, hi: int):
            if hi > 3:
                hi = 3
            if isinstance(lo, torch.Tensor):
                return keys + lo
            return keys + int(lo)
    """)
    assert fs == []


# --- the fixtures -------------------------------------------------------------


def test_fixtures_fire_every_rule_in_both():
    from maelstrom_tpu.analysis.trace_lint import run_trace_lint as jrun
    from maelstrom_tpu_torch.analysis.trace_lint import run_trace_lint
    fs = run_trace_lint(REPO, paths=[FIXTURE])
    assert sorted({f.rule for f in fs}) == ALL_TRC
    assert all(f.symbol == FIXTURE_SYMBOL for f in fs)
    jfs = jrun(REPO, paths=["maelstrom_tpu/models/raft_buggy.py"])
    assert sorted({f.rule for f in jfs}) == ALL_TRC


def test_fixture_findings_are_expected_not_silent():
    from maelstrom_tpu_torch.analysis.trace_lint import run_trace_lint
    fs = run_trace_lint(REPO, paths=[FIXTURE])
    bl = tfindings.Baseline.load()
    assert len(fs) == 7
    for f in fs:
        entry = bl.match(f)
        assert entry is not None, f.fingerprint
        assert entry.status == "expected", f.fingerprint


def test_fixture_never_registered():
    from maelstrom_tpu_torch.models import MUTANTS, get_model
    from maelstrom_tpu_torch.models.raft_buggy import (
        BUGGY_MODELS, LINT_FIXTURE_MODELS, RaftTracedHazards)
    assert RaftTracedHazards not in BUGGY_MODELS.values()
    assert set(LINT_FIXTURE_MODELS.values()) == {RaftTracedHazards}
    assert RaftTracedHazards.name not in MUTANTS
    with pytest.raises(ValueError):
        get_model(RaftTracedHazards.name, 3)


# --- the contract audit -------------------------------------------------------


@pytest.fixture(scope="module")
def jax_contract_sweep():
    from maelstrom_tpu.analysis.contract_audit import run_contract_audit
    return run_contract_audit(REPO)


def test_contract_sweep_clean_in_both(jax_contract_sweep, cli_report):
    from maelstrom_tpu.analysis import contract_audit as jca
    from maelstrom_tpu_torch.analysis import contract_audit as tca
    assert jax_contract_sweep == []
    assert "contract" in cli_report["passes"]
    assert not [f for f in cli_report["findings"] + cli_report["suppressed"]
                if f["rule"].startswith("CON")]
    # the same workloads at the same node counts
    assert tca.AUDIT_WORKLOADS == jca.AUDIT_WORKLOADS
    assert sorted(tca._buggy_workloads()) == sorted(jca._buggy_workloads())
    assert tca.TICK_HORIZON == jca.TICK_HORIZON == 1 << 20


def _planted(pkg):
    """The JAX lint tests' planted echo models (and a host read), built
    on each package's echo model."""
    if pkg == "jax":
        import jax.numpy as jnp
        from maelstrom_tpu.models.echo import EchoModel as Base

        cat = lambda o: jnp.concatenate([o, o], axis=0)          # noqa
        f32 = lambda r: r.astype(jnp.float32)                     # noqa
        wide = lambda: jnp.zeros((7,), jnp.int32)                 # noqa
        short = lambda: jnp.zeros((2,), jnp.int32)                # noqa
        read = lambda m: int(m[0])                                # noqa
    else:
        from maelstrom_tpu_torch.models.echo import EchoModel as Base

        cat = lambda o: torch.cat([o, o], dim=1)                  # noqa
        f32 = lambda r: r.to(torch.float32)                       # noqa
        read = lambda m: int(m[0, 0])                             # noqa

    class TooManyOuts(Base):
        def handle(self, *a):
            row, out = super().handle(*a)
            return row, cat(out)

    class DtypeDrift(Base):
        def tick(self, *a):
            row, outs = super().tick(*a)
            return f32(row), outs

    class WrongOpLanes(Base):
        def sample_op(self, keys, uniq, cfg, params=None):
            if pkg == "jax":
                return wide()
            return torch.zeros(uniq.shape + (7,), dtype=torch.int32,
                               device=uniq.device)

    class ShortDecode(Base):
        def decode_reply(self, op, msg, cfg, params=None):
            et, val = super().decode_reply(op, msg, cfg, params)
            if pkg == "jax":
                return et, short()
            return et, val[..., :2]

    class TinyFlake(Base):
        flake_counter_bits = 10

    class Crashes(Base):
        def handle(self, *a):
            raise RuntimeError("boom")

    class HostRead(Base):
        def handle(self, *a):
            read(a[2])
            return super().handle(*a)

    return {"clean": Base, "too-many-outs": TooManyOuts,
            "dtype-drift": DtypeDrift, "wrong-op-lanes": WrongOpLanes,
            "short-decode": ShortDecode, "tiny-flake": TinyFlake,
            "crashes": Crashes, "host-read": HostRead}


CONTRACT_CASES = {
    "clean": (set(), None),
    "too-many-outs": ({"CON202"}, ("message", "max_out")),
    "dtype-drift": ({"CON201", "CON202"}, ("message", "int32 -> float32")),
    # the full tick also fails (the client step broadcasts the op row
    # against the declared width): a trace failure, not silence
    "wrong-op-lanes": ({"CON200", "CON203"}, None),
    # ...and so does a value row too short for the event lanes
    "short-decode": ({"CON200", "CON203"}, ("symbol", "decode_reply")),
    "tiny-flake": ({"CON204"}, ("message", "collide")),
    "crashes": ({"CON200"}, None),
    # a host read inside a hook: a concretization error under JAX's
    # eval_shape, a value read of a meta tensor in the port
    "host-read": ({"CON200"}, None),
}


@pytest.mark.parametrize("case", sorted(CONTRACT_CASES))
def test_planted_contract_cases_match_jax(case):
    from maelstrom_tpu.analysis.contract_audit import audit_model as jaudit
    from maelstrom_tpu_torch.analysis.contract_audit import audit_model
    rules, probe = CONTRACT_CASES[case]
    for pkg, audit in (("jax", jaudit), ("torch", audit_model)):
        fs = audit(_planted(pkg)[case](), 1)
        assert {f.rule for f in fs} == rules, (pkg, fs)
        if probe is not None:
            field, text = probe
            assert any(text in getattr(f, field) for f in fs), (pkg, fs)
    assert not torch.cuda.is_initialized()


# --- the schema pass ----------------------------------------------------------


def test_registry_equals_jax():
    import maelstrom_tpu.workloads  # noqa: F401  (fills JAX's registry)
    from maelstrom_tpu.core import schema as js
    from maelstrom_tpu_torch.core import rpcs  # noqa: F401
    from maelstrom_tpu_torch.core import schema as ts
    assert list(ts.REGISTRY) == list(js.REGISTRY)
    for ns, rpcs_ in js.REGISTRY.items():
        assert list(ts.REGISTRY[ns]) == list(rpcs_), ns
        for name, d in rpcs_.items():
            t = ts.REGISTRY[ns][name]
            assert (t.namespace, t.name, t.doc, t.response_type) == \
                (d.namespace, d.name, d.doc, d.response_type)
            assert ts.render(t.request) == js.render(d.request)
            assert ts.render(t.response) == js.render(d.response)
            assert ts.render(t.full_request_schema()) == \
                js.render(d.full_request_schema())


def test_error_registry_equals_jax():
    from maelstrom_tpu.core import errors as je
    from maelstrom_tpu_torch.core import errors as te
    assert [(e.code, e.name, e.definite, e.doc) for e in te._ERRORS] == \
        [(e.code, e.name, e.definite, e.doc) for e in je._ERRORS]


def test_schema_wire_half_clean_in_both(cli_report):
    assert jschema.check_definite_codes() == []
    assert jschema.check_wire_coverage() == []
    assert tschema.check_definite_codes() == []
    assert tschema.check_wire_coverage() == []
    assert tschema.TPU_MODELED == jschema.TPU_MODELED
    assert "schema" in cli_report["passes"]
    assert not [f for f in cli_report["findings"] + cli_report["suppressed"]
                if f["rule"].startswith("SCH")]


def test_planted_wire_drift_flagged_by_both(monkeypatch):
    from maelstrom_tpu.core import schema as js
    from maelstrom_tpu_torch.core import schema as ts
    for mod, schema in ((jschema, js), (tschema, ts)):
        schema.rpc("unique-ids", "reserve_lint_probe",
                   "synthetic RPC with no wire lane (test only)",
                   request={}, response={})
        try:
            fs = mod.check_wire_coverage()
        finally:
            del schema.REGISTRY["unique-ids"]["reserve_lint_probe"]
        assert [f.rule for f in fs] == ["SCH305"]
        assert "reserve_lint_probe" in fs[0].message
    # a definite code dropped from the runtime's table
    import maelstrom_tpu.tpu.runtime as jrt
    import maelstrom_tpu_torch.runtime as trt
    for rt in (jrt, trt):
        monkeypatch.setattr(rt, "_DEFINITE_CODES", (1, 10, 11, 12, 14, 20,
                                                    21, 22))
    for mod in (jschema, tschema):
        fs = mod.check_definite_codes()
        assert [f.rule for f in fs] == ["SCH304"]
        assert "_DEFINITE_CODES" == fs[0].symbol


def test_unknown_error_code_flagged_by_both():
    src = textwrap.dedent("""
        from node import RPCError
        def f(node, msg):
            node.reply_error(msg, RPCError(99, "nope"))
            node.reply(msg, {"type": "error", "code": 1001})
            node.reply_error(msg, RPCError(22, "fine"))
    """)
    for mod in (jschema, tschema):
        fs = mod.check_error_codes({"x.py": src})
        assert [f.rule for f in fs] == ["SCH304"]
        assert "99" in fs[0].message


# --- the baseline bookkeeping -------------------------------------------------


@pytest.mark.parametrize("pkg", [jfindings, tfindings],
                         ids=["jax", "torch"])
def test_baseline_bookkeeping(pkg):
    def finding():
        return pkg.Finding(rule="TRC101", name="traced-branch",
                           severity="error", pass_name="trace", path="a.py",
                           line=3, symbol="M.tick", message="m")
    a, b = finding(), finding()
    b.line = 99
    assert a.fingerprint == b.fingerprint == "TRC101:a.py:M.tick"
    bl = pkg.Baseline([pkg.BaselineEntry(a.fingerprint, "why", "accepted"),
                       pkg.BaselineEntry("TRC999:gone.py:X", "old",
                                         "accepted")])
    assert bl.match(a) is not None
    assert [e.fingerprint for e in bl.stale_entries()] == \
        ["TRC999:gone.py:X"]
    rep = pkg.LintReport(findings=[a],
                         stale=[pkg.BaselineEntry("TRC9:x:y", "r")],
                         files_scanned=1, passes_run=("trace",))
    text = pkg.render_text(rep, color=False)
    assert "STALE" in text and "TRC101" in text
    assert "1 error(s)" in text
    assert rep.to_json()["summary"] == {"errors": 1, "warnings": 0,
                                        "suppressed": 0, "stale": 1}


# --- the CLI and the tree -----------------------------------------------------


def test_tree_clean_modulo_baseline(cli_report):
    """``lint --strict`` exits 0 on the tree; its report holds the
    fixture's seven findings as expected and the accepted ones, and no
    stale entry; the baseline's other entries are the opt-in passes'."""
    assert cli_report["passes"] == ["trace", "contract", "schema"]
    assert cli_report["findings"] == []
    assert cli_report["stale-baseline-entries"] == []
    sup = {f["fingerprint"]: f["baseline-status"]
           for f in cli_report["suppressed"]}
    assert sup == {**{f"{r}:{FIXTURE}:{FIXTURE_SYMBOL}": "expected"
                      for r in ALL_TRC},
                   **{fp: "accepted" for fp in ACCEPTED}}
    with open(tfindings.DEFAULT_BASELINE) as f:
        entries = json.load(f)["entries"]
    # the default passes' entries are this run's; the rest belong to the
    # opt-in ir, cost and lanes passes (tests/test_torch_ir.py runs them),
    # the ranges pass (tests/test_torch_ranges.py) and the shard pass
    # (tests/test_torch_shard.py)
    owner = {e["fingerprint"]: tfindings.fingerprint_pass(e["fingerprint"])
             for e in entries}
    assert {fp for fp, p in owner.items()
            if p in ("trace", "contract", "schema")} == set(sup)
    assert set(owner.values()) == {"trace", "ir", "lanes", "ranges",
                                   "shard"}
    assert all(e["reason"] for e in entries)


def test_no_baseline_reports_exactly_the_listed_findings(capsys):
    """Without the baseline, the trace and schema passes report the
    fixture's seven findings and the accepted ones, nothing else (the
    contract pass is clean: the CLI run above)."""
    rc = cli(["lint", "--no-baseline", "--json", "--pass", "trace",
              "--pass", "schema"])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 0
    got = {f["fingerprint"] for f in payload["findings"]}
    assert got == {f"{r}:{FIXTURE}:{FIXTURE_SYMBOL}" for r in ALL_TRC} \
        | ACCEPTED
    assert payload["passes"] == ["trace", "schema"]
    assert not torch.cuda.is_initialized()


def test_cli_strict_fails_on_the_fixture_without_baseline(capsys):
    rc = cli(["lint", "--strict", "--no-baseline", "--json", FIXTURE])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert payload["summary"]["errors"] == 6
    assert payload["summary"]["warnings"] == 1
    assert {f["rule"] for f in payload["findings"]} == set(ALL_TRC)
    assert payload["passes"] == ["trace"]
    # the baseline suppresses them all: exit 0, nothing stale in a
    # partial run
    rc = cli(["lint", "--strict", FIXTURE])
    text = capsys.readouterr().out
    assert rc == 0 and "7 baselined (7 expected-fixture)" in text
    assert "STALE" not in text


def test_cli_explicit_pass_with_paths(capsys):
    rc = cli(["lint", "--json", "--pass", "schema",
              "maelstrom_tpu_torch/models/echo.py"])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 0 and payload["passes"] == ["schema"]
    assert payload["findings"] == [] and payload["files-scanned"] == 0


@pytest.mark.parametrize("argv", [["--ir"], ["--cost"], ["--lanes"],
                                  ["--ranges"], ["--shard"], ["--aot"],
                                  ["--update-baseline"],
                                  ["--pass", "cost"],
                                  ["--aot", "--aot-store", "off"]])
def test_cli_refuses_the_jaxpr_passes(argv, capsys, monkeypatch, tmp_path):
    """The JAX CLI's jaxpr passes, each with the JAX CLI's exit code on
    the same arguments: ``ir``, ``cost``, ``lanes`` and ``ranges`` over
    the aten graph of the tick, ``shard`` over the mesh executor and
    ``aot`` over the chunk dispatch and the store (``--aot-store off``:
    the manifest gate alone). Both packages' universes are cut to echo
    at two nodes, no fixtures, so that the case stays small (the JAX
    shard audit's ``AbstractMesh`` on jax 0.9's signature, as
    ``tests/test_torch_shard.py`` routes it); ``--update-baseline``
    writes a temporary file in each."""
    runs = {"--ir": "ir", "--cost": "cost", "--lanes": "lanes",
            "--ranges": "ranges", "--update-baseline": "cost",
            "cost": "cost", "--shard": "shard", "--aot": "aot",
            "off": "aot"}
    name = runs[argv[-1]]
    from jax.sharding import AbstractMesh
    from maelstrom_tpu.analysis import cost_model as jcost
    from maelstrom_tpu.analysis import shard_audit as jshard
    from maelstrom_tpu.cli import main as jcli
    from maelstrom_tpu.models import ir_hazards as jhazards
    from maelstrom_tpu.parallel import mesh as jmesh
    from maelstrom_tpu_torch.analysis import cost_model as tcost
    from maelstrom_tpu_torch.models import ir_hazards as thazards
    for mod in (jcost, tcost):
        monkeypatch.setattr(mod, "cost_specs", lambda: [("echo", 2)])
    for mod in (jhazards, thazards):
        monkeypatch.setattr(mod, "IR_FIXTURE_MODELS", {})
        monkeypatch.setattr(mod, "LANE_FIXTURE_MODELS", {})
        monkeypatch.setattr(mod, "RANGE_FIXTURE_MODELS", {})
        monkeypatch.setattr(mod, "SHARD_FIXTURE_MODELS", {})
    monkeypatch.setattr(jshard, "_abstract_mesh", lambda size: AbstractMesh(
        (int(size),), (jmesh.AXIS,)))

    def extra(who):
        return (["--cost-baseline", str(tmp_path / f"{who}.json")]
                if "--update-baseline" in argv else [])
    rc = cli(["lint", "--json"] + argv + extra("torch"))
    payload = json.loads(capsys.readouterr().out)
    assert payload["passes"] == [name]
    assert payload["summary"]["errors"] == 0
    jrc = jcli(["lint", "--json"] + argv + extra("jax"))
    jpayload = json.loads(capsys.readouterr().out)
    assert jpayload["passes"] == [name]
    assert rc == jrc == 0