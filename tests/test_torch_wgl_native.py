"""The port's linearizability checker against the JAX package's, with the
native WGL core (``checkers/native.py``, built from
``cpp/checker/wgl.cpp``).

Both packages check each key in the native core first with ten times
the state budget, and in the Python search only when the core cannot
take the case. A port that ran the Python search alone (at 1x) gave
``"unknown"`` where JAX gives a definite verdict on histories whose
search needs between 1x and 10x the budget.

- On random single-key register histories (8 processes, 40
  invoke/complete pairs, writes of increasing values, reads returning
  mostly the current value, else the previous or none, one completion
  in ten lost), drawn
  from seeds with numpy, the port's ``linearizable_kv_checker`` equals
  JAX's at budgets 20, 100 and 1,000 and at the default, and some of
  those histories are ones where the Python search alone says
  ``"unknown"`` and both packages give a definite verdict.
- The library is built from ``cpp/checker/wgl.cpp`` into the build
  directory (named by the source's hash), and a missing compiler
  raises, naming what is missing.

Tolerance: exact."""

import os

import numpy as np
import pytest

from maelstrom_tpu.checkers import linearizable as jlin
from maelstrom_tpu_torch.checkers import linearizable as lin
from maelstrom_tpu_torch.checkers import native

from torch_tutorial_cases import one_torch_thread  # noqa: F401 (autouse)

BUDGETS = (20, 100, 1000)


def register_history(seed: int, n_procs: int = 8, n_ops: int = 40):
    """A random one-key register history: each step invokes an op on an
    idle process or completes an open one; writes store 1, 2, 3, ...;
    a read returns the current value (p 0.8), the one before it (0.15)
    or nothing (nil, 0.05); one completion in ten is lost (info)."""
    rs = np.random.RandomState(seed)
    hist, open_ops = [], {}
    value = prev = None
    written = 0
    t = 0
    invoked = 0
    while invoked < n_ops or open_ops:
        t += 1
        idle = [p for p in range(n_procs) if p not in open_ops]
        if invoked < n_ops and idle and (not open_ops or rs.rand() < 0.5):
            p = int(rs.choice(idle))
            if rs.rand() < 0.5:
                written += 1
                op = ("write", written)
            else:
                op = ("read", None)
            open_ops[p] = op
            hist.append({"process": p, "type": "invoke", "f": op[0],
                         "value": ["k", op[1]], "time": t})
            invoked += 1
            continue
        p = int(rs.choice(sorted(open_ops)))
        f, arg = open_ops.pop(p)
        if rs.rand() < 0.1:
            hist.append({"process": p, "type": "info", "f": f,
                         "value": ["k", arg], "time": t})
            continue
        if f == "write":
            prev, value = value, arg
            out = arg
        else:
            out = [value, prev, None][rs.choice(3, p=(0.8, 0.15, 0.05))]
        hist.append({"process": p, "type": "ok", "f": f,
                     "value": ["k", out], "time": t})
    for i, r in enumerate(hist):
        r["index"] = i
    return hist


def python_only(history, budget):
    """The verdict of the Python search alone at ``budget`` (the port's
    checker before the native core)."""
    return lin.check_register_history(lin._collect_ops(history, "k"),
                                      budget_states=budget)


@pytest.mark.parametrize("budget", BUDGETS)
def test_verdicts_equal_jax_at_small_budgets(budget):
    gaps = 0
    for seed in range(200):
        h = register_history(seed)
        got = lin.linearizable_kv_checker(h, budget_states=budget)
        want = jlin.linearizable_kv_checker(h, budget_states=budget)
        assert got == want, (seed, budget, got, want)
        if python_only(h, budget) == "unknown" and \
                got["valid?"] != "unknown":
            gaps += 1
    # histories the Python search alone could not decide at this budget
    assert gaps > 0, budget


def test_verdicts_equal_jax_at_default_budget():
    verdicts = set()
    for seed in range(60):
        h = register_history(seed)
        got = lin.linearizable_kv_checker(h)
        assert got == jlin.linearizable_kv_checker(h), seed
        verdicts.add(got["valid?"])
    assert verdicts == {True, False}


def test_library_built_from_source(tmp_path):
    path = native.build_library()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(path).startswith("libwgl-")
    assert native.SOURCE.endswith(os.path.join("cpp", "checker", "wgl.cpp"))
    assert native.load() is native.load()
    # a fresh build directory builds the same library again
    again = native.build_library(str(tmp_path / "wgl"))
    assert os.path.basename(again) == os.path.basename(path)
    with open(again, "rb") as f:
        assert f.read(4) == b"\x7fELF"


def test_missing_compiler_raises(tmp_path):
    with pytest.raises(RuntimeError, match="no-such-c..-compiler"):
        native.build_library(str(tmp_path / "wgl"),
                             cxx="no-such-c++-compiler")
    assert not os.path.exists(tmp_path / "wgl")
