"""The port's ``demo`` against the JAX CLI's, each in a child process of
its own, side by side (a demo entry mostly waits on the wall clock).

- With ``DEMOS`` patched in both CLIs to one subset (echo, the lin-kv
  proxy and the native engine's lin-kv entry), the port prints the same
  label and verdict lines and the same last line.
- The whole matrix (``slow``): the same verdict for every entry, each
  valid or, for the mutants, caught (the process runtime's and the
  native engine's); both exit 0.

(``tests/test_torch_native.py`` holds the six native entries to JAX's
verdicts in tier 1.)
"""

import json
import os
import subprocess
import sys

import pytest

from maelstrom_tpu import cli as jcli
from maelstrom_tpu_torch import __main__ as tcli

from torch_process_cases import REPO
from torch_tutorial_cases import one_torch_thread  # noqa: F401

# a child that runs one CLI's demo, DEMOS cut to the given indices
CHILD = """
import json, sys
pkg, picks, argv = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3:]
if pkg == "jax":
    from maelstrom_tpu import cli
else:
    from maelstrom_tpu_torch import __main__ as cli
if picks is not None:
    cli.DEMOS = [cli.DEMOS[i] for i in picks]
sys.exit(cli.main(["demo", *argv]))
"""
NATIVE = [i for i, e in enumerate(jcli.DEMOS)
          if e[2].get("runtime") == "native"]
SUBSET = [0, 9, NATIVE[0]]


def run_both(picks, tmp_path, timeout, *argv):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    procs = {pkg: subprocess.Popen(
        [sys.executable, "-c", CHILD, pkg, json.dumps(picks), *argv,
         "--store", str(tmp_path / pkg)], cwd=tmp_path, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pkg in ("jax", "torch")}
    out = {}
    try:
        for pkg, p in procs.items():
            stdout, stderr = p.communicate(timeout=timeout)
            out[pkg] = (p.returncode, stdout.splitlines(), stderr)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def entries(lines):
    """``(label, verdict line)`` of each entry a demo printed."""
    return [(lines[i], lines[i + 1]) for i in range(len(lines) - 1)
            if lines[i].startswith("== ")]


def test_demos_copied_verbatim():
    assert tcli.DEMOS == jcli.DEMOS
    assert len(tcli.DEMOS) == 30 and len(NATIVE) == 6


def test_demo_subset_matches_jax(tmp_path):
    out = run_both(SUBSET, tmp_path, 120, "--time-limit", "2")
    (jrc, jlines, jerr), (trc, tlines, terr) = out["jax"], out["torch"]
    assert jrc == trc == 0, (jerr[-2000:], terr[-2000:])
    je, te = entries(jlines), entries(tlines)
    assert [label for label, _ in te] == [label for label, _ in je]
    assert je == te == [(label, "   valid!") for label, _ in je]
    assert te[2][0] == "== lin-kv / (native engine)"
    assert tlines[-1] == jlines[-1] == "All 3 demos passed. ヽ(‘ー`)ノ"


@pytest.mark.slow
def test_whole_demo_matches_jax(tmp_path):
    out = run_both(None, tmp_path, 1500)
    (jrc, jlines, jerr), (trc, tlines, terr) = out["jax"], out["torch"]
    je, te = entries(jlines), entries(tlines)
    assert [label for label, _ in te] == [label for label, _ in je]
    assert len(te) == 30
    for i, ((label, jv), (_, tv)) in enumerate(zip(je, te)):
        want = ("   valid!" if len(tcli.DEMOS[i]) < 4 else
                "   caught (mutant flagged invalid)")
        assert tv == jv == want, (label, jv, tv)
    assert jrc == trc == 0, (jerr[-2000:], terr[-2000:])
    assert tlines[-1] == jlines[-1] == "All 30 demos passed. ヽ(‘ー`)ノ"
