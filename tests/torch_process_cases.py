"""Shared pieces of the process-runtime parity tests: one run of the JAX
package's ``run_test`` and one of the port's on the same node and
options, side by side in two threads (a run mostly waits on the wall
clock), each with a store of its own, and the projections they are
compared by.

Every run ends its nodes before it returns (``DB.teardown`` in the
runner's ``finally``); :func:`run_pair` adds a deadline of its own, so
that a run that hangs fails its test instead of holding a test worker.
"""

import json
import os
import sys
import threading

from maelstrom_tpu.runner import run_test as jax_run_test
from maelstrom_tpu_torch import run_test as torch_run_test

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples", "python")

# the tier-1 runs' options (tests/test_e2e_process.py)
E2E = dict(time_limit=2.0, rate=30.0, concurrency=4, recovery_time=0.5,
           seed=42)
# a run past this many seconds fails its test
PAIR_DEADLINE_S = 120.0


def node_opts(node, *args):
    """``bin`` and ``bin_args`` of a bundled node, or of a node file."""
    path = node if os.path.isabs(node) else os.path.join(EXAMPLES, node)
    return dict(bin=sys.executable, bin_args=[path, *args])


def run_pair(workload, opts, tmp_path):
    """``run_test`` of both packages on ``opts``, at once: ``{"jax":
    (results, run dir), "torch": (...)}``."""
    out = {}

    def one(name, fn):
        root = str(tmp_path / name)
        try:
            res = fn(workload, dict(opts, store_root=root))
            out[name] = (res, os.path.realpath(
                os.path.join(root, workload, "latest")))
        except BaseException as e:     # surfaced below
            out[name] = e

    threads = [threading.Thread(target=one, args=(name, fn), daemon=True)
               for name, fn in (("jax", jax_run_test),
                                ("torch", torch_run_test))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(PAIR_DEADLINE_S)
    assert not any(t.is_alive() for t in threads), \
        f"a {workload} run took more than {PAIR_DEADLINE_S} s"
    for name in ("jax", "torch"):
        if isinstance(out[name], BaseException):
            raise out[name]
    return out


def key_tree(v):
    """The nested keys of a results map (list contents left out)."""
    if isinstance(v, dict):
        return {k: key_tree(x) for k, x in v.items()}
    return None


def store_files(run_dir):
    """Every file of a run dir, by path relative to it."""
    out = set()
    for root, _, files in os.walk(run_dir):
        for f in files:
            out.add(os.path.relpath(os.path.join(root, f), run_dir))
    return out


def _history(run_dir):
    with open(os.path.join(run_dir, "history.jsonl")) as f:
        return [json.loads(line) for line in f]


def final_phase_start(run_dir):
    """The time the run's final generator invoked its first op (None
    when it has none). Where the main phase ends is a matter of the wall
    clock: each run's own time, which no second run shares."""
    return next((r["time"] for r in _history(run_dir) if r.get("final")),
                None)


def history_projection(run_dir, before=None):
    """``(process, type, f, value)`` of each record of ``history.jsonl``
    (those earlier than ``before``, when given)."""
    return [(r["process"], r["type"], r["f"], r.get("value"))
            for r in _history(run_dir)
            if before is None or r["time"] < before]


def journal_projection(run_dir, before=None):
    """``(src, dest, body)`` of each journal event, in time order (those
    earlier than ``before``, when given)."""
    d = os.path.join(run_dir, "net-journal")
    evs = []
    for name in os.listdir(d):
        with open(os.path.join(d, name)) as f:
            evs.extend(json.loads(line) for line in f if line.strip())
    evs.sort(key=lambda e: e["time"])
    return [(e["message"]["src"], e["message"]["dest"],
             e["message"]["body"]) for e in evs
            if before is None or e["time"] < before]


def common_prefix_equal(a, b):
    """``a`` and ``b`` agree over their common prefix; its length."""
    n = min(len(a), len(b))
    for i in range(n):
        assert a[i] == b[i], (i, a[i], b[i])
    return n
