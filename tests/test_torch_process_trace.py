"""Process-runtime runs held op for op, port against the JAX package.

- At one worker, with no latency, loss or nemesis, a fixed seed and a
  deterministic node, a run's history projected onto ``(process, type,
  f, value)`` and its net journal projected onto ``(src, dest, body)``
  equal the JAX run's over the common prefix of their main phases (a
  run stops on the wall clock, so one may hold an op more than the
  other, and one that falls behind starts its final reads an op
  earlier), with at least 20 completed ops in each.
- A node that exits early, and one that prints a line that is not JSON:
  both packages give ``valid?`` False and the same ``crashed`` text once
  the paths are taken out.
- The demo's must-be-caught mutant, ``kafka_txn.py --no-atomic`` under
  multi-mop ``--txn`` load, at 3 s: both flag it invalid.
"""

import sys
import textwrap

import pytest

from torch_process_cases import (common_prefix_equal, final_phase_start,
                                 history_projection, journal_projection,
                                 node_opts, run_pair)
from torch_tutorial_cases import one_torch_thread  # noqa: F401

ONE_WORKER = dict(concurrency=1, rate=50.0, time_limit=1.5, latency=0.0,
                  p_loss=0.0, nemesis=[], recovery_time=0.2, seed=7)

# (id, workload, node, options beside ONE_WORKER). The stats checker
# wants an ok of every f, and seed 7's history has its last first ok at
# completed op 1 (echo, txn-single), 3 (g-set), 55 (kafka-single:
# list_committed_offsets) and 58 (lin-kv-proxy: cas). Each time limit
# lets an unloaded run complete at least three times that many ops (about
# 43 a second at one worker), so a run that falls behind on a busy host
# still reaches them.
PROJECTED = [
    ("echo", "echo", "echo.py", {"time_limit": 1.5}),
    ("lin-kv-proxy", "lin-kv", "lin_kv_proxy.py", {"time_limit": 4.0}),
    ("txn-single", "txn-list-append", "txn_single.py", {"time_limit": 1.5}),
    ("kafka-single", "kafka", "kafka_single.py", {"time_limit": 4.0}),
    ("g-set", "g-set", "g_set.py", {"time_limit": 1.5}),
]


def invalid_checkers(res):
    """The checkers of a results map whose ``valid?`` is false, with the
    stats checker's failing fs (``stats.cas``)."""
    out = []
    for name, sub in sorted(res.items()):
        if isinstance(sub, dict) and sub.get("valid?") is False:
            out.append(name)
            out += [f"{name}.{f}" for f, e in
                    sorted(sub.get("by-f", {}).items())
                    if e.get("valid?") is False]
    return out


@pytest.mark.parametrize("case", PROJECTED, ids=[c[0] for c in PROJECTED])
def test_one_worker_projection(case, tmp_path):
    _, workload, node, extra = case
    runs = run_pair(workload, {**ONE_WORKER, **node_opts(node), **extra,
                               "node_count": 1}, tmp_path)
    (jres, jdir), (tres, tdir) = runs["jax"], runs["torch"]
    assert jres["valid?"] is True and tres["valid?"] is True, \
        f"invalid: jax {invalid_checkers(jres)}, " \
        f"torch {invalid_checkers(tres)}"
    # each run's main phase: its generator's ops are the seed's, but the
    # op at which the wall clock ends the phase is not (a run that falls
    # behind under load switches to its final reads earlier)
    jend, tend = final_phase_start(jdir), final_phase_start(tdir)
    jh, th = history_projection(jdir, jend), history_projection(tdir, tend)
    n = common_prefix_equal(jh, th)
    completed = [r for r in th[:n] if r[1] != "invoke"]
    assert len(completed) >= 20, len(completed)
    assert common_prefix_equal(journal_projection(jdir, jend),
                               journal_projection(tdir, tend)) >= 40


# a node that answers init and three echoes, then exits 3
EXITS_EARLY = """
import json, sys
served = 0
for line in sys.stdin:
    msg = json.loads(line)
    body = msg["body"]
    out = {"in_reply_to": body["msg_id"]}
    if body["type"] == "init":
        out["type"] = "init_ok"
    else:
        out.update(type="echo_ok", echo=body["echo"])
        served += 1
    print(json.dumps({"src": msg["dest"], "dest": msg["src"],
                      "body": out}), flush=True)
    if served == 3:
        print("giving up after three echoes", file=sys.stderr, flush=True)
        sys.exit(3)
"""

# a node that serves echo but prints a line that is not JSON after init
NOT_JSON = """
import json, sys
for line in sys.stdin:
    msg = json.loads(line)
    body = msg["body"]
    out = {"in_reply_to": body["msg_id"]}
    if body["type"] == "init":
        out["type"] = "init_ok"
    else:
        out.update(type="echo_ok", echo=body["echo"])
    print(json.dumps({"src": msg["dest"], "dest": msg["src"],
                      "body": out}), flush=True)
    if body["type"] == "init":
        print("ready to echo!", flush=True)
"""


@pytest.mark.parametrize("name,src", [("exits-early", EXITS_EARLY),
                                      ("not-json", NOT_JSON)],
                         ids=["exits-early", "not-json"])
def test_crashed_node(name, src, tmp_path):
    path = tmp_path / f"{name}.py"
    path.write_text(textwrap.dedent(src))
    runs = run_pair("echo", {**ONE_WORKER, **node_opts(str(path)),
                             "node_count": 1, "time_limit": 1.0},
                    tmp_path)
    texts = []
    for res, _ in runs.values():
        assert res["valid?"] is False
        texts.append(res["crashed"].replace(str(path), "NODE")
                     .replace(sys.executable, "PYTHON"))
    assert texts[0] == texts[1]
    if name == "exits-early":
        assert "exited with status 3" in texts[1]
        assert "giving up after three echoes" in texts[1]
    else:
        assert "was not well-formed JSON" in texts[1]
        assert "'ready to echo!'" in texts[1]


def test_no_atomic_kafka_mutant_caught(tmp_path):
    """The demo's entry (``cli.py``'s DEMOS), with the demo's options at
    a 3 s time limit: the time limit ``chip_smoke.py`` runs the demo
    at."""
    opts = dict(node_count=3, concurrency=4, rate=25.0, txn=True,
                time_limit=3.0, recovery_time=1.0, seed=1,
                **node_opts("kafka_txn.py", "--no-atomic"))
    runs = run_pair("kafka", opts, tmp_path)
    for res, _ in runs.values():
        assert res["valid?"] is False
        assert res["workload"]["valid?"] is False
