"""The checker farm's fallback and parts (``checkers/pool.py``) and the
streaming decoder (``decode.StreamDecoder``).

- **Killed pool.** Every worker SIGKILLed at the first feed, in a run
  whose entry point is a script file (so the pool spawns under pytest's
  xdist workers too): the run completes with the serial verdicts and
  says ``pooled-fallback-serial`` (the JAX test's assertions,
  ``tests/test_check_pool.py:238-264``).
- ``_IncrementalUniqueIds`` fed in ragged chunks equals the batch
  checker (and the JAX package's).
- A checker that raises gives the same structured invalid verdict
  (instance, checker name, traceback) from a worker's main loop and from
  the serial path, and the composed verdict is False with
  ``checker-errors``.
- ``resolve_check_workers``'s auto rule, and ``StreamDecoder`` fed chunk
  by chunk equals the one-shot compact decode and the dense decode.

Tolerance: exact."""

import json
import os
import queue
import subprocess
import sys

from maelstrom_tpu.checkers.unique_ids import \
    unique_ids_checker as junique_ids_checker
from maelstrom_tpu_torch import decode, harness, runtime
from maelstrom_tpu_torch.checkers import checker_failure, pool
from maelstrom_tpu_torch.checkers.unique_ids import unique_ids_checker
from maelstrom_tpu_torch.models import get_model
from maelstrom_tpu_torch.models.echo import EchoModel
from maelstrom_tpu_torch.pipeline import run_sim_pipelined

from test_torch_check_pool import DECODE_OPTS, REPO
from torch_tutorial_cases import one_thread_env
from torch_tutorial_cases import one_torch_thread  # noqa: F401 (autouse)


KILL_SCRIPT = '''\
import json
import sys

from maelstrom_tpu_torch import harness
from maelstrom_tpu_torch.checkers import pool
from maelstrom_tpu_torch.models import get_model


def main():
    opts = json.loads(sys.argv[1])
    real_feed = pool.CheckerPool.feed
    state = {"killed": False}

    def kill_then_feed(self, slabs):
        if not state["killed"]:
            self.kill()          # every worker dies mid-run
            state["killed"] = True
        return real_feed(self, slabs)

    pool.CheckerPool.feed = kill_then_feed
    res = harness.run_torch_test(get_model("lin-kv", 3), opts,
                                 device="cpu")
    print(json.dumps({"killed": state["killed"],
                      "check": res["perf"]["phases"]["check"],
                      "instances": res["instances"],
                      "valid?": res["valid?"]}))


if __name__ == "__main__":
    main()
'''


def test_pool_killed_mid_run_falls_back_to_serial(tmp_path):
    opts = dict(DECODE_OPTS, funnel=False)
    serial = harness.run_torch_test(get_model("lin-kv", 3),
                                    dict(opts, check_workers=0),
                                    device="cpu")
    script = tmp_path / "kill_pool.py"
    script.write_text(KILL_SCRIPT)
    proc = subprocess.run(
        [sys.executable, str(script),
         json.dumps(dict(opts, check_workers=2))],
        cwd=REPO, env=dict(one_thread_env(), PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    pooled = json.loads(proc.stdout.strip().splitlines()[-1])
    assert pooled["killed"], "pool was never exercised"
    assert pooled["check"]["mode"] == "pooled-fallback-serial", \
        pooled["check"]
    assert pooled["instances"] == json.loads(json.dumps(
        serial["instances"]))
    assert pooled["valid?"] == serial["valid?"]


def test_incremental_unique_ids_matches_batch():
    history = []
    for i, val in enumerate([7, 3, 7, 12, 3, 3, 99]):
        history.append({"f": "generate", "value": None,
                        "type": "invoke", "index": 2 * i})
        history.append({"f": "generate", "value": val, "type": "ok",
                        "index": 2 * i + 1})
    history.append({"f": "generate", "value": None, "type": "invoke",
                    "index": len(history)})   # unacknowledged tail
    inc = pool._IncrementalUniqueIds(None, {})
    for lo in range(0, len(history), 3):      # ragged chunking
        inc.feed(history[lo:lo + 3])
    assert inc.result() == unique_ids_checker(history)
    assert inc.result() == junique_ids_checker(history)
    assert inc.result()["valid?"] is False


class _Blowup(Exception):
    pass


def _exploding_checker(self):
    def chk(history, opts):
        raise _Blowup("checker exploded on purpose")
    return chk


def test_checker_blowup_is_structured_invalid(monkeypatch):
    """The serial path and a farm worker (its main loop run in this
    process) give the same failing verdict for a checker that raises."""
    monkeypatch.setattr(EchoModel, "checker", _exploding_checker)
    opts = dict(node_count=2, concurrency=2, n_instances=8,
                record_instances=2, time_limit=0.3, rate=100.0,
                latency=5.0, seed=3, check_workers=0, funnel=False)
    model = get_model("echo", 2)
    res = harness.run_torch_test(model, opts, device="cpu")
    assert res["valid?"] is False
    assert res["checker-errors"] == 2
    inst = res["instances"][0]
    assert inst["valid?"] is False and inst["instance"] == 0
    assert inst["checker"] == pool.checker_name(model)
    assert "_Blowup" in inst["traceback"]
    assert "checker exploded on purpose" in inst["error"]

    sim = harness.make_sim_config(model, {**harness.TORCH_DEFAULTS,
                                          **opts})
    carry, ys = runtime.run_sim(model, sim, opts["seed"], "cpu")
    slabs = decode.decode_dense(model, ys.events.numpy())
    spec = pool.pool_spec(model, {**harness.TORCH_DEFAULTS, **opts},
                          sim.client.final_start, 1)
    task_q, result_q = queue.Queue(), queue.Queue()
    # the worker hides the cards from its process: restored after the test
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    for task in (("chunk", slabs), ("finalize", [0, 1]), ("stop",)):
        task_q.put(task)
    pool._worker_main(0, spec, task_q, result_q)
    assert result_q.get()[0] == "ready"
    tag, _, verdicts = result_q.get()
    assert tag == "done"
    serial = pool.check_instances(
        model, decode.LazyHistories(model, slabs, 2,
                                    sim.client.final_start, 1), opts)
    assert [verdicts[0], verdicts[1]] == serial
    assert serial[0] == {k: v for k, v in inst.items()}
    try:
        raise ValueError("boom")
    except ValueError as e:
        v = checker_failure(e, checker="elle-list-append", instance=5)
    assert v["traceback"].endswith("ValueError: boom\n")


def test_resolve_check_workers_auto():
    assert pool.resolve_check_workers(0, 512) == 0
    assert pool.resolve_check_workers(3, 512) == 3
    auto = pool.resolve_check_workers(None, 512)
    if (os.cpu_count() or 1) >= 2:
        assert 1 <= auto <= 4
    else:
        assert auto == 0
    assert pool.resolve_check_workers("auto", 512) == auto
    assert pool.resolve_check_workers(None, 4) == 0


def test_stream_decoder_chunked_equals_one_shot():
    model = get_model("echo", 2)
    opts = {**harness.TORCH_DEFAULTS,
            **dict(node_count=2, concurrency=2, n_instances=8,
                   record_instances=4, time_limit=0.3, rate=100.0,
                   latency=5.0, seed=3)}
    sim = harness.make_sim_config(model, opts)
    fs = sim.client.final_start
    fed = []
    sd = decode.StreamDecoder(model, sim.client.n_clients, 4, fs, 1,
                              on_slabs=fed.append)
    res = run_sim_pipelined(model, sim, 3, "cpu", chunk=50,
                            event_sink=sd.feed)
    streamed = list(sd.finish())
    assert len(fed) == len(res.compact) == 6
    one_shot = decode.LazyHistories(
        model, decode.decode_compact(model, sim.client.n_clients, 4,
                                     res.compact), 4, fs, 1)
    _, ys = runtime.run_sim(model, sim, 3, "cpu")
    dense = decode.LazyHistories(
        model, decode.decode_dense(model, ys.events.numpy()), 4, fs,
        1)
    dump = lambda hs: [json.dumps(h) for h in hs]
    assert dump(streamed) == dump(one_shot) == dump(dense)
    assert sum(len(h) for h in dense) > 20
    # the running index continues across a streamed instance's slabs
    assert all([r["index"] for r in h] == list(range(len(h)))
               for h in streamed)
    assert sd.decode_s > 0
