"""The campaign spec, the run queue and its leases in the port, against
the JAX package where both produce the same thing.

- **Spec.** ``expand_items`` expands a sweep matrix into the JAX
  package's items, in its order, and refuses what it refuses;
  ``load_spec`` reads JSON and TOML alike.
- **Queue.** ``submit_campaign`` writes the JAX package's item records;
  claims are exclusive and in id order; a dead worker's lock is stale
  and its item re-claimed; ``requeue_stale`` (with and without
  ``force``), lease expiry and renewal, the ``LeaseKeeper``; retry
  backoff windows block claims. These are the JAX campaign tests
  (``tests/test_campaign.py``) run on the port's copies.
- **Store dirs.** ``prepare_store_dir`` gives concurrent runs distinct
  dirs, keeps ``latest`` resolvable throughout, and tags campaign items.

Tolerance: exact."""

import json
import os
import socket
import threading
import time

import pytest

from maelstrom_tpu.campaign import queue as jqueue
from maelstrom_tpu.campaign.spec import expand_items as jexpand_items
from maelstrom_tpu.campaign.spec import load_spec as jload_spec
from maelstrom_tpu_torch.campaign import queue as cqueue
from maelstrom_tpu_torch.campaign.runner import LeaseKeeper
from maelstrom_tpu_torch.campaign.spec import (SpecError, expand_items,
                                               load_spec)
from maelstrom_tpu_torch import harness
from maelstrom_tpu_torch.harness import prepare_store_dir

from test_campaign import ECHO_OPTS

MATRIX_SPEC = {
    "name": "m",
    "defaults": {"time_limit": 1.0, "checkpoint_every": 4},
    "matrix": {"workload": ["echo", "g-set"], "seed": [0, 1],
               "nemesis": [[], ["partition"]], "rate": 50.0},
    "items": [{"workload": "echo", "seed": 9, "retries": 2,
               "backoff_s": 0.5}],
}
DEAD_PID = (1 << 22) + 1   # beyond the default pid_max


def test_spec_matrix_expansion_matches_jax():
    items = expand_items(MATRIX_SPEC)
    assert items == jexpand_items(MATRIX_SPEC)
    assert len(items) == 9
    assert all(i["time_limit"] == 1.0 for i in items)
    combos = {(i["workload"], i["seed"]) for i in items[:8]}
    assert combos == {("echo", 0), ("echo", 1), ("g-set", 0),
                      ("g-set", 1)}
    assert items[8] == {"time_limit": 1.0, "checkpoint_every": 4,
                        "workload": "echo", "seed": 9, "retries": 2,
                        "backoff_s": 0.5}


def test_spec_matrix_varies_the_layout_as_jax():
    """A matrix over ``layout`` expands as JAX's, and each item takes its
    layout into its sim."""
    from maelstrom_tpu_torch.campaign.runner import _run_opts, build_model
    spec = {"name": "layouts", "defaults": dict(ECHO_OPTS),
            "matrix": {"workload": ["echo"], "layout": ["lead", "minor"]}}
    items = expand_items(spec)
    assert items == jexpand_items(spec)
    for item, layout in zip(items, ("lead", "minor")):
        opts = {k: v for k, v in item.items() if k != "workload"}
        sim = harness.make_sim_config(build_model("echo", opts),
                                      _run_opts(opts))
        assert sim.layout == item["layout"] == layout


@pytest.mark.parametrize("spec", [
    {"name": "empty"},
    {"matrix": {"seed": [1]}},                 # no workload
    {"items": ["echo"]},                        # an item that is no table
])
def test_spec_refusals_match_jax(spec):
    with pytest.raises(SpecError):
        expand_items(spec)
    with pytest.raises(ValueError):
        jexpand_items(spec)


@pytest.mark.parametrize("fmt", ["json", "toml", "bad-json"])
def test_load_spec_matches_jax(tmp_path, fmt):
    path = tmp_path / f"nightly.{fmt.split('-')[-1]}"
    if fmt == "toml":
        path.write_text('name = "nightly"\n[defaults]\ntime_limit = 0.5\n'
                        '[matrix]\nworkload = ["echo"]\nseed = [1, 2]\n')
    elif fmt == "json":
        path.write_text(json.dumps({k: v for k, v in MATRIX_SPEC.items()
                                    if k != "name"}))
    else:
        path.write_text("{not json")
    if fmt == "bad-json":
        with pytest.raises(SpecError, match="not valid JSON"):
            load_spec(str(path))
        return
    spec = load_spec(str(path))
    assert spec == jload_spec(str(path))
    assert spec["name"] == "nightly"
    assert expand_items(spec) == jexpand_items(spec)


def _items(cdir):
    out = []
    for item in cqueue.list_items(cdir):
        item = {k: v for k, v in item.items()
                if k not in ("_path", "updated")}
        out.append(item)
    return out


def test_submit_writes_jax_item_records(tmp_path):
    """The same spec submitted by each package: the same campaign record
    (less its time) and item records (less their times); the queue
    policy keys lifted off the options."""
    tdir = cqueue.submit_campaign(MATRIX_SPEC, str(tmp_path / "t"))
    jdir = jqueue.submit_campaign(MATRIX_SPEC, str(tmp_path / "j"))
    assert os.path.basename(tdir).startswith("m-")
    assert os.path.dirname(tdir) == str(tmp_path / "t" / "campaigns")
    meta = {k: v for k, v in cqueue.load_campaign(tdir).items()
            if k != "submitted"}
    assert meta == {k: v for k, v in jqueue.load_campaign(jdir).items()
                    if k != "submitted"}
    assert _items(tdir) == _items(jdir)
    last = _items(tdir)[-1]
    assert last["retries"] == 2 and last["backoff-s"] == 0.5
    assert "retries" not in last["opts"]
    assert "backoff_s" not in last["opts"]


def _tiny_campaign(store, n=2):
    return cqueue.submit_campaign(
        {"name": "t", "items": [dict(ECHO_OPTS, workload="echo", seed=s)
                                for s in range(n)]}, store)


def _forge_lock(path, **fields):
    with open(path, "w") as f:
        json.dump(fields, f)


def test_queue_claim_exclusive_and_ordered(tmp_path):
    cdir = _tiny_campaign(str(tmp_path), n=3)
    c0 = cqueue.claim_next(cdir, worker="w0")
    assert c0.item["id"] == 0 and c0.item["status"] == "running"
    c1 = cqueue.claim_next(cdir, worker="w1")
    assert c1.item["id"] == 1   # the running item 0 is skipped
    cqueue.finish_item(c0, cqueue.DONE, **{"valid?": True})
    cqueue.finish_item(c1, cqueue.FAILED, error="boom")
    c2 = cqueue.claim_next(cdir)
    assert c2.item["id"] == 2
    cqueue.finish_item(c2, cqueue.DONE, **{"valid?": True})
    assert cqueue.claim_next(cdir) is None
    assert [i["status"] for i in cqueue.list_items(cdir)] == \
        ["done", "failed", "done"]


def test_queue_stale_lock_reclaim(tmp_path):
    """A worker that died holding an item: its lock's pid is dead, the
    item flips to preempted and the next claimer takes it; a live lock
    is never stolen."""
    cdir = _tiny_campaign(str(tmp_path), n=1)
    claim = cqueue.claim_next(cdir, worker="doomed")
    _forge_lock(claim.lock, pid=DEAD_PID, host=socket.gethostname())
    again = cqueue.claim_next(cdir, worker="rescuer")
    assert again is not None and again.item["id"] == 0
    assert again.item["previous-status"] == "preempted"
    assert again.item["attempts"] == 2
    cqueue.finish_item(again, cqueue.DONE, **{"valid?": True})
    cdir2 = _tiny_campaign(str(tmp_path / "c2"), n=1)
    live = cqueue.claim_next(cdir2, worker="alive")
    assert cqueue.claim_next(cdir2, worker="thief") is None
    cqueue.finish_item(live, cqueue.DONE)


def test_requeue_stale_flips_dead_running_items(tmp_path):
    cdir = _tiny_campaign(str(tmp_path), n=2)
    claim = cqueue.claim_next(cdir)
    _forge_lock(claim.lock, pid=DEAD_PID, host=socket.gethostname())
    assert cqueue.requeue_stale(cdir) == [0]
    assert [i["status"] for i in cqueue.list_items(cdir)] == \
        ["preempted", "pending"]
    assert not os.path.exists(claim.lock)


@pytest.mark.parametrize("case", ["live-same-host", "lockless",
                                  "cross-host"])
def test_requeue_force(tmp_path, case):
    """``force`` reclaims lock-less and cross-host items, never a live
    same-host lock."""
    cdir = _tiny_campaign(str(tmp_path), n=1)
    claim = cqueue.claim_next(cdir)
    if case == "lockless":
        os.unlink(claim.lock)
    elif case == "cross-host":
        _forge_lock(claim.lock, pid=os.getpid(), host="some-other-host")
    assert cqueue.requeue_stale(cdir) == []
    want = [] if case == "live-same-host" else [0]
    assert cqueue.requeue_stale(cdir, force=True) == want
    assert cqueue.list_items(cdir)[0]["status"] == \
        ("running" if case == "live-same-host" else "preempted")


def test_lease_expiry_requeues_lost_remote_worker(tmp_path):
    cdir = _tiny_campaign(str(tmp_path), n=1)
    claim = cqueue.claim_next(cdir, worker="remote:1")
    with open(claim.lock) as f:
        assert json.load(f)["lease-expires"] > time.time()
    _forge_lock(claim.lock, pid=os.getpid(), host="some-other-host",
                worker="remote:1", claimed=time.time() - 900,
                **{"lease-expires": time.time() - 300})
    assert cqueue.requeue_stale(cdir) == [0]
    again = cqueue.claim_next(cdir, worker="rescuer")
    assert again is not None
    assert again.item["previous-status"] == "preempted"
    cqueue.finish_item(again, cqueue.DONE, **{"valid?": True})


def test_fresh_remote_lease_not_auto_stolen_force_overrides(tmp_path):
    cdir = _tiny_campaign(str(tmp_path), n=1)
    claim = cqueue.claim_next(cdir, worker="remote:1")
    _forge_lock(claim.lock, pid=os.getpid(), host="some-other-host",
                worker="remote:1", claimed=time.time(),
                **{"lease-expires": time.time() + 600})
    assert cqueue.requeue_stale(cdir) == []
    assert cqueue.claim_next(cdir, worker="thief") is None
    assert cqueue.requeue_stale(cdir, force=True) == [0]
    # a same-host live pid with a lapsed lease is still running
    cdir2 = _tiny_campaign(str(tmp_path / "local"), n=1)
    c2 = cqueue.claim_next(cdir2, worker="slow:1")
    _forge_lock(c2.lock, pid=os.getpid(), host=socket.gethostname(),
                worker="slow:1", claimed=time.time() - 900,
                **{"lease-expires": time.time() - 300})
    assert cqueue.requeue_stale(cdir2) == []
    assert cqueue.requeue_stale(cdir2, force=True) == []
    assert cqueue.claim_next(cdir2, worker="thief") is None


def test_expired_lease_claimed_directly(tmp_path):
    cdir = _tiny_campaign(str(tmp_path), n=1)
    claim = cqueue.claim_next(cdir, worker="remote:1")
    _forge_lock(claim.lock, pid=os.getpid(), host="some-other-host",
                worker="remote:1", claimed=time.time() - 900,
                **{"lease-expires": time.time() - 1})
    again = cqueue.claim_next(cdir, worker="rescuer")
    assert again is not None and again.item["claimed-by"] == "rescuer"
    cqueue.finish_item(again, cqueue.DONE)


def test_renew_lease_extends_and_stops_after_finish(tmp_path):
    cdir = _tiny_campaign(str(tmp_path), n=1)
    claim = cqueue.claim_next(cdir, worker="w")
    with open(claim.lock) as f:
        before = json.load(f)["lease-expires"]
    time.sleep(0.05)
    assert cqueue.renew_lease(claim.lock, worker="w")
    with open(claim.lock) as f:
        assert json.load(f)["lease-expires"] > before
    cqueue.finish_item(claim, cqueue.DONE)
    assert cqueue.renew_lease(claim.lock, worker="w") is False


def test_renew_lease_forfeits_when_stolen_or_lapsed(tmp_path):
    cdir = _tiny_campaign(str(tmp_path), n=1)
    claim = cqueue.claim_next(cdir, worker="w1")
    _forge_lock(claim.lock, **cqueue._lease_body("w2"))
    assert cqueue.renew_lease(claim.lock, worker="w1") is False
    with open(claim.lock) as f:
        assert json.load(f)["worker"] == "w2"   # untouched
    _forge_lock(claim.lock, **dict(cqueue._lease_body("w1"),
                                   **{"lease-expires": time.time() - 5}))
    assert cqueue.renew_lease(claim.lock, worker="w1") is False
    cqueue.finish_item(claim, cqueue.DONE)


def test_lease_is_ours_distinguishes_terminal_from_transient(tmp_path):
    cdir = _tiny_campaign(str(tmp_path), n=1)
    claim = cqueue.claim_next(cdir, worker="w1")
    assert cqueue.lease_is_ours(claim.lock, worker="w1")
    assert not cqueue.lease_is_ours(claim.lock, worker="w2")
    _forge_lock(claim.lock, **dict(cqueue._lease_body("w1"),
                                   **{"lease-expires": time.time() - 5}))
    assert not cqueue.lease_is_ours(claim.lock, worker="w1")
    cqueue.finish_item(claim, cqueue.DONE)
    assert not cqueue.lease_is_ours(claim.lock, worker="w1")


def test_lease_keeper_renews_while_item_runs(tmp_path):
    cdir = _tiny_campaign(str(tmp_path), n=1)
    claim = cqueue.claim_next(cdir)   # as this process's worker id
    with open(claim.lock) as f:
        before = json.load(f)["claimed"]
    with LeaseKeeper(claim.lock, ttl=0.3):
        time.sleep(0.5)
    with open(claim.lock) as f:
        lock = json.load(f)
    assert lock["claimed"] > before
    assert lock["lease-expires"] > time.time()
    cqueue.finish_item(claim, cqueue.DONE)


def test_backoff_window_blocks_claims(tmp_path):
    cdir = _tiny_campaign(str(tmp_path), n=1)
    claim = cqueue.claim_next(cdir)
    cqueue.finish_item(claim, cqueue.PENDING, failures=1,
                       **{"not-before": time.time() + 30.0})
    assert cqueue.claim_next(cdir) is None   # the window still runs
    eta = cqueue.next_retry_eta(cdir)
    assert eta is not None and eta > time.time()
    item = json.load(open(cqueue.item_path(cdir, 0)))
    item["not-before"] = time.time() - 1.0
    cqueue.write_json_atomic(cqueue.item_path(cdir, 0), item)
    assert cqueue.next_retry_eta(cdir) is None
    claim = cqueue.claim_next(cdir)
    assert claim is not None and claim.item["id"] == 0


def test_unreadable_item_listed_not_claimed(tmp_path):
    cdir = _tiny_campaign(str(tmp_path), n=2)
    with open(cqueue.item_path(cdir, 0), "w") as f:
        f.write("{torn")
    items = cqueue.list_items(cdir)
    assert items[0]["status"] == "unreadable"
    assert cqueue.claim_next(cdir).item["id"] == 1
    with pytest.raises(cqueue.QueueError):
        cqueue.load_campaign(str(tmp_path))


def test_prepare_store_dir_concurrent_collision_free(tmp_path):
    """Runs sharing a test name get distinct dirs, and ``latest``
    always resolves to an existing run dir while they churn."""
    store = str(tmp_path)
    dirs, errors, seen_bad = [], [], []

    def spin():
        try:
            for _ in range(8):
                dirs.append(prepare_store_dir("echo", store))
        except Exception as e:   # pragma: no cover
            errors.append(e)

    stop = [False]
    latest = os.path.join(store, "echo-torch", "latest")

    def reader():
        while not stop[0]:
            if os.path.lexists(latest) and not os.path.exists(latest):
                seen_bad.append("dangling")   # pragma: no cover

    watcher = threading.Thread(target=reader)
    watcher.start()
    threads = [threading.Thread(target=spin) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    stop[0] = True
    watcher.join(timeout=60)
    assert not any(t.is_alive() for t in threads + [watcher]), \
        "a store-dir thread hung past its 60 s bound"
    assert not errors and not seen_bad
    assert len(dirs) == len(set(dirs)) == 32
    assert os.path.isdir(os.path.realpath(latest))
    d = prepare_store_dir("echo", store, tag="item7")
    assert d.endswith("-item7") and os.path.isdir(d)
