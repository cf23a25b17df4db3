"""Drain the queue; resume the dead. The campaign worker loop.

Counterpart of ``maelstrom_tpu/campaign/runner.py``. ``run_campaign`` is
what ``python -m maelstrom_tpu_torch campaign run`` executes: claim the
next item, run it through the chunked executor via ``run_torch_test``
(fail-fast, heartbeat, funnel and triage behave as on a hand-run test),
record the verdict on the item, repeat until the queue drains. Items
checkpoint their carry by default (``checkpoint_every``), so a worker
killed mid-item leaves a claimable ``preempted`` item whose next
claimer continues from the checkpoint instead of tick zero.

``resume_run`` is the single-run face of the same machinery: given a
killed run dir (campaign item or hand-run), rebuild the model and the
options from the heartbeat's run-start record — the replay contract
``triage`` relies on — restore the checkpoint, and finish the run equal
to an uninterrupted one.

Runs go to the card unless the caller passes ``device`` (``"cpu"``
runs the plain versions).
"""

from __future__ import annotations

import os
import time
import traceback
from typing import Any, Dict, List, Optional

from . import queue as q
from .checkpoint import CheckpointError, load_checkpoint

# campaign items checkpoint by default: durability is the point of
# queueing a run (a hand-run test keeps checkpointing opt-in)
DEFAULT_CHECKPOINT_EVERY = 4
# spec keys that select the model (spec.MODEL_KEYS) and that the port's
# harness does not take: the model carries them (its topology and n_keys
# ride the heartbeat's model-config)
_MODEL_ONLY_KEYS = ("workload", "topology", "key_count")


def _run_opts(opts: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in opts.items() if k not in _MODEL_ONLY_KEYS}


class LeaseKeeper:
    """Background renewal of a claimed item's lock lease while the item
    runs (``queue.renew_lease`` every TTL/3). A worker that dies stops
    renewing, the lease expires, and any host's next claim or requeue
    pass flips the item preempted. A daemon thread: a SIGKILL kills it
    with the worker, which is the point."""

    def __init__(self, lock_path: str,
                 ttl: float = q.DEFAULT_LEASE_TTL):
        import threading
        self._lock = lock_path
        self._ttl = ttl
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="lease-keeper", daemon=True)

    def _run(self):
        while not self._stop.wait(self._ttl / 3.0):
            if q.renew_lease(self._lock, ttl=self._ttl):
                continue
            # stop only when the lease is lost (finished, stolen or
            # lapsed); a transient write error while it is still ours
            # keeps retrying, or the lease would expire under a live
            # worker and invite a double claim
            if not q.lease_is_ours(self._lock):
                return

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=2.0)


def build_model(workload: str, opts: Dict[str, Any],
                model_config: Optional[Dict[str, Any]] = None):
    """The registry's model with the scalar knobs ``triage`` restores,
    so campaign items and resumes rebuild the automaton the original run
    simulated."""
    from ..checkers.triage import resolve_model
    model = resolve_model({"workload": workload, "opts": opts,
                           "model-config": model_config or {}})
    # fresh runs (no recorded model-config yet) honor the key_count opt
    # as the CLI does; a recorded n_keys wins on resume
    if opts.get("key_count") and hasattr(model, "n_keys") \
            and "n_keys" not in (model_config or {}):
        model.n_keys = opts["key_count"]
    return model


def resume_run(run_dir: str,
               opts_override: Optional[Dict[str, Any]] = None,
               device: Optional[str] = None) -> Dict[str, Any]:
    """Resume one killed checkpointed run in place on ``device``; returns
    the final results (also written to the run dir's results.json),
    equal to the run executed uninterrupted."""
    from ..checkers.triage import (TriageError, check_fingerprint,
                                   load_run_info)
    from ..harness import run_torch_test

    run_dir = os.path.realpath(run_dir)
    if load_checkpoint(run_dir) is None:
        raise CheckpointError(
            f"{run_dir} has no checkpoint/ to resume from — "
            f"checkpointing is enabled with --checkpoint-every K "
            f"(campaign items default to K={DEFAULT_CHECKPOINT_EVERY})")
    try:
        info = load_run_info(run_dir)
    except TriageError as e:
        raise CheckpointError(str(e))
    opts = dict(info["opts"])
    opts["seed"] = info["seed"]
    opts.update(opts_override or {})
    model = build_model(info["workload"], opts, info["model-config"])
    # the store's drift gate (EXE901): the resumed suffix must run the
    # code of the checkpointed prefix
    check_fingerprint(info, model, _run_opts(opts), CheckpointError,
                      "resume")
    return run_torch_test(model, _run_opts(opts), device=device,
                          resume_from=run_dir)


def _run_item(claim: q.Claim, store_root: str,
              overrides: Dict[str, Any],
              triage_invalid: bool = False,
              device: Optional[str] = None) -> Dict[str, Any]:
    """Execute (or resume) one claimed item; returns the finished item
    record."""
    item = claim.item
    opts = dict(item["opts"])
    opts.setdefault("checkpoint_every", DEFAULT_CHECKPOINT_EVERY)
    opts.setdefault("store_root", store_root)
    opts.update(overrides)
    workload = item["workload"]
    prev_dir = item.get("run-dir")
    t0 = time.monotonic()
    try:
        if prev_dir and load_checkpoint(prev_dir) is not None:
            # a previous attempt died mid-run: continue its segments
            results = resume_run(prev_dir, opts_override=overrides,
                                 device=device)
            results.setdefault("store-dir", prev_dir)
            resumed = True
        else:
            from ..harness import prepare_store_dir, run_torch_test
            model = build_model(workload, opts)
            # the run dir goes on the item before the run: a worker
            # SIGKILLed mid-horizon leaves the item pointing at the dir
            # whose checkpoint the next claimer resumes from
            run_dir = prepare_store_dir(model.name, store_root,
                                        tag=f"item{item['id']}")
            item = dict(item, **{"run-dir": run_dir})
            q.write_json_atomic(claim.path, item)
            claim = claim._replace(item=item)
            opts["store_dir"] = run_dir
            results = run_torch_test(model, _run_opts(opts), device=device)
            resumed = False
    except Exception as e:
        # retries with backoff (the spec's `retries`/`backoff-s`): a
        # FAILED item (a crash, a lost device; not an invalid verdict)
        # re-queues up to N times, each wait doubling
        failures = int(item.get("failures", 0)) + 1
        retries = int(item.get("retries", 0) or 0)
        fields = {"error": repr(e)[:500],
                  "traceback": traceback.format_exc()[-2000:],
                  "failures": failures,
                  "wall-s": round(time.monotonic() - t0, 2)}
        if failures <= retries:
            backoff = float(item.get("backoff-s", 30.0) or 0.0) \
                * (2 ** (failures - 1))
            history = list(item.get("backoff-history") or [])
            history.append(round(backoff, 2))
            return q.finish_item(
                claim, q.PENDING,
                **{**fields, "not-before": time.time() + backoff,
                   "backoff-history": history})
        return q.finish_item(claim, q.FAILED, **fields)
    run_dir = results.get("store-dir")
    if triage_invalid and results.get("valid?") is False and run_dir:
        try:
            from ..checkers.triage import triage_run
            triage_run(run_dir, device=device)
        except Exception:
            pass   # forensics are best-effort; the verdict stands
    # a retried item that now succeeded keeps no residue of the failed
    # attempt (an error string or a stale backoff window would mislead
    # campaign status and report)
    cleared = {k: None for k in ("error", "traceback", "not-before")
               if item.get(k) is not None}
    return q.finish_item(
        claim, q.DONE,
        **{**cleared,
           "run-dir": run_dir,
           "valid?": results.get("valid?"),
           "violating-instances": results.get("invariants", {})
           .get("violating-instances"),
           "msgs-per-sec": round(results.get("perf", {})
                                 .get("msgs-per-sec", 0.0), 1),
           "resumed-from-checkpoint": resumed,
           "wall-s": round(time.monotonic() - t0, 2)})


def run_campaign(cdir: str, store_root: Optional[str] = None,
                 max_items: Optional[int] = None,
                 overrides: Optional[Dict[str, Any]] = None,
                 triage_invalid: bool = False,
                 log=print, device: Optional[str] = None
                 ) -> Dict[str, Any]:
    """Drain the campaign queue from this process on ``device``. Returns
    ``{ran, done, failed, retried, invalid, items}``; a queue another
    worker drains at the same time is shared (claims are per-item
    locks)."""
    cdir = os.path.realpath(cdir)
    q.load_campaign(cdir)   # validates the dir
    if store_root is None:
        # store/campaigns/<name>/ -> store/: items land next to hand-run
        # tests
        store_root = os.path.dirname(os.path.dirname(cdir))
    ran: List[Dict[str, Any]] = []
    while max_items is None or len(ran) < max_items:
        claim = q.claim_next(cdir)
        if claim is None:
            # nothing claimable now, but an item in a retry backoff
            # window is still this worker's job: wait it out
            eta = q.next_retry_eta(cdir)
            if eta is None:
                break
            wait = max(0.0, eta - time.time())
            log(f"   (queue idle: next retry in {wait:.1f}s)")
            time.sleep(min(wait + 0.05, 5.0))
            continue
        item = claim.item
        log(f"== item {item['id']}: {item['workload']} "
            f"(attempt {item['attempts']}"
            + (f", {item['failures']} failure(s) so far"
               if item.get("failures") else "")
            + (", resuming" if item.get("run-dir") else "") + ")")
        with LeaseKeeper(claim.lock):
            done = _run_item(claim, store_root, dict(overrides or {}),
                             triage_invalid=triage_invalid, device=device)
        verdict = done.get("valid?")
        log(f"   -> {done['status']}"
            + (f", valid? {verdict}" if done["status"] == q.DONE else
               f": {done.get('error')}")
            + (f" (retrying in {done['backoff-history'][-1]}s, "
               f"failure {done['failures']}/{done.get('retries')})"
               if done["status"] == q.PENDING else ""))
        ran.append(done)
    return {
        "ran": len(ran),
        "done": sum(1 for r in ran if r["status"] == q.DONE),
        "failed": sum(1 for r in ran if r["status"] == q.FAILED),
        "retried": sum(1 for r in ran if r["status"] == q.PENDING),
        "invalid": sum(1 for r in ran
                       if r["status"] == q.DONE
                       and r.get("valid?") is not True),
        "items": ran,
    }
