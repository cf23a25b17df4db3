"""The resumable run queue: file-lock-claimed work items on shared disk.

A copy of ``maelstrom_tpu/campaign/queue.py``: the same directory
layout, item records and lock leases.

No daemon, no database — a campaign is a directory (the same
philosophy as the store itself), so any number of workers on any hosts
sharing the filesystem can drain one campaign:

.. code-block:: text

    store/campaigns/<name>-<ts>/
      campaign.json            # the submitted spec + expansion record
      items/item-0007.json     # one work item: opts + status + history
      items/item-0007.lock     # O_EXCL claim (pid/host/time), while running
      summary.json             # written by `campaign report`

State machine per item (all transitions via write-temp-then-rename, so
readers never see a torn item file)::

    pending ──claim──> running ──finish──> done | failed
       ^                  │
       └── preempted <────┘  (worker died: stale lock detected)

A claim is an ``O_CREAT | O_EXCL`` lock-file create — the one
filesystem primitive that is atomic everywhere — so two workers can
never run the same item. A worker killed mid-item leaves status
``running`` with a lock whose pid is dead; any later claimer (or
``campaign resume``) detects the stale lock, steals it atomically via
rename, marks the item ``preempted``, and the item becomes claimable
again — resumed from its run dir's last checkpoint rather than from
tick zero (``checkpoint.py``).

Locks are **leases**: every claim records ``lease-expires`` (now +
``DEFAULT_LEASE_TTL`` seconds) and the worker renews it while the item
runs (``runner.LeaseKeeper``, every TTL/3). Staleness is two-tiered:
on the holder's own host the pid probe is authoritative (dead = stale
immediately, alive = never stale, lapsed lease or not), and a
cross-host lock is stale once its lease EXPIRES — a lost remote
worker's items requeue by themselves on the next ``claim_next`` /
``requeue_stale`` pass, no ``requeue_stale --force`` needed. ``force``
stays the operator's lever for a remote worker known lost before its
TTL runs out. Renewal forfeits rather than races: a renewer that finds
its lock stolen or its lease already expired stops without writing, so
only expired/dead locks — which have no live renewer — are ever
stolen, and the claim's ``O_EXCL`` create remains the single arbiter.
"""

from __future__ import annotations

import json
import os
import socket
import time
from typing import Any, Dict, List, NamedTuple, Optional

CAMPAIGN_FILE = "campaign.json"
ITEMS_DIR = "items"
CAMPAIGNS_SUBDIR = "campaigns"   # under the store root, so `serve`
                                 # browses campaigns next to runs

# item states
PENDING = "pending"
RUNNING = "running"
DONE = "done"
FAILED = "failed"
PREEMPTED = "preempted"
CLAIMABLE = (PENDING, PREEMPTED)


class QueueError(ValueError):
    """A campaign dir that cannot be used as a queue."""


class Claim(NamedTuple):
    """One successfully claimed item: update it via
    :func:`finish_item` (which releases the lock)."""
    item: Dict[str, Any]
    path: str      # the item's JSON file
    lock: str      # the held lock file


def write_json_atomic(path: str, obj: Any) -> None:
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2, default=repr)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def submit_campaign(spec: Dict[str, Any], store_root: str) -> str:
    """Expand ``spec`` and create the campaign dir + item files under
    ``<store_root>/campaigns/``. Returns the campaign dir."""
    from datetime import datetime

    from .spec import expand_items
    items = expand_items(spec)
    ts = datetime.now().strftime("%Y%m%d-%H%M%S")
    name = str(spec.get("name") or "campaign")
    cdir = os.path.join(store_root, CAMPAIGNS_SUBDIR, f"{name}-{ts}")
    for attempt in range(2, 100):
        try:
            os.makedirs(os.path.join(cdir, ITEMS_DIR), exist_ok=False)
            break
        except FileExistsError:
            cdir = os.path.join(store_root, CAMPAIGNS_SUBDIR,
                                f"{name}-{ts}-{attempt}")
    write_json_atomic(os.path.join(cdir, CAMPAIGN_FILE),
                      {"name": name, "spec": spec,
                       "n-items": len(items),
                       "submitted": time.time()})
    for i, opts in enumerate(items):
        # scheduling-policy keys (`retries`/`backoff-s`, dash or
        # underscore) are queue metadata, not run opts: lift them off
        # the opts dict onto the item record so a FAILED (not invalid)
        # item re-queues up to N times with exponential backoff
        opts = dict(opts)
        retries = opts.pop("retries", 0)
        backoff = opts.pop("backoff_s", opts.pop("backoff-s", 30.0))
        write_json_atomic(
            item_path(cdir, i),
            {"id": i, "workload": opts["workload"], "opts": opts,
             "status": PENDING, "attempts": 0, "failures": 0,
             "retries": int(retries or 0),
             "backoff-s": float(backoff or 0.0),
             "run-dir": None, "updated": time.time()})
    return cdir


def item_path(cdir: str, item_id: int) -> str:
    return os.path.join(cdir, ITEMS_DIR, f"item-{item_id:04d}.json")


def load_campaign(cdir: str) -> Dict[str, Any]:
    p = os.path.join(cdir, CAMPAIGN_FILE)
    if not os.path.exists(p):
        raise QueueError(f"not a campaign dir (no {CAMPAIGN_FILE}): "
                         f"{cdir}")
    with open(p) as f:
        return json.load(f)


def list_items(cdir: str) -> List[Dict[str, Any]]:
    """All items in id order (unreadable/torn files surface as status
    ``"unreadable"`` rather than vanishing from the table)."""
    d = os.path.join(cdir, ITEMS_DIR)
    if not os.path.isdir(d):
        raise QueueError(f"not a campaign dir (no {ITEMS_DIR}/): {cdir}")
    out = []
    for name in sorted(os.listdir(d)):
        if not (name.startswith("item-") and name.endswith(".json")):
            continue
        p = os.path.join(d, name)
        try:
            with open(p) as f:
                item = json.load(f)
        except (OSError, json.JSONDecodeError):
            item = {"id": name, "status": "unreadable"}
        item["_path"] = p
        out.append(item)
    return out


def _worker_id() -> str:
    return f"{socket.gethostname()}:{os.getpid()}"


# lease duration written on every claim/renewal. Workers renew at
# TTL/3 (runner.LeaseKeeper), so a healthy worker's lease is always
# comfortably fresh and an expired lease means its holder is gone —
# on any host.
DEFAULT_LEASE_TTL = 300.0


def _lease_body(worker: str, ttl: float = DEFAULT_LEASE_TTL) -> dict:
    now = time.time()
    return {"pid": os.getpid(), "host": socket.gethostname(),
            "worker": worker, "claimed": now,
            "lease-expires": now + ttl}


def lease_is_ours(lock_path: str, worker: Optional[str] = None) -> bool:
    """Does ``lock_path`` still hold OUR live lease? False when the
    lock is gone, held by another worker (stolen and re-claimed), or
    our lease already expired (lost — a stealer may be mid-claim).
    The renewal path's terminal test, shared with
    ``runner.LeaseKeeper`` so a transient read error is
    distinguishable from a genuinely lost lease."""
    worker = worker or _worker_id()
    try:
        with open(lock_path) as f:
            info = json.load(f)
    except (OSError, json.JSONDecodeError):
        return False
    if info.get("worker") != worker:
        return False
    expires = info.get("lease-expires")
    return expires is None or time.time() <= float(expires)


def renew_lease(lock_path: str, worker: Optional[str] = None,
                ttl: float = DEFAULT_LEASE_TTL) -> bool:
    """Refresh a held lock's lease (write-temp-then-rename, so readers
    never see a torn lock). Returns False — and writes nothing — when
    the lease is no longer ours (:func:`lease_is_ours`: gone, stolen,
    or lapsed; a stealer may be mid-claim and our replace would
    clobber their O_EXCL lock — the renewer forfeits instead) or the
    write itself failed. With the forfeit checks, a steal can only
    happen to an expired or dead-pid lock, neither of which has a
    live renewer, so renewal and stealing never race on a healthy
    clock."""
    worker = worker or _worker_id()
    if not lease_is_ours(lock_path, worker):
        return False
    tmp = f"{lock_path}.renew-{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(_lease_body(worker, ttl), f)
        if not os.path.exists(lock_path):
            os.unlink(tmp)
            return False
        os.replace(tmp, lock_path)
        return True
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _lock_stale(lock_path: str) -> bool:
    """A lock is stale when its holder is provably or presumably gone:

    - same host: the pid probe is authoritative — a LIVE local pid is
      never stale (even with a lapsed lease: a stopped/swapping worker
      that missed renewals is still running the item), a dead one is
      stale immediately.
    - cross host (unprobeable): stale iff the lease EXPIRED, so a lost
      remote worker's items requeue without ``requeue_stale --force``.
      Pre-lease locks (no ``lease-expires``) keep the old rule: never
      auto-stale."""
    try:
        with open(lock_path) as f:
            info = json.load(f)
    except (OSError, json.JSONDecodeError):
        return False   # mid-write by a live claimer: not ours to steal
    if info.get("host") == socket.gethostname():
        try:
            os.kill(int(info.get("pid", -1)), 0)
            return False
        except (OSError, ValueError):
            return True
    expires = info.get("lease-expires")
    return expires is not None and time.time() > float(expires)


def _try_lock(lock_path: str) -> Optional[int]:
    """Atomically create the claim lock; None when already held."""
    try:
        return os.open(lock_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return None


def _steal_stale_lock(lock_path: str) -> bool:
    """Atomically retire a stale lock: rename it aside (only ONE
    stealer wins the rename), then the caller re-runs the normal
    O_EXCL claim."""
    retired = f"{lock_path}.stale-{os.getpid()}-{time.monotonic_ns()}"
    try:
        os.rename(lock_path, retired)
    except OSError:
        return False
    try:
        os.unlink(retired)
    except OSError:
        pass
    return True


def next_retry_eta(cdir: str) -> Optional[float]:
    """Earliest ``not-before`` among claimable items still inside a
    retry backoff window (None when no item is waiting on one) — the
    worker loop's cue to wait instead of declaring the queue drained."""
    eta: Optional[float] = None
    now = time.time()
    for item in list_items(cdir):
        nb = item.get("not-before")
        if item.get("status") in CLAIMABLE and nb is not None \
                and float(nb) > now:
            eta = float(nb) if eta is None else min(eta, float(nb))
    return eta


def claim_next(cdir: str,
               worker: Optional[str] = None) -> Optional[Claim]:
    """Claim the lowest-id claimable item, or ``None`` when the queue
    is drained. A ``running`` item whose lock is stale (its worker
    died) is first flipped to ``preempted`` — its next claimer resumes
    it from its checkpoint. Items inside a retry backoff window
    (``not-before`` in the future) are skipped until it elapses."""
    worker = worker or _worker_id()
    for item in list_items(cdir):
        path = item.get("_path")
        status = item.get("status")
        if not path or status in (DONE, FAILED, "unreadable"):
            continue
        nb = item.get("not-before")
        if status in CLAIMABLE and nb is not None \
                and float(nb) > time.time():
            continue     # retry backoff still running
        lock = path[:-len(".json")] + ".lock"
        if status == RUNNING:
            # a running item with a dead owner is preempted work
            if not (os.path.exists(lock) and _lock_stale(lock)):
                continue
            if not _steal_stale_lock(lock):
                continue   # another worker stole it first
        fd = _try_lock(lock)
        if fd is None:
            if _lock_stale(lock) and _steal_stale_lock(lock):
                fd = _try_lock(lock)
            if fd is None:
                continue
        try:
            os.write(fd, json.dumps(_lease_body(worker)).encode())
        finally:
            os.close(fd)
        # re-read under the lock: the item may have finished between
        # the listing and the claim
        try:
            with open(path) as f:
                item = json.load(f)
        except (OSError, json.JSONDecodeError):
            os.unlink(lock)
            continue
        if item.get("status") not in CLAIMABLE + (RUNNING,):
            os.unlink(lock)
            continue
        if item.get("status") == RUNNING:
            item["status"] = PREEMPTED   # recorded for the history
        prev_status = item["status"]
        item.update(status=RUNNING, attempts=item.get("attempts", 0) + 1,
                    **{"claimed-by": worker, "updated": time.time(),
                       "resumed-from-checkpoint": False,
                       "previous-status": prev_status})
        item.pop("_path", None)
        write_json_atomic(path, item)
        return Claim(item=item, path=path, lock=lock)
    return None


def finish_item(claim: Claim, status: str,
                **fields: Any) -> Dict[str, Any]:
    """Transition a claimed item to ``done``/``failed`` (or back to
    ``preempted`` on a handled interruption) and release the lock."""
    item = dict(claim.item)
    item.update(status=status, updated=time.time(), **fields)
    write_json_atomic(claim.path, item)
    try:
        os.unlink(claim.lock)
    except OSError:
        pass
    return item


def requeue_stale(cdir: str, force: bool = False) -> List[int]:
    """Flip dead-worker ``running`` items to ``preempted`` (claimable
    again). With lease-carrying locks this is automatic for ANY host:
    an expired lease is stale wherever its worker ran. ``force`` is
    the operator's lever for a remote worker KNOWN lost before its
    lease runs out: it additionally reclaims lock-LESS items and
    cross-host locks regardless of lease freshness. A live same-host
    lock is never stolen, force or not — its worker is demonstrably
    still running the item."""
    flipped = []
    for item in list_items(cdir):
        if item.get("status") != RUNNING:
            continue
        path = item["_path"]
        lock = path[:-len(".json")] + ".lock"
        if os.path.exists(lock):
            stale = _lock_stale(lock)
            if not stale and force:
                # cross-host locks can't be liveness-probed; --force is
                # the operator asserting the remote worker is lost, so
                # it overrides even an unexpired lease. Same-host live
                # pids always stay.
                try:
                    with open(lock) as f:
                        stale = (json.load(f).get("host")
                                 != socket.gethostname())
                except (OSError, json.JSONDecodeError):
                    stale = False
        else:
            stale = force   # running without a lock: crashed claimer
        if not stale:
            continue
        if os.path.exists(lock) and not _steal_stale_lock(lock):
            continue
        item = dict(item)
        item.pop("_path", None)
        item.update(status=PREEMPTED, updated=time.time())
        write_json_atomic(path, item)
        flipped.append(item.get("id"))
    return flipped
