"""ctypes binding of the native CPU simulation engine (``cpp/engine``).

A copy of ``maelstrom_tpu/native/engine.py``: the C++ scalar-loop
counterpart of the device runtime, for the host. It simulates the same
clusters (virtual clock, mailbox pool with exponential latency, loss
and halves partitions, Raft and the other families, per-tick
invariants, recorded histories), and is not bit-compatible with the
device runtime (splitmix64, not threefry). Histories come back in the
dict shape the workload checkers read, so a native run is judged by the
same checkers as a device run (WGL, Elle list-append and rw-register,
set-full, the counter interval, uniqueness, the kafka anomalies).

The build is the port's own, as ``checkers/native.py``'s: the first use
compiles ``cpp/engine/sim.cpp`` with ``$CXX`` (default ``g++``) and the
flags of ``cpp/engine/Makefile`` into
``<repo>/build/engine/libsim-<hash>.so``, the hash over the source, the
flags and ``$CXX --version``; a later use (or process) loads that file
without compiling. A build or load failure raises, naming the compiler,
the source or the symbol: the native runtime is never quietly turned
off. The engine's own refusal of a configuration (a nonzero return
code) is :func:`run_native_sim`'s ``None``, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from typing import Any, Dict, List, Optional

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "cpp", "engine", "sim.cpp")
BUILD_DIR = os.path.join(_REPO, "build", "engine")
# cpp/engine/Makefile's CXXFLAGS and link flags: both packages load
# the same program
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-Wall", "-Wextra",
             "-pthread", "-shared", "-fPIC")

_lib = None

NIL = -1
EV_INVOKE, EV_OK, EV_FAIL, EV_INFO = 1, 2, 3, 4
F_NAMES = {1: "read", 2: "write", 3: "cas"}
ETYPE_NAMES = {EV_OK: "ok", EV_FAIL: "fail", EV_INFO: "info"}

# which workloads the engine speaks (name -> cfg.workload enum); the
# CLI and the harness derive from it
NATIVE_WORKLOADS = {"lin-kv": 0, "txn-list-append": 1, "g-set": 2,
                    "broadcast": 3, "unique-ids": 4, "pn-counter": 5,
                    "g-counter": 6, "txn-rw-register": 7,
                    "echo": 8, "kafka": 9}

# the exported symbols and their signatures
_SIGNATURES = {
    "native_sim_run_sched": (ctypes.c_int64, [
        ctypes.POINTER(ctypes.c_int64),   # cfg
        ctypes.POINTER(ctypes.c_int64),   # stats[5]
        ctypes.POINTER(ctypes.c_int32),   # violations[I]
        ctypes.POINTER(ctypes.c_int32),   # events[R*max_events*ev_w]
        ctypes.POINTER(ctypes.c_int64),   # n_events[R]
        ctypes.POINTER(ctypes.c_int64),   # sched[n_phases*2]
        ctypes.c_int64]),                 # n_phases
    # the width class of a family's Msg row: the bench lines and LNE610
    "native_msg_lanes": (ctypes.c_int64, [ctypes.c_int64, ctypes.c_int64]),
    "native_msg_row_bytes": (ctypes.c_int64,
                             [ctypes.c_int64, ctypes.c_int64]),
}


def _compiler(cxx=None):
    """``(name, path)`` of the C++ compiler (``$CXX``, else ``g++``);
    raises when it is not found."""
    cxx = cxx or os.environ.get("CXX") or "g++"
    exe = shutil.which(cxx)
    if exe is None:
        raise RuntimeError(
            f"the native engine needs a C++ compiler to build {SOURCE}; "
            f"{cxx!r} was not found (set CXX to one)")
    return cxx, exe


def library_path(build_dir: str = BUILD_DIR, cxx=None) -> str:
    """The hashed library's path: the source, the flags and the
    compiler's ``--version`` name it."""
    _, exe = _compiler(cxx)
    if not os.path.exists(SOURCE):
        raise RuntimeError(f"the native engine's source {SOURCE} is "
                           f"missing")
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    version = subprocess.run([exe, "--version"], capture_output=True,
                             text=True)
    h.update(version.stdout.encode())
    return os.path.join(build_dir, f"libsim-{h.hexdigest()[:12]}.so")


def build_library(build_dir: str = BUILD_DIR, cxx=None) -> str:
    """Compile ``cpp/engine/sim.cpp`` into ``build_dir`` unless it is
    built already; the library's path. Raises when the compiler or the
    source is missing, or the compiler fails."""
    out = library_path(build_dir, cxx)
    if os.path.exists(out):
        return out
    name, exe = _compiler(cxx)
    os.makedirs(build_dir, exist_ok=True)
    # one build at a time: the others wait for its library
    with open(os.path.join(build_dir, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):
            return out
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run([exe, *CXX_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{name} failed to build {SOURCE}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def _load():
    """The loaded engine, built on first use."""
    global _lib
    if _lib is None:
        path = build_library()
        lib = ctypes.CDLL(path)
        for sym, (restype, argtypes) in _SIGNATURES.items():
            try:
                fn = getattr(lib, sym)
            except AttributeError:
                raise RuntimeError(f"{path} has no symbol {sym}") from None
            fn.restype, fn.argtypes = restype, argtypes
        _lib = lib
    return _lib


def native_available() -> bool:
    """True once the engine has loaded (it is built on the first call);
    a build or load failure raises instead of answering False."""
    return _load() is not None


def native_msg_lanes(workload: str, wide: bool = False) -> int:
    """Compiled body-lane width class of ``workload``'s Msg row."""
    return int(_load().native_msg_lanes(NATIVE_WORKLOADS[workload],
                                        1 if wide else 0))


def native_msg_row_bytes(workload: str, wide: bool = False) -> int:
    """Compiled ``sizeof`` of one Msg row of ``workload``'s width
    class."""
    return int(_load().native_msg_row_bytes(NATIVE_WORKLOADS[workload],
                                            1 if wide else 0))


def _decode_txn_history(ev: np.ndarray, ms_per_tick: float,
                        final_start: int, txn_max: int,
                        list_cap: int) -> List[dict]:
    """txn rows [n, 4 + 3*txn_max + txn_max*list_cap] -> Elle's
    micro-op history: value = [[f, k, v], ...] with f in
    {"append", "r"}; ok reads carry their lists, invoke reads None."""
    hist: List[dict] = []
    base = 4 + 3 * txn_max
    for row in ev:
        tick, client, etype, ln = (int(row[0]), int(row[1]),
                                   int(row[2]), int(row[3]))
        ops: List[Any] = []
        for j in range(min(ln, txn_max)):
            f, k, v = (int(row[4 + 3 * j]), int(row[5 + 3 * j]),
                       int(row[6 + 3 * j]))
            if f == 1:      # read
                if etype == EV_OK:
                    rlen = min(v, list_cap)
                    vals = [int(x) for x in
                            row[base + j * list_cap:
                                base + j * list_cap + rlen]]
                    ops.append(["r", k, vals])
                else:
                    ops.append(["r", k, None])
            else:           # append
                ops.append(["append", k, int(v)])
        rec = {"process": client,
               "type": ("invoke" if etype == EV_INVOKE
                        else ETYPE_NAMES[etype]),
               "f": "txn", "value": ops}
        if etype == EV_INVOKE and tick >= final_start:
            rec["final"] = True
        rec["time"] = int(tick * ms_per_tick * 1_000_000)
        rec["index"] = len(hist)
        hist.append(rec)
    return hist


def _decode_rw_history(ev: np.ndarray, ms_per_tick: float,
                       final_start: int, txn_max: int) -> List[dict]:
    """txn-rw-register rows [n, 4 + 3*txn_max] -> Elle's micro-op
    history: value = [[f, k, v], ...] with f in {"w", "r"}; ok reads
    carry the observed value (NIL -> None), invoke reads None."""
    hist: List[dict] = []
    for row in ev:
        tick, client, etype, ln = (int(row[0]), int(row[1]),
                                   int(row[2]), int(row[3]))
        ops: List[Any] = []
        for j in range(min(ln, txn_max)):
            f, k, v = (int(row[4 + 3 * j]), int(row[5 + 3 * j]),
                       int(row[6 + 3 * j]))
            if f == 1:      # read
                seen = (None if (etype != EV_OK or v == NIL) else v)
                ops.append(["r", k, seen])
            else:           # write
                ops.append(["w", k, v])
        rec = {"process": client,
               "type": ("invoke" if etype == EV_INVOKE
                        else ETYPE_NAMES[etype]),
               "f": "txn", "value": ops}
        if etype == EV_INVOKE and tick >= final_start:
            rec["final"] = True
        rec["time"] = int(tick * ms_per_tick * 1_000_000)
        rec["index"] = len(hist)
        hist.append(rec)
    return hist


def _decode_kafka_history(ev: np.ndarray, ms_per_tick: float,
                          final_start: int) -> List[dict]:
    """kafka rows -> the kafka checker's shapes (checkers/kafka.py):
    send [k, v] / [k, v, offset]; poll ok = {key: [[off, v], ...]}
    reassembled from header + triple rows; commit_offsets ok =
    {key: off} from header + pair rows."""
    F = {1: "send", 2: "poll", 3: "commit_offsets",
         4: "list_committed_offsets", 5: "crash", 6: "txn"}
    hist: List[dict] = []
    i = 0
    while i < len(ev):
        row = ev[i]
        tick, client, etype, f = (int(row[0]), int(row[1]),
                                  int(row[2]), int(row[3]))
        if etype not in ETYPE_NAMES and etype != EV_INVOKE:
            break   # recorder saturation padding
        fname = F.get(f)
        if fname is None:
            break
        value: Any
        reassigned = False
        if fname == "crash":
            value = None
            i += 1
        elif fname == "txn":
            n_mops = int(row[4])
            if etype == EV_INVOKE:
                reassigned = bool(int(row[5]))
            mops: List[Any] = []
            j = i + 1
            if etype == EV_OK:
                for _ in range(n_mops):
                    r2 = ev[j]
                    if int(r2[0]) == 1:
                        mops.append(["send", int(r2[1]),
                                     [int(r2[3]), int(r2[2])]])
                        j += 1
                    else:
                        n_tr = int(r2[1])
                        msgs: Dict[int, list] = {}
                        for r3 in ev[j + 1:j + 1 + n_tr]:
                            msgs.setdefault(int(r3[0]), []).append(
                                [int(r3[1]), int(r3[2])])
                        mops.append(["poll", msgs])
                        j += 1 + n_tr
            else:
                for r2 in ev[i + 1:i + 1 + n_mops]:
                    if int(r2[0]) == 1:
                        mops.append(["send", int(r2[1]), int(r2[2])])
                    else:
                        mops.append(["poll", None])
                j = i + 1 + n_mops
            value = mops
            i = j
        elif fname == "send":
            k, v, off = int(row[4]), int(row[5]), int(row[6])
            value = [k, v, off] if (etype == EV_OK) else [k, v]
            i += 1
        elif fname == "poll" and etype == EV_INVOKE:
            value = None
            reassigned = bool(int(row[4]))
            i += 1
        elif etype == EV_OK and fname == "poll":
            n = int(row[4])
            msgs: Dict[int, list] = {}
            for r2 in ev[i + 1:i + 1 + n]:
                msgs.setdefault(int(r2[0]), []).append(
                    [int(r2[1]), int(r2[2])])
            value = msgs
            i += 1 + n
        elif etype == EV_OK and fname in ("commit_offsets",
                                          "list_committed_offsets"):
            n = int(row[4])
            value = {int(r2[0]): int(r2[1])
                     for r2 in ev[i + 1:i + 1 + n] if int(r2[1]) >= 0}
            i += 1 + n
        else:
            value = None
            i += 1
        rec = {"process": client,
               "type": ("invoke" if etype == EV_INVOKE
                        else ETYPE_NAMES[etype]),
               "f": fname, "value": value}
        if reassigned:
            rec["reassigned"] = True
        if etype == EV_INVOKE and tick >= final_start:
            rec["final"] = True
        rec["time"] = int(tick * ms_per_tick * 1_000_000)
        rec["index"] = len(hist)
        hist.append(rec)
    return hist


def _decode_echo_history(ev: np.ndarray, ms_per_tick: float,
                         final_start: int) -> List[dict]:
    """echo rows -> the echo checker's shape (workloads/echo.py:32-38).
    Invoke rows are [t, c, 1, 1, 0, payload, 0]; completion rows are
    [t, c, etype, 1, sent, received, 0] — ok records carry the
    response as value and the request under "echo"."""
    hist: List[dict] = []
    for row in ev:
        tick, client, etype = int(row[0]), int(row[1]), int(row[2])
        if etype == EV_INVOKE:
            rec = {"process": client, "type": "invoke", "f": "echo",
                   "value": int(row[5])}   # the sent payload
        else:
            rec = {"process": client, "type": ETYPE_NAMES[etype],
                   "f": "echo", "value": int(row[5]),
                   "echo": int(row[4])}
        if etype == EV_INVOKE and tick >= final_start:
            rec["final"] = True
        rec["time"] = int(tick * ms_per_tick * 1_000_000)
        rec["index"] = len(hist)
        hist.append(rec)
    return hist


def _decode_gset_history(ev: np.ndarray, ms_per_tick: float,
                         final_start: int,
                         add_name: str = "add") -> List[dict]:
    """g-set/broadcast rows -> set-full's history: add ops carry their
    element (f name "add" or "broadcast" per workload); read-ok rows
    are a header [.., n, ..] followed by ceil(n/7) rows of 7 raw
    values (record_gset_read's layout)."""
    hist: List[dict] = []
    i = 0
    while i < len(ev):
        tick, client, etype, f = (int(ev[i][0]), int(ev[i][1]),
                                  int(ev[i][2]), int(ev[i][3]))
        if etype not in ETYPE_NAMES and etype != EV_INVOKE:
            # a saturated recorder (record_gset_read) jumps its count
            # to cap without writing — the remaining rows are zero
            # padding; the events-truncated flag reports it upstream
            break
        fname = add_name if f == 1 else "read"
        if fname == "read" and etype == EV_OK:
            n = int(ev[i][4])
            rows = (n + 6) // 7
            vals = [int(v) for row in ev[i + 1:i + 1 + rows]
                    for v in row][:n]
            i += 1 + rows
            value: Any = vals
        else:
            value = int(ev[i][5]) if fname == add_name else None
            if fname == add_name and value == NIL:
                value = None
            i += 1
        rec = {"process": client,
               "type": ("invoke" if etype == EV_INVOKE
                        else ETYPE_NAMES[etype]),
               "f": fname, "value": value}
        if etype == EV_INVOKE and tick >= final_start:
            rec["final"] = True
        rec["time"] = int(tick * ms_per_tick * 1_000_000)
        rec["index"] = len(hist)
        hist.append(rec)
    return hist


def _decode_value_history(ev: np.ndarray, ms_per_tick: float,
                          final_start: int, f_names) -> List[dict]:
    """Single-value rows [n, 7] for the unique-ids / pn-counter /
    g-counter families: invoke values are None for reads/generates and
    the (possibly negative) delta for adds; completions carry the id /
    total / echoed delta in the value lane."""
    hist: List[dict] = []
    for row in ev:
        tick, client, etype, f, v = (int(row[0]), int(row[1]),
                                     int(row[2]), int(row[3]),
                                     int(row[5]))
        fname = f_names[f]
        if etype == EV_INVOKE:
            value = v if fname == "add" else None
        else:
            value = v
        rec = {"process": client,
               "type": ("invoke" if etype == EV_INVOKE
                        else ETYPE_NAMES[etype]),
               "f": fname, "value": value}
        if etype == EV_INVOKE and tick >= final_start:
            rec["final"] = True
        rec["time"] = int(tick * ms_per_tick * 1_000_000)
        rec["index"] = len(hist)
        hist.append(rec)
    return hist


def _decode_history(ev: np.ndarray, ms_per_tick: float,
                    final_start: int) -> List[dict]:
    """events [n, 7] (tick, client, etype, f, k, v, b) -> the checker's
    op-dict history (harness.events_to_histories's output shape)."""
    hist: List[dict] = []
    for tick, client, etype, f, k, v, b in ev:
        fname = F_NAMES.get(int(f), "?")
        if etype == EV_INVOKE:
            if fname == "read":
                value: Any = [int(k), None]
            elif fname == "write":
                value = [int(k), int(v)]
            else:
                value = [int(k), [int(v), int(b)]]
            rec = {"process": int(client), "type": "invoke", "f": fname,
                   "value": value}
            if tick >= final_start:
                rec["final"] = True
        else:
            if fname == "read":
                value = [int(k), None if v == NIL else int(v)]
            elif fname == "write":
                value = [int(k), int(v)]
            else:
                value = [int(k), [int(v), int(b)]]
            rec = {"process": int(client),
                   "type": ETYPE_NAMES[int(etype)],
                   "f": fname, "value": value}
        rec["time"] = int(int(tick) * ms_per_tick * 1_000_000)
        rec["index"] = len(hist)
        hist.append(rec)
    return hist


def run_native_sim(opts: Optional[Dict[str, Any]] = None
                   ) -> Optional[Dict[str, Any]]:
    """Run the flagship Raft config on the native engine.

    ``opts`` uses the TPU harness's option vocabulary (node_count,
    concurrency, n_instances, time_limit, rate, latency, rpc_timeout,
    nemesis, nemesis_interval, p_loss, recovery_time, record_instances,
    seed, + mutant flags stale_read/eager_commit/no_term_guard).
    Returns None when the engine refuses the configuration (a nonzero
    return code); the library is built on first use.
    """
    lib = _load()
    o = dict(
        node_count=3, concurrency=6, n_instances=4096,
        record_instances=8, pool_slots=16, inbox_k=1,
        time_limit=4.0, rate=200.0, latency=5.0, rpc_timeout=1.0,
        nemesis=["partition"], nemesis_interval=0.4, p_loss=0.05,
        recovery_time=0.3, heartbeat=8, log_cap=64,
        elect_min=30, elect_jitter=30, n_keys=5, n_vals=5,
        ms_per_tick=1, seed=7,
        stale_read=False, eager_commit=False, no_term_guard=False,
        # txn-list-append workload (cpp/engine txn mode — the native
        # twin of models/txn_raft.py)
        workload="lin-kv", txn_max=3, list_cap=16, read_prob=0.5,
        txn_dirty_apply=False, gset_no_gossip=False, topology="grid",
        crash_clients=False, txn=False,
        # wide=True forces the pre-specialization worst-case Msg/Entry
        # width (W_TXN) whatever the workload — the narrow-vs-wide A/B
        # knob (bench.py BENCH_WIDE=1); trajectories are identical
        wide=False,
        # instances are independent, so worker threads each own a
        # contiguous block end-to-end; per-instance trajectories are
        # identical at ANY thread count (RNG is a pure function of
        # seed + instance id) — pinned by
        # test_native_thread_count_invariance
        threads=0,   # 0 = all cores
    )
    o.update(opts or {})
    if o["workload"] in ("g-set", "broadcast", "pn-counter",
                         "g-counter"):
        # flooding/gossip volume dwarfs the Raft flagship's — the
        # 16-slot headline pool overflows into wedged clients (request
        # or reply eaten -> 1000-tick timeout); size like the device
        # runtime's gossip defaults instead unless the caller chose
        if "pool_slots" not in (opts or {}):
            o["pool_slots"] = 48
        if "inbox_k" not in (opts or {}):
            o["inbox_k"] = 4
    if o["workload"] not in ("lin-kv", "txn-list-append",
                             "txn-rw-register") \
            and "rpc_timeout" not in (opts or {}):
        # non-Raft ops complete in ~2 ticks; the Raft-sized 1s timeout
        # wedges a client for half a short horizon when loss eats a
        # reply, starving the final reads the checkers judge by
        o["rpc_timeout"] = 0.25
    mpt = o["ms_per_tick"]
    n_ticks = int(o["time_limit"] * 1000 / mpt)
    recovery_ticks = min(int(o["recovery_time"] * 1000 / mpt),
                         n_ticks // 2)
    stop_tick = n_ticks - recovery_ticks
    final_start = stop_tick + recovery_ticks // 2
    I = int(o["n_instances"])
    R = min(int(o["record_instances"]), I)
    C = int(o["concurrency"])
    rate = min(1.0, float(o["rate"]) / C / 1000.0 * mpt)
    max_events = max(64, 2 * C * n_ticks // 4)

    if o["workload"] not in NATIVE_WORKLOADS:
        raise ValueError(f"unknown native workload {o['workload']!r} "
                         f"(expected one of {sorted(NATIVE_WORKLOADS)})")
    workload = NATIVE_WORKLOADS[o["workload"]]
    _topologies = {"total": 0, "line": 1, "grid": 2, "tree2": 3,
                   "tree3": 4, "tree4": 5,
                   "tree": 3}   # alias, matching workloads/topology.py
    if workload != 3:
        o["topology"] = "total"   # only broadcast consults it
    elif o["topology"] not in _topologies:
        raise ValueError(f"unknown native topology {o['topology']!r} "
                         f"(expected one of {sorted(_topologies)})")
    txn_max, list_cap = int(o["txn_max"]), int(o["list_cap"])
    ev_w = (4 + 3 * txn_max + txn_max * list_cap if workload == 1
            else 4 + 3 * txn_max if workload == 7 else 7)
    if workload in (2, 3):
        # g-set/broadcast reads stream their whole set as 7-value
        # rows, so the event budget scales with ops^2/7 in the worst
        # case; ops per client are rate-bounded by the horizon
        max_events = max(256, 2 * C * n_ticks)
    elif workload == 9:
        # kafka polls/commits emit header + up to
        # n_keys*KPOLL_MAX / n_keys rows per op — amplify the
        # one-row-per-event base budget accordingly
        max_events = max(256, C * n_ticks * 4)

    threads = int(o["threads"]) or (os.cpu_count() or 1)
    cfg = (ctypes.c_int64 * 38)(
        int(o["seed"]), I, n_ticks, int(o["node_count"]), C, R,
        int(o["pool_slots"]), int(o["inbox_k"]),
        int(float(o["latency"]) / mpt * 1000),
        int(float(o["p_loss"]) * 1e6),
        int(rate * 1e6),
        int(o["rpc_timeout"] * 1000 / mpt),
        1 if "partition" in (o["nemesis"] or []) else 0,
        max(1, int(o["nemesis_interval"] * 1000 / mpt)),
        stop_tick, final_start,
        int(o["heartbeat"]), int(o["log_cap"]),
        int(o["elect_min"]), int(o["elect_jitter"]),
        int(o["n_keys"]), int(o["n_vals"]),
        1 if o["stale_read"] else 0,
        1 if o["eager_commit"] else 0,
        1 if o["no_term_guard"] else 0,
        max_events, threads, int(o.get("instance_base", 0)),
        workload, txn_max, list_cap,
        int(float(o["read_prob"]) * 1e6),
        1 if o["txn_dirty_apply"] else 0,
        1 if o["gset_no_gossip"] else 0,
        _topologies[o["topology"]],
        1 if o["crash_clients"] else 0,
        1 if o["txn"] else 0,
        1 if o["wide"] else 0)

    stats = (ctypes.c_int64 * 5)()
    violations = np.zeros(I, dtype=np.int32)
    events = np.zeros((R, max_events, ev_w), dtype=np.int32)
    n_events = np.zeros(R, dtype=np.int64)

    # scripted nemesis: ((until_tick, ((dst, src), ...)), ...) — the
    # device runtime's NemesisConfig.schedule shape — flattened to
    # (until, blocked-bitmask) int64 pairs (needs n_nodes <= 8)
    schedule = o.get("nemesis_schedule") or ()
    n_phases = len(schedule)
    flat = (ctypes.c_int64 * max(1, n_phases * 2))()
    if n_phases:
        N = int(o["node_count"])
        if N > 8:
            raise ValueError(
                "the native engine's scripted nemesis supports at most "
                "8 nodes (bitmask phases); use --runtime tpu")
        # a schedule implies the partition nemesis — silently running
        # healed would be a lie (same guard as the CLI's TPU path)
        cfg[12] = 1
        for i, (until, pairs) in enumerate(
                sorted(schedule, key=lambda p: p[0])):
            mask = 0
            for dst, src in pairs:
                mask |= 1 << (int(dst) * N + int(src))
            flat[i * 2] = int(until)
            flat[i * 2 + 1] = mask

    t0 = time.monotonic()
    rc = lib.native_sim_run_sched(
        cfg, stats,
        violations.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        events.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_events.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        flat, n_phases)
    wall = time.monotonic() - t0
    if rc != 0:
        return None

    if workload == 1:
        histories = [
            _decode_txn_history(events[i, :n_events[i]], mpt,
                                final_start, txn_max, list_cap)
            for i in range(R)]
    elif workload in (2, 3):
        add_name = "add" if workload == 2 else "broadcast"
        histories = [
            _decode_gset_history(events[i, :n_events[i]], mpt,
                                 final_start, add_name=add_name)
            for i in range(R)]
    elif workload == 7:
        histories = [
            _decode_rw_history(events[i, :n_events[i]], mpt,
                               final_start, txn_max)
            for i in range(R)]
    elif workload == 9:
        histories = [
            _decode_kafka_history(events[i, :n_events[i]], mpt,
                                  final_start)
            for i in range(R)]
    elif workload == 8:
        histories = [
            _decode_echo_history(events[i, :n_events[i]], mpt,
                                 final_start)
            for i in range(R)]
    elif workload in (4, 5, 6):
        f_names = ({1: "generate"} if workload == 4
                   else {1: "add", 2: "read"})
        histories = [
            _decode_value_history(events[i, :n_events[i]], mpt,
                                  final_start, f_names)
            for i in range(R)]
    else:
        histories = [
            _decode_history(events[i, :n_events[i]], mpt, final_start)
            for i in range(R)]
    truncated_per_instance = [bool(n_events[i] >= max_events)
                              for i in range(R)]
    return {
        "engine": "native-cpp",
        "truncated-per-instance": truncated_per_instance,
        "stats": {
            "sent": int(stats[0]), "delivered": int(stats[1]),
            "dropped-partition": int(stats[2]),
            "dropped-loss": int(stats[3]),
            "dropped-overflow": int(stats[4]),
        },
        "violations": violations,
        "violating-instances": int((violations > 0).sum()),
        "histories": histories,
        "events-truncated": bool((n_events >= max_events).any()),
        "perf": {
            "wall-s": wall,
            "ticks": n_ticks,
            "instances": I,
            "threads": threads,
            "msgs-per-sec": int(stats[1]) / wall if wall > 0 else 0.0,
            # per-family width-class facts of THIS run's instantiation
            "msg-lanes": int(lib.native_msg_lanes(
                workload, 1 if o["wide"] else 0)),
            "bytes-per-msg-row": int(lib.native_msg_row_bytes(
                workload, 1 if o["wide"] else 0)),
            "wide": bool(o["wide"]),
        },
    }


def replay_native_instances(opts: Dict[str, Any], instance_ids
                            ) -> Dict[str, Dict[int, Any]]:
    """The native funnel: re-simulate exactly the given GLOBAL instance
    ids of a big run (same seed/config) with recording on, one
    single-instance run per id — bit-exact because per-instance RNG
    keys on the global id (``instance_base``). Returns
    ``{"histories": {id: history}, "violations": {id: tick-count},
    "truncated": {id: bool}}``; a violating id must re-trip in its
    replay (the caller's self-check that the replay really was
    bit-exact). ``instance_ids`` are GLOBAL ids — if the batch itself
    ran at a nonzero ``instance_base``, the caller must pass
    base-offset ids."""
    histories: Dict[int, Any] = {}
    violations: Dict[int, int] = {}
    truncated: Dict[int, bool] = {}
    for iid in instance_ids:
        res = run_native_sim(dict(opts, n_instances=1,
                                  record_instances=1, threads=1,
                                  instance_base=int(iid)))
        if res is None:
            break
        histories[int(iid)] = res["histories"][0]
        violations[int(iid)] = int(res["violations"][0])
        truncated[int(iid)] = bool(res.get("events-truncated"))
    return {"histories": histories, "violations": violations,
            "truncated": truncated}
