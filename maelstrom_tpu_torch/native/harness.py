"""Harness around the native CPU engine: configure, run, check and
aggregate, ``run_torch_test``'s contract for the C++ engine, so ``test
--runtime native`` gives the results shape, checker verdicts and store
files of a device run.

A copy of ``maelstrom_tpu/native/harness.py`` over the port's checkers
and store (``harness.prepare_store_dir`` and ``harness.write_store``,
the run written under ``<store_root>/<workload>-native/``, as the JAX
harness's ``_write_store(..., suffix="-native")``)."""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from .engine import native_available, run_native_sim


def _checker_for(workload: str, consistency_model: str = None):
    """Full-history checker per native workload: WGL linearizability
    for lin-kv, Elle for txn-list-append at the requested consistency
    model (default strict-serializable — the reference's per-workload
    checker split, txn_list_append.clj)."""
    if workload == "txn-list-append":
        from ..checkers.elle import check_list_append
        model = consistency_model or "strict-serializable"
        return lambda h: check_list_append(h, consistency_model=model)
    if workload == "txn-rw-register":
        from ..checkers.elle import check_rw_register
        model = consistency_model or "strict-serializable"
        return lambda h: check_rw_register(h, consistency_model=model)
    if workload == "kafka":
        from ..checkers.kafka import kafka_checker
        return kafka_checker
    if workload == "echo":
        from ..checkers.echo import echo_checker
        return lambda h: echo_checker(h, {})
    if workload == "g-set":
        from ..checkers.set_full import set_full_checker
        return set_full_checker
    if workload == "broadcast":
        from ..checkers.set_full import set_full_checker
        return lambda h: set_full_checker(h, add_f="broadcast")
    if workload == "unique-ids":
        from ..checkers.unique_ids import unique_ids_checker
        return unique_ids_checker
    if workload in ("pn-counter", "g-counter"):
        from ..checkers.pn_counter import pn_counter_checker
        return pn_counter_checker
    if workload != "lin-kv":
        from .engine import NATIVE_WORKLOADS
        raise ValueError(f"unknown native workload {workload!r} "
                         f"(expected one of "
                         f"{sorted(NATIVE_WORKLOADS)})")
    from ..checkers.linearizable import linearizable_kv_checker
    return linearizable_kv_checker


def run_native_test(opts: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
    opts = dict(opts or {})
    native_available()   # builds the engine, or raises by name
    t0 = time.monotonic()
    res = run_native_sim(opts)
    wall = time.monotonic() - t0
    if res is None:
        raise ValueError(
            "the native engine rejected this configuration (limits: "
            "<=30 nodes, <=64 pool slots, <=64 endpoints)")

    from ..checkers import compose_valid
    from ..checkers.pool import (check_native_histories,
                                 resolve_check_workers)

    workload = opts.get("workload", "lin-kv")
    consistency = opts.get("consistency_models")
    checker = _checker_for(workload, consistency)
    # the per-instance verdict loop rides the checker farm: the
    # engine's decoded histories feed workers verbatim, assembly is
    # instance-ordered, and a broken pool falls back serial — verdicts
    # (including the error shape) are byte-identical either way
    check_workers = resolve_check_workers(opts.get("check_workers"),
                                          len(res["histories"]))
    t_chk = time.monotonic()
    per_instance = check_native_histories(
        workload, res["histories"], consistency=consistency,
        workers=check_workers)
    check_s = time.monotonic() - t_chk
    for i, v in enumerate(per_instance):
        v["instance"] = i
    n_violating = res["violating-instances"]
    overall = compose_valid(r.get("valid?", True) for r in per_instance)
    if n_violating > 0:
        overall = False
    import numpy as np
    violating_ids = np.nonzero(res["violations"])[0]

    results = {
        "valid?": overall,
        "engine": "native-cpp",
        "invariants": {
            "violating-instances": n_violating,
            "violating-instance-ids": violating_ids[:1024].tolist(),
            "total-violation-ticks": int(res["violations"].sum()),
        },
        "instance-count": int(opts.get("n_instances", 4096)),
        "checked-instances": len(per_instance),
        "valid-instances": sum(1 for r in per_instance
                               if r.get("valid?") in (True, "unknown")),
        "instances": [r if r.get("valid?") is not True or i < 32
                      else {"instance": i, "valid?": True}
                      for i, r in enumerate(per_instance)],
        "net": res["stats"],
        "perf": {**res["perf"], "harness-wall-s": wall,
                 "check": {"workers": check_workers,
                           "check-s": round(check_s, 4)}},
    }
    if res.get("events-truncated"):
        results["events-truncated"] = True
        results["valid?"] = "unknown" if overall is True else overall
    # the invariant-trip funnel, same contract as the device harness: every
    # tripped instance — wherever it sits in the fleet — yields a
    # checkable history + full-checker verdict via bit-exact replay
    funnel_hists = None
    if opts.get("funnel", True) and len(violating_ids) > 0:
        from .engine import replay_native_instances
        funnel_max = int(opts.get("funnel_max", 32))
        base = int(opts.get("instance_base", 0))
        R = len(res["histories"])
        local_ids = [int(i) for i in violating_ids[:funnel_max]]
        # ids already recorded by the batch need no re-simulation —
        # their histories (and checker verdicts) exist; only replay the
        # ones outside the recorded window, at their GLOBAL ids
        replay_local = [i for i in local_ids if i >= R]
        rep = replay_native_instances(
            opts, [base + i for i in replay_local])
        funnel_hists = {}
        verdicts = []
        replayed_violating = 0
        per_trunc = res.get("truncated-per-instance") or []
        for i in local_ids:
            if i < R:
                h = res["histories"][i]
                trunc = bool(per_trunc[i]) if i < len(per_trunc) else \
                    bool(res.get("events-truncated"))
                replayed_violating += 1   # recorded live, trivially so
            else:
                h = rep["histories"].get(base + i)
                if h is None:
                    continue
                trunc = rep["truncated"].get(base + i, False)
                if rep["violations"].get(base + i, 0) > 0:
                    replayed_violating += 1
            funnel_hists[base + i] = h
            try:
                v = checker(h)
            except Exception as e:
                v = {"valid?": False, "error": repr(e)}
            if trunc and v.get("valid?") is True:
                # a truncated history can't prove validity
                v["valid?"] = "unknown"
                v["events-truncated"] = True
            v["instance"] = base + i
            v["ops"] = sum(1 for r in h if r["type"] == "invoke")
            verdicts.append(v)
        results["funnel"] = {
            "ids": [base + i for i in local_ids],
            "replayed-violating": replayed_violating,
            "verdicts": verdicts,
        }
    if opts.get("store_root"):
        from ..harness import prepare_store_dir, write_store
        d = prepare_store_dir(opts.get("workload", "lin-kv"),
                              opts["store_root"], suffix="-native")
        write_store(d, results, res["histories"],
                    funnel={"histories": funnel_hists}
                    if funnel_hists else None)
        results["store-dir"] = d
    return results
