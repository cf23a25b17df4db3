"""The checker farm: per-instance verdicts in worker processes, streamed.

A copy of ``maelstrom_tpu/checkers/pool.py`` pointed at the port's
modules. The host verdict stage — decode the recorded instances' events,
run the workload checker on each history — fans out over a pool of
worker processes:

- the pool is spawned once per run (:class:`CheckerPool`); each worker
  rebuilds the run's model from its registry name and recorded scalar
  knobs (:func:`pool_spec`, :func:`_rebuild_model`) and builds the
  checker itself, so nothing unpicklable crosses the process boundary;
- instance ``i`` belongs to worker ``i % workers``; per-instance column
  slabs (``decode.py``) stream to their owner as the chunked executor
  fetches each chunk, so decoding and checking overlap the card's work;
- workers build the dict records with the same
  ``decode.materialize_records`` the in-process path uses and check at
  the end — or chunk by chunk, for checkers in ``INCREMENTAL_CHECKERS``;
- verdicts are assembled in instance order, so pooled verdicts equal
  the serial path's byte for byte; ``check_workers=0`` is the serial
  path, and any pool failure (a dead worker, a timeout) falls back to
  it: a broken pool changes the time taken, never a verdict;
- the native engine's histories arrive decoded and go to the workers
  as they are (:meth:`CheckerPool.feed_records`,
  :func:`check_native_histories`).

Workers never touch CUDA: they fork from a forkserver whose preload is
this module (no CUDA state), hide the cards from themselves, and only
run host checkers.

:class:`VerdictPipeline` is the harness's bundle: the streaming
decoder, the pool, the serial fallback, the device-verdict routing and
the ``perf.phases.check`` record.
"""

from __future__ import annotations

import os
import time
import traceback
from typing import Any, Dict, List, Optional

from . import checker_failure

# worker -> parent message tags
_READY, _DONE, _FAILED = "ready", "done", "error"


def resolve_check_workers(value, n_check: int) -> int:
    """The ``check_workers`` option: an int wins (0 = serial); None or
    "auto" takes a pool only with enough per-instance work to pay for
    it (>= 16 recorded instances) and cores to spread it over."""
    if value is not None and value != "auto":
        return max(0, int(value))
    cpus = os.cpu_count() or 1
    if cpus < 2 or n_check < 16:
        return 0
    return min(4, cpus)


def checker_name(model) -> str:
    """The name of a model's workload checker (what a blow-up report
    names)."""
    return getattr(model, "checker_name", None) or f"{model.name}-checker"


def pool_spec(model, opts: Dict[str, Any], final_start: int,
              ms_per_tick: float) -> Dict[str, Any]:
    """What a worker needs to rebuild the model and its checker: the
    registry name, the scalar model knobs (log_cap, n_keys, mutant
    flags), and the checker's options (the picklable ones)."""
    import pickle
    clean_opts = {}
    for k, v in opts.items():
        try:
            pickle.dumps(v)
        except Exception:
            continue
        clean_opts[k] = v
    return {
        "workload": model.name,
        "node-count": int(opts.get("node_count", 1)),
        "topology": opts.get("topology") or "grid",
        "model-config": {k: v for k, v in vars(model).items()
                        if isinstance(v, (bool, int, float, str))},
        "opts": clean_opts,
        "final-start": int(final_start),
        "ms-per-tick": ms_per_tick,
    }


def _rebuild_model(spec: Dict[str, Any]):
    """The worker's model: the registry's model of the workload name,
    then the recorded scalar knobs, so decoding and checking match the
    parent's model (the model is built for checking only)."""
    from ..models import get_model
    model = get_model(spec["workload"], spec["node-count"],
                      spec["topology"], opts=spec["opts"])
    for k, v in spec.get("model-config", {}).items():
        if hasattr(model, k):
            setattr(model, k, v)
    return model


# --- incremental checkers ----------------------------------------------------
#
# A checker that folds records chunk by chunk registers a streaming twin:
# its worker consumes each chunk's records and drops them (bounded memory
# however long the run) and gives the batch checker's exact dict. Other
# checkers keep the whole history and run once at the end.


class _IncrementalUniqueIds:
    """Streaming twin of ``checkers.unique_ids.unique_ids_checker``:
    field-for-field its output (first-seen Counter order, repr min/max
    tie-breaks) without keeping the history."""

    def __init__(self, model, opts):
        from collections import Counter
        del model, opts
        self._f = "generate"
        self._counts = Counter()
        self._attempted = 0
        self._min_id = self._max_id = None
        self._have_ids = False

    def feed(self, records: List[dict]) -> None:
        for rec in records:
            if rec["f"] != self._f:
                continue
            if rec["type"] == "invoke":
                self._attempted += 1
            elif rec["type"] == "ok":
                value = rec["value"]
                self._counts[repr(value)] += 1
                if not self._have_ids:
                    self._min_id = self._max_id = value
                    self._have_ids = True
                else:
                    # strict comparisons keep the batch checker's
                    # first-occurrence tie-breaks
                    if repr(value) < repr(self._min_id):
                        self._min_id = value
                    if repr(value) > repr(self._max_id):
                        self._max_id = value

    def result(self) -> dict:
        dups = {k: v for k, v in self._counts.items() if v > 1}
        return {
            "valid?": not dups,
            "attempted-count": self._attempted,
            "acknowledged-count": sum(self._counts.values()),
            "duplicated-count": len(dups),
            "duplicated": dict(list(dups.items())[:32]),
            "range": ([self._min_id, self._max_id]
                      if self._have_ids else None),
        }


INCREMENTAL_CHECKERS = {"unique-ids": _IncrementalUniqueIds}


# --- the worker --------------------------------------------------------------


def _worker_main(widx: int, spec: Dict[str, Any], task_q,
                 result_q) -> None:
    """One farm worker: rebuild the model and checker, accumulate (or
    fold) the streamed slabs of the instances it owns, check them at
    ``finalize`` and report ``{instance: verdict}``. A checker that
    raises gives that instance a failing verdict (``checker_failure``);
    anything structural reports ``error`` and the parent checks
    serially."""
    # host checkers only: a worker must never create a CUDA context
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    native = spec.get("engine") == "native"
    try:
        if native:
            # the native engine's farm: histories arrive decoded, as
            # "records" tasks, and the harness's one-argument checker
            # of the workload checks them
            from ..native.harness import _checker_for
            checker = _checker_for(spec["workload"],
                                   spec.get("consistency"))
            inc_cls = None
        else:
            from ..decode import materialize_records
            model = _rebuild_model(spec)
            checker = model.checker()
            name = checker_name(model)
            final_start = spec["final-start"]
            mpt = spec["ms-per-tick"]
            check_opts = spec["opts"]
            inc_cls = INCREMENTAL_CHECKERS.get(spec["workload"])
        result_q.put((_READY, widx, None))
    except BaseException:
        result_q.put((_FAILED, widx, traceback.format_exc()[-2000:]))
        return
    histories: Dict[int, List[dict]] = {}
    counts: Dict[int, int] = {}
    incremental: Dict[int, Any] = {}
    try:
        while True:
            task = task_q.get()
            kind = task[0]
            if kind == "chunk":
                for inst, slab in task[1].items():
                    base = counts.get(inst, 0)
                    records = materialize_records(model, slab,
                                                  final_start, mpt,
                                                  index_base=base)
                    counts[inst] = base + len(records)
                    if inc_cls is not None:
                        if inst not in incremental:
                            incremental[inst] = inc_cls(model, check_opts)
                        incremental[inst].feed(records)
                    else:
                        histories.setdefault(inst, []).extend(records)
            elif kind == "records":
                # the native twin of "chunk": dict records, appended
                for inst, records in task[1].items():
                    histories.setdefault(inst, []).extend(records)
            elif kind == "finalize":
                verdicts: Dict[int, dict] = {}
                for inst in task[1]:
                    if native:
                        try:
                            verdicts[inst] = checker(
                                histories.get(inst, []))
                        except Exception as e:
                            # the native harness's shape of a checker
                            # that raised: a failing verdict
                            verdicts[inst] = {"valid?": False,
                                              "error": repr(e)}
                        continue
                    try:
                        if inc_cls is not None:
                            acc = incremental.get(inst)
                            if acc is None:
                                acc = inc_cls(model, check_opts)
                            verdicts[inst] = acc.result()
                        else:
                            verdicts[inst] = checker(
                                histories.get(inst, []), check_opts)
                    except Exception as e:
                        verdicts[inst] = checker_failure(
                            e, checker=name, instance=inst)
                result_q.put((_DONE, widx, verdicts))
            elif kind == "stop":
                return
    except BaseException:
        try:
            result_q.put((_FAILED, widx, traceback.format_exc()[-2000:]))
        except Exception:
            pass


# --- the parent-side farm ----------------------------------------------------


def _main_importable() -> bool:
    """Can spawn-semantics children re-import ``__main__``? True for a
    script or a ``-m`` entry point (the CLI, ``chip_smoke.py``); False
    for a REPL, ``python -c`` or stdin, and for pytest-xdist's workers,
    whose ``__main__`` has no importable source."""
    import sys
    main = sys.modules.get("__main__")
    if main is None:
        return False
    spec = getattr(main, "__spec__", None)
    if spec is not None and getattr(spec, "name", None):
        return True                      # python -m entry
    path = getattr(main, "__file__", None)
    return bool(path) and os.path.exists(path)


class CheckerPool:
    """A spawn-once farm of :func:`_worker_main` processes with
    deterministic instance ownership. Its methods degrade instead of
    raising: a dead worker or a full queue marks the pool ``broken``,
    and the caller (:class:`VerdictPipeline`) checks serially."""

    def __init__(self, spec: Dict[str, Any], workers: int):
        import multiprocessing as mp
        # forkserver: workers fork from a server process that never
        # initialized CUDA (a forked CUDA context is unusable), and after
        # its one warm-up import each spawn is a cheap fork
        ctx_name = ("forkserver"
                    if "forkserver" in mp.get_all_start_methods()
                    else "spawn")
        self.workers = max(1, int(workers))
        self.broken = False
        self.feed_s = 0.0
        self.processes = []
        if not _main_importable():
            # such children re-import __main__, and there is none to
            # import: they would die in multiprocessing's preparation.
            # Spawn nothing; the serial path gives the same verdicts.
            self.broken = True
            return
        try:
            ctx = mp.get_context(ctx_name)
            if ctx_name == "forkserver":
                try:
                    ctx.set_forkserver_preload(
                        ["maelstrom_tpu_torch.checkers.pool"])
                except Exception:
                    pass
            self._result_q = ctx.Queue()
            self._task_qs = [ctx.Queue() for _ in range(self.workers)]
            self.processes = [
                ctx.Process(target=_worker_main,
                            args=(w, spec, self._task_qs[w],
                                  self._result_q),
                            daemon=True)
                for w in range(self.workers)]
            for proc in self.processes:
                proc.start()
        except Exception:
            self.broken = True
            self.processes = []

    def owner(self, inst: int) -> int:
        return inst % self.workers

    def feed(self, slabs: Dict[int, Any]) -> None:
        """Route one chunk's per-instance slabs to their owners."""
        self._route("chunk", slabs)

    def feed_records(self, records_by_inst: Dict[int, List[dict]]
                     ) -> None:
        """The native twin of :meth:`feed`: route decoded dict records
        (whole or partial histories) to their owners."""
        self._route("records", records_by_inst)

    def _route(self, kind: str, by_inst: Dict[int, Any]) -> None:
        if self.broken:
            return
        t0 = time.monotonic()
        per_worker: Dict[int, Dict[int, Any]] = {}
        for inst, payload in by_inst.items():
            per_worker.setdefault(self.owner(inst), {})[inst] = payload
        try:
            for w, batch in per_worker.items():
                self._task_qs[w].put((kind, batch))
        except Exception:
            self.broken = True
        self.feed_s += time.monotonic() - t0

    def finalize(self, instances: List[int],
                 timeout: float = 600.0) -> Optional[Dict[int, dict]]:
        """Every worker's verdicts for its owned ``instances``; None —
        the caller checks serially — on a worker's death, a structural
        error or the timeout."""
        if self.broken:
            return None
        per_worker: Dict[int, List[int]] = {w: []
                                            for w in range(self.workers)}
        for inst in instances:
            per_worker[self.owner(inst)].append(inst)
        try:
            for w, owned in per_worker.items():
                self._task_qs[w].put(("finalize", owned))
        except Exception:
            self.broken = True
            return None
        import queue as queue_mod
        verdicts: Dict[int, dict] = {}
        done = set()
        deadline = time.monotonic() + timeout
        while len(done) < self.workers:
            try:
                tag, w, payload = self._result_q.get(timeout=0.5)
            except queue_mod.Empty:
                if time.monotonic() > deadline:
                    self.broken = True
                    return None
                if any(not proc.is_alive()
                       for i, proc in enumerate(self.processes)
                       if i not in done):
                    self.broken = True
                    return None
                continue
            if tag == _READY:
                continue
            if tag == _FAILED:
                self.broken = True
                return None
            verdicts.update(payload)
            done.add(w)
        if set(instances) - set(verdicts):
            self.broken = True
            return None
        return verdicts

    def close(self) -> None:
        """Stop every worker (terminated if it does not stop within
        2 s) and close the queues."""
        try:
            for task_q in self._task_qs:
                task_q.put(("stop",))
        except Exception:
            pass
        for proc in self.processes:
            proc.join(timeout=2.0)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=2.0)
        for q in getattr(self, "_task_qs", []) + (
                [self._result_q] if hasattr(self, "_result_q") else []):
            try:
                q.close()
                q.cancel_join_thread()
            except Exception:
                pass

    def kill(self) -> None:
        """SIGKILL every worker: the pool-death fallback's test hook."""
        for proc in self.processes:
            if proc.is_alive():
                proc.kill()
        for proc in self.processes:
            proc.join(timeout=5.0)


# --- the harness's verdict stage ---------------------------------------------


def _check_serially(model, histories, instances, opts) -> Dict[int, dict]:
    checker = model.checker()
    name = checker_name(model)
    out = {}
    for inst in instances:
        try:
            out[inst] = checker(histories[inst], opts)
        except Exception as e:   # a checker blow-up is a failing verdict
            out[inst] = checker_failure(e, checker=name, instance=inst)
    return out


class VerdictPipeline:
    """Streaming decode, pooled check, serial fallback, timed.

    Build it before the run starts (the workers start while the card
    works), feed it chunk payloads (:attr:`feed_chunk`) or one dense
    tensor (:attr:`feed_dense`), then :meth:`finish` for ``(verdicts,
    histories, record)``, ``record`` being ``perf.phases.check``. The
    verdicts equal the serial loop's whatever happens to the pool."""

    def __init__(self, model, n_clients: int, record_instances: int,
                 final_start: int, ms_per_tick: float,
                 opts: Dict[str, Any], workers: int):
        from ..decode import StreamDecoder
        self._model = model
        self._opts = opts
        self._R = int(record_instances)
        self.workers = int(workers) if self._R > 0 else 0
        self.pool: Optional[CheckerPool] = None
        if self.workers > 0:
            self.pool = CheckerPool(
                pool_spec(model, opts, final_start, ms_per_tick),
                self.workers)
            if self.pool.broken:
                self.pool = None
        self.decoder = StreamDecoder(
            model, n_clients, self._R, final_start, ms_per_tick,
            on_slabs=(self.pool.feed if self.pool is not None else None))
        self.feed_chunk = self.decoder.feed
        self.feed_dense = self.decoder.feed_dense

    def finish(self, flagged=None):
        """``flagged=None`` checks every recorded instance (``farm``
        mode). A list of record indices checks only those (``device``
        mode): every other recorded instance was screened clean on the
        card and gets ``{"valid?": True, "checked-by":
        "device-summary"}`` with no host checker work. A flagged
        instance's verdict is farm mode's byte for byte: the same slabs,
        the same owner, the same checker call."""
        histories = self.decoder.finish()
        if flagged is None:
            checked = list(range(self._R))
        else:
            checked = sorted({int(i) for i in flagged
                              if 0 <= int(i) < self._R})
        mode = "serial"
        verdicts_map = None
        t0 = time.monotonic()
        if self.pool is not None:
            verdicts_map = self.pool.finalize(checked) if checked else {}
            mode = ("pooled" if verdicts_map is not None
                    else "pooled-fallback-serial")
        if verdicts_map is None:
            verdicts_map = _check_serially(self._model, histories, checked,
                                           self._opts)
        check_s = time.monotonic() - t0
        if flagged is None:
            verdicts = [verdicts_map[inst] for inst in checked]
        else:
            verdicts = [verdicts_map[inst] if inst in verdicts_map
                        else {"valid?": True,
                              "checked-by": "device-summary"}
                        for inst in range(self._R)]
        record = {
            "mode": mode,
            "workers": self.workers if mode == "pooled" else 0,
            "instances": self._R,
            "farm-instances": len(checked),
            "decode-s": round(self.decoder.decode_s, 4),
            "check-s": round(check_s, 4),
            "verdicts-per-s": (round(len(checked) / check_s, 1)
                               if check_s > 0 else None),
        }
        if self.pool is not None:
            record["feed-s"] = round(self.pool.feed_s, 4)
        self.close()
        return verdicts, histories, record

    def close(self) -> None:
        if self.pool is not None:
            self.pool.close()


def check_native_histories(workload: str, histories,
                           consistency: Optional[str] = None,
                           workers: int = 0) -> List[dict]:
    """The native engine's check loop, farmed: the decoded histories of
    ``native/harness.py`` go to the workers verbatim as ``"records"``
    tasks, each checked by the harness's one-argument checker of the
    workload. Verdicts come back in instance order, and any pool
    failure checks serially: they are byte-identical either way, a
    checker that raises included (``{"valid?": False, "error":
    repr(e)}``)."""
    n = len(histories)
    if workers > 0 and n > 0:
        pool = CheckerPool({"engine": "native", "workload": workload,
                            "consistency": consistency}, workers)
        try:
            if not pool.broken:
                pool.feed_records(dict(enumerate(histories)))
                verdicts = pool.finalize(list(range(n)))
                if verdicts is not None:
                    return [verdicts[i] for i in range(n)]
        finally:
            pool.close()
    from ..native.harness import _checker_for
    checker = _checker_for(workload, consistency)
    out = []
    for h in histories:
        try:
            v = checker(h)
        except Exception as e:
            v = {"valid?": False, "error": repr(e)}
        out.append(v)
    return out


def check_instances(model, histories, opts: Dict[str, Any],
                    workers: int = 0, final_start: int = 1 << 30,
                    ms_per_tick: float = 1) -> List[dict]:
    """The workload checker over decoded histories: pooled when
    ``workers > 0`` and the histories are lazy slabs (the workers
    rebuild the records from them), else serially. Each blow-up comes
    back as a ``checker_failure`` dict either way."""
    from ..decode import LazyHistories
    n = len(histories)
    if isinstance(histories, LazyHistories) and workers > 0:
        slabs = {inst: histories.slab(inst) for inst in range(n)
                 if histories.slab(inst) is not None}
        pool = CheckerPool(pool_spec(model, opts, final_start,
                                     ms_per_tick), workers)
        try:
            if not pool.broken:
                pool.feed(slabs)
                verdicts = pool.finalize(list(range(n)))
                if verdicts is not None:
                    return [verdicts[inst] for inst in range(n)]
        finally:
            pool.close()
    out = _check_serially(model, histories, range(n), opts)
    return [out[inst] for inst in range(n)]
