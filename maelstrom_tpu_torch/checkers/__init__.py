"""History checkers of the port (three-valued ``valid?``: True / False /
"unknown")."""


def compose_valid(verdicts) -> object:
    """Combine sub-verdicts: False dominates, then "unknown", then True."""
    out = True
    for v in verdicts:
        if v is False:
            return False
        if v == "unknown":
            out = "unknown"
    return out


def checker_failure(exc, checker=None, instance=None,
                    tb_limit: int = 1200) -> dict:
    """A checker that raised, as a failing verdict with its traceback."""
    import traceback
    out = {"valid?": False, "error": repr(exc)}
    if checker is not None:
        out["checker"] = checker
    if instance is not None:
        out["instance"] = int(instance)
    tb = exc.__traceback__
    tb = tb.tb_next if tb is not None and tb.tb_next is not None else tb
    out["traceback"] = "".join(
        traceback.format_exception(type(exc), exc, tb))[-tb_limit:]
    return out


def check_history(history, opts, checker, extra=None, name=None):
    """Compose the standard checkers over one recorded history.

    Shared by the live runner and the offline ``check`` command so the
    two can never diverge (same sub-checkers, same exception handling,
    same composition). ``extra`` merges additional pre-computed results
    (e.g. the live runner's journal-based net stats) into the composed
    map before the verdict is taken. A workload checker that raises
    becomes a failing result with the error attached, not a crash;
    ``name`` labels the blow-up verdict's ``checker`` field (falls back
    to the generic "workload")."""
    import traceback

    from .availability import availability_checker
    from .perf import perf_checker, stats_checker

    results = {
        "perf": perf_checker(history),
        "stats": stats_checker(history),
        "availability": availability_checker(
            history, opts["availability"]),
    }
    if extra:
        results.update(extra)
    if checker is not None:
        try:
            results["workload"] = checker(history, opts)
        except Exception as e:
            traceback.print_exc()
            results["workload"] = checker_failure(
                e, checker=name or "workload")
    results["valid?"] = compose_valid(
        r.get("valid?", True)
        for r in results.values() if isinstance(r, dict))
    return results
