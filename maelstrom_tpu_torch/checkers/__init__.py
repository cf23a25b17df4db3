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
