"""Python twin of the native engine's per-family wire-width table.

A copy of ``maelstrom_tpu/native/wire.py``. This is the native engine's
wire (``cpp/engine/sim.cpp``), apart from the port's root ``wire.py``,
which is the device runtime's.

``cpp/engine/sim.cpp`` templates its ``Msg``/``Entry`` structs on a
per-workload-family body width class. This module is the Python side of
that table, read by

- ``native/engine.py`` and ``bench.py``'s native lines (``msg_lanes`` /
  ``bytes_per_msg_row``), and
- the LNE610 rule of ``lint --lanes`` (:func:`check_native_widths`),
  which cross-checks three surfaces: the C++ source constants (parsed),
  this table, and the port's model registry's per-family lane math.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

# engine-wide txn micro-op slot bound (sim.cpp TXN_CAP)
TXN_CAP = 4

# lin-kv log entries carry (f, k, a, b, client, cmsg) on the wire
LINKV_ENTRY_LANES = 6

# width classes (sim.cpp W_GOSSIP / W_LINKV / W_TXN)
W_GOSSIP = 6
W_LINKV = 6 + LINKV_ENTRY_LANES + 1            # 13: + entry + hop lane
W_TXN = 6 + 1 + 3 * TXN_CAP + 2                # 21: + txn entry

# body-lane offsets (sim.cpp L_*)
L_ENTRY = 6
L_HOPS = L_ENTRY + LINKV_ENTRY_LANES           # 12
L_THOPS = 1 + 3 * TXN_CAP                      # 13

# workload name -> body width class of its Msg template instantiation
NATIVE_BODY_LANES: Dict[str, int] = {
    "lin-kv": W_LINKV,
    "txn-list-append": W_TXN,
    "txn-rw-register": W_TXN,
    "g-set": W_GOSSIP,
    "broadcast": W_GOSSIP,
    "unique-ids": W_GOSSIP,
    "pn-counter": W_GOSSIP,
    "g-counter": W_GOSSIP,
    "echo": W_GOSSIP,
    "kafka": W_GOSSIP,
}

# LNE610 LINT FIXTURE (never read by the engine): a deliberately
# divergent table the lanes pass audits on full runs, so the rule is
# seen to fire. Its expected-status entry lives in the port's
# analysis/baseline.json; removing this without removing the entry
# makes the entry stale (reported).
FIXTURE_DIVERGENT_WIDTHS: Dict[str, int] = {"lin-kv": W_LINKV - 1}

_CPP_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "cpp", "engine", "sim.cpp")


def _parse_const(src: str, name: str) -> Optional[int]:
    """Evaluate one ``constexpr int NAME = <arith expr>;`` from the C++
    source (the expressions are +*() integer arithmetic over already
    parsed constants, e.g. ``6 + 1 + 3 * TXN_CAP + 2``)."""
    m = re.search(rf"constexpr\s+int\s+{name}\s*=\s*([^;]+);", src)
    if not m:
        return None
    expr = m.group(1).split("//")[0]
    expr = re.sub(r"\bTXN_CAP\b", str(TXN_CAP), expr)
    for sym in ("W_GOSSIP", "W_LINKV", "W_TXN"):
        val = _parse_const.cache.get(sym)
        if val is not None:
            expr = re.sub(rf"\b{sym}\b", str(val), expr)
    if not re.fullmatch(r"[\d\s+*()/-]+", expr):
        return None
    try:
        val = int(eval(expr))  # arithmetic only, by the fullmatch guard
    except Exception:
        return None
    _parse_const.cache[name] = val
    return val


_parse_const.cache = {}


def parse_cpp_widths(src: Optional[str] = None) -> Dict[str, int]:
    """The native source's width constants, parsed. Raises OSError when
    the C++ source is missing (callers decide whether that is fatal)."""
    if src is None:
        with open(_CPP_PATH) as f:
            src = f.read()
    _parse_const.cache = {}
    out = {}
    for name in ("TXN_CAP", "W_GOSSIP", "W_LINKV", "W_TXN", "L_ENTRY",
                 "L_HOPS", "L_THOPS", "BODY_LANES_MAX"):
        val = _parse_const(src, name)
        if val is not None:
            out[name] = val
    # the dispatch map: workload 1/7 -> W_TXN, 0 -> W_LINKV, else gossip
    m = re.search(
        r"constexpr\s+int\s+body_lanes_for[^}]+}", src)
    out["_dispatch"] = bool(
        m and re.search(r"workload\s*==\s*1\s*\|\|\s*workload\s*==\s*7",
                        m.group(0))
        and re.search(r"workload\s*==\s*0", m.group(0)))
    return out


def check_native_widths(cpp_src: Optional[str] = None,
                        table: Optional[Dict[str, int]] = None,
                        registry_entry_lanes: Optional[Dict[str, int]]
                        = None,
                        compiled_lanes=None,
                        ) -> List[Tuple[str, str]]:
    """LNE610's core: cross-check the C++ width constants, this module's
    table, and the registry's per-family lane math. Returns ``(symbol,
    message)`` problems (empty = conformant). Every input can be
    injected:

    - ``cpp_src``: sim.cpp's text (default: read from the repo);
    - ``table``: the Python width table (default
      :data:`NATIVE_BODY_LANES`);
    - ``registry_entry_lanes``: per-workload lane facts of the live
      model registry (the lanes pass supplies them);
    - ``compiled_lanes``: ``workload -> native_msg_lanes(workload)`` of
      the built library (source against binary).
    """
    table = NATIVE_BODY_LANES if table is None else table
    problems: List[Tuple[str, str]] = []
    try:
        cpp = parse_cpp_widths(cpp_src)
    except OSError as e:
        return [("sim.cpp", f"native source unreadable: {e}")]

    def need(name: str) -> Optional[int]:
        if name not in cpp:
            problems.append(
                ("sim.cpp", f"constant {name} not found in "
                            f"cpp/engine/sim.cpp — the LNE610 "
                            f"conformance surface moved"))
            return None
        return cpp[name]

    txn_cap = need("TXN_CAP")
    w_gossip, w_linkv, w_txn = (need("W_GOSSIP"), need("W_LINKV"),
                                need("W_TXN"))
    l_entry, l_hops, l_thops = (need("L_ENTRY"), need("L_HOPS"),
                                need("L_THOPS"))
    if None in (txn_cap, w_gossip, w_linkv, w_txn, l_entry, l_hops,
                l_thops):
        return problems
    # structural derivations every width hangs off
    derivations = [
        ("TXN_CAP", txn_cap == TXN_CAP,
         f"C++ TXN_CAP={txn_cap} != python TXN_CAP={TXN_CAP}"),
        ("W_GOSSIP", w_gossip == W_GOSSIP,
         f"C++ W_GOSSIP={w_gossip} != python {W_GOSSIP} (the 6 "
         f"protocol body lanes every family shares)"),
        ("W_LINKV", w_linkv == l_entry + LINKV_ENTRY_LANES + 1,
         f"C++ W_LINKV={w_linkv} != L_ENTRY+{LINKV_ENTRY_LANES}+1 "
         f"(entry lanes + the L_HOPS forward counter)"),
        ("L_HOPS", l_hops == l_entry + LINKV_ENTRY_LANES,
         f"C++ L_HOPS={l_hops} != L_ENTRY+{LINKV_ENTRY_LANES}"),
        ("W_TXN", w_txn == l_entry + 1 + 3 * txn_cap + 2,
         f"C++ W_TXN={w_txn} != L_ENTRY+1+3*TXN_CAP+2"),
        ("L_THOPS", l_thops == 1 + 3 * txn_cap,
         f"C++ L_THOPS={l_thops} != 1+3*TXN_CAP"),
        ("body_lanes_for", bool(cpp.get("_dispatch")),
         "body_lanes_for dispatch no longer maps workloads 1/7 to "
         "W_TXN and 0 to W_LINKV"),
    ]
    for sym, ok, msg in derivations:
        if not ok:
            problems.append((sym, msg))
    # the table must cover the engine's workloads: a workload added to
    # NATIVE_WORKLOADS but not here would escape the check
    from .engine import NATIVE_WORKLOADS
    missing = sorted(set(NATIVE_WORKLOADS) - set(table))
    if missing:
        problems.append(
            ("NATIVE_BODY_LANES",
             f"workload(s) {missing} are in NATIVE_WORKLOADS but "
             f"missing from the width table — their rows are "
             f"unguarded"))
    # python table vs C++ classes
    cls = {"lin-kv": w_linkv, "txn-list-append": w_txn,
           "txn-rw-register": w_txn}
    for wl, want in table.items():
        have = cls.get(wl, w_gossip)
        if want != have:
            problems.append(
                (wl, f"width table says {wl} rides {want} body lanes "
                     f"but the C++ instantiation is {have} — the "
                     f"templates and the table diverged"))
    # registry lane math vs the native classes
    for wl, lanes_needed in (registry_entry_lanes or {}).items():
        have = table.get(wl)
        if have is not None and have < lanes_needed:
            problems.append(
                (wl, f"registry model {wl} needs {lanes_needed} body "
                     f"lanes but the native width class carries "
                     f"{have} — narrow rows would truncate the "
                     f"protocol"))
    # compiled binary vs source (a stale .so speaks an older format)
    for wl, lanes in (compiled_lanes or {}).items():
        want = table.get(wl)
        if want is not None and lanes is not None and lanes != want:
            problems.append(
                (wl, f"built libsim.so instantiates {wl} at {lanes} "
                     f"body lanes but the table says {want} — rebuild "
                     f"the engine (make -C cpp/engine)"))
    return problems


def registry_width_facts() -> Dict[str, int]:
    """Per-family minimum body lanes that the port's registry models
    imply for the native twins: the request, entry and hop lanes the
    shared protocol streams (reply widths differ by design: the native
    wire carries variable read results out of band in ``Msg.ext``)."""
    from ..models import get_model
    facts: Dict[str, int] = {}
    lin = get_model("lin-kv", 3)
    facts["lin-kv"] = 6 + int(lin.entry_lanes) + 1
    txn = get_model("txn-list-append", 3)
    # native txn entries are TXN_CAP-slot fixed; the registry's txn_max
    # must fit (the native row is 6 + 1 + 3*cap + 2 wide)
    facts["txn-list-append"] = 6 + 1 + 3 * int(txn.txn_max) + 2
    facts["txn-rw-register"] = facts["txn-list-append"]
    return facts
