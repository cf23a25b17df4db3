"""Declarative fault plans: parse, validate, generate, compile.

The port's own copy of ``maelstrom_tpu/faults/spec.py`` (numpy only,
no change of behaviour): plans compile to the same tuples, and refuse
the same inputs with the same messages.

A **fault plan** is a JSON-able dict (CLI ``--fault-plan plan.json``,
or inline as the ``fault_plan`` opt) naming a phase timeline and, per
phase, which fault lanes are active:

.. code-block:: json

    {"snapshot_every": 1,
     "phases": [
       {"until": 300, "members": [0, 1, 2]},
       {"until": 360, "crash": [0, 1]},
       {"until": 600, "links": [
          {"dst": 1, "src": 0, "block": true},
          {"dst": 0, "src": 1, "delay": 25},
          {"dst": 0, "src": 2, "loss": 0.25}]},
       {"until": 700, "add": [3, 4]},
       {"until": 900, "skew": {"0": 2.0, "2": 0.75}}
     ]}

- ``until`` — phase end tick (strictly increasing; phase 0 starts at
  tick 0). Ticks past the last phase — and past the run's final-heal
  ``stop_tick`` — are healthy.
- ``crash`` — server node ids held crashed for the phase (state wiped
  to the restart row every crashed tick, inbox dropped, sends
  suppressed; recovery semantics live in ``Model.restart_row``).
- ``links`` — directed ``(dst, src)`` edge qualities: ``block`` (bool),
  ``delay`` (extra ticks), ``loss`` (probability 0..1, stored
  per-mille). One edge may combine delay and loss.
- ``skew`` — ``{node: rate}`` clock-rate multipliers (0.125..8.0,
  quantized to 64ths; 1.0 is exactly neutral).
- **membership** — ``members`` (the absolute server member set from
  this phase on), or ``add``/``remove`` (events relative to the
  previous phase's set). Unlike the other lanes, membership INHERITS:
  a phase without a membership key keeps the previous set, the cluster
  starts at all ``n_nodes`` unless phase 0 says otherwise, and the
  trailing heal (past the last phase or ``stop_tick``) restores
  everyone. Non-members are parked like crashed nodes (recv dropped,
  sends suppressed, state held at the snapshot slab's leave-point
  row); a node whose membership turns ON re-boots through
  ``Model.join_row`` (slab recovery + re-provisioned cluster config —
  the Netherite rejoin idiom), and the current member bitmask threads
  into the node step so reconfiguration-aware protocols (Raft joint
  consensus, ``models/raft_core.py``) can run the change through their
  log. A plan may never empty the cluster or name a node past
  ``n_nodes`` — both are refused at compile time BY PHASE.

``generate_fault_plan`` builds the same dict shape from the CLI's
composable ``--nemesis`` kinds (``crash-restart``, ``link-degrade``,
``clock-skew``) on the partition nemesis's interval grid, so fault
lanes compose with each other AND with the existing partition nemesis
in one run. ``compile_fault_plan`` lowers a plan dict to the static
:class:`~.engine.FaultConfig` the tick reads.

A plan is ONE deterministic, fleet-shared schedule. Its randomized
sibling is the fault DISTRIBUTION (``--fault-fuzz``, :mod:`~.fuzz`):
the same lanes, but with rates and ranges that each instance samples
into its OWN schedule on the device — and ``fuzz.schedule_to_plan``
lowers any drawn schedule back INTO this module's plan dialect (plans
that ``validate_fault_plan``/``compile_fault_plan`` accept verbatim),
so the deterministic plan remains the single replay currency.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from .engine import FaultConfig, NEUTRAL_RATE

# the composable --nemesis vocabulary beyond "partition"
FAULT_KINDS = ("crash-restart", "link-degrade", "clock-skew",
               "membership")

MAX_DELAY_TICKS = 1 << 14      # keeps deadlines far inside the 2^20
                               # delivery-priority horizon
MIN_RATE, MAX_RATE = 0.125, 8.0
MAX_MEMBER_NODES = 30          # membership bitmasks ride int32 lanes


class SpecError(ValueError):
    """A fault plan that cannot be compiled."""


def _err(msg: str) -> "SpecError":
    return SpecError(f"fault plan: {msg}")


def _get(d: Dict[str, Any], name: str, default=None):
    """Dash/underscore-tolerant key lookup (campaign specs are JSON
    written by humans; both spellings appear in the wild)."""
    if name in d:
        return d[name]
    alt = name.replace("_", "-")
    return d.get(alt, default)


def _node_id(v, n_nodes: int, what: str) -> int:
    try:
        i = int(v)
    except (TypeError, ValueError):
        raise _err(f"{what} {v!r} is not a node index")
    if not 0 <= i < n_nodes:
        raise _err(f"{what} {i} out of range [0, {n_nodes})")
    return i


def membership_walk(phases, n_nodes: int):
    """Resolve the membership lane to one ABSOLUTE member set per phase
    (inheritance applied), or ``None`` when no phase carries a
    membership key. Raises :class:`SpecError` — naming the offending
    phase — on a set that would empty the cluster, a node id past the
    ``n_nodes`` capacity, or a cluster too wide for the int32 member
    bitmask."""
    keys = ("members", "add", "remove")
    if not any(_get(ph, k) is not None for ph in phases for k in keys):
        return None
    if n_nodes > MAX_MEMBER_NODES:
        raise _err(f"membership lane supports at most "
                   f"{MAX_MEMBER_NODES} server nodes (int32 member "
                   f"bitmask), got n_nodes={n_nodes}")
    current = set(range(n_nodes))
    out = []
    for i, ph in enumerate(phases):
        members = _get(ph, "members")
        add = _get(ph, "add")
        remove = _get(ph, "remove")
        if members is not None and (add is not None
                                    or remove is not None):
            raise _err(f"phase {i} mixes 'members' with 'add'/'remove'"
                       f" — one absolute set or relative events, not "
                       f"both")
        if members is not None:
            current = {_node_id(v, n_nodes, f"phase {i} member")
                       for v in members}
        else:
            current = set(current)
            for v in (add or []):
                current.add(_node_id(v, n_nodes, f"phase {i} added "
                                                 f"node"))
            for v in (remove or []):
                current.discard(
                    _node_id(v, n_nodes, f"phase {i} removed node"))
        if not current:
            raise _err(f"phase {i} membership would EMPTY the cluster "
                       f"(every phase needs >= 1 member)")
        out.append(tuple(sorted(current)))
    return out


def membership_heal_phases(plan: Dict[str, Any],
                           n_nodes: Optional[int] = None) -> set:
    """Indices of phases whose ``members`` key removes NO node relative
    to the previous phase's resolved set — restores and no-ops. The
    shrinker and the minimality metric (``fuzz.plan_weight``) treat
    these as HEALS, exactly like rejoin ``add`` events: dropping one
    would EXTEND the membership outage (inheritance keeps the reduced
    set), which is the opposite of shrinking. When ``n_nodes`` is
    unknown the universe is inferred as the widest node id the plan
    itself names — a ``members`` set that silently excludes un-named
    trailing nodes then classifies as heal, which errs CONSERVATIVE
    (it is merely never offered as a drop candidate)."""
    phases = list((plan or {}).get("phases") or ())
    keys = ("members", "add", "remove")
    if not any(_get(ph, k) is not None for ph in phases for k in keys):
        return set()
    if n_nodes is None:
        named = [int(v) for ph in phases for k in keys
                 for v in (_get(ph, k) or [])]
        n_nodes = (max(named) + 1) if named else 1
    walk = membership_walk(phases, n_nodes)
    heals = set()
    prev = set(range(n_nodes))
    for i, cur in enumerate(walk):
        cur = set(cur)
        if _get(phases[i], "members") is not None and prev <= cur:
            heals.add(i)
        prev = cur
    return heals


def validate_fault_plan(plan: Dict[str, Any], n_nodes: int) -> None:
    """Raise :class:`SpecError` on a malformed plan (compile calls this
    first; the CLI calls it directly for early, friendly errors)."""
    if not isinstance(plan, dict):
        raise _err(f"top level must be a dict, got {type(plan).__name__}")
    phases = _get(plan, "phases")
    if not isinstance(phases, list) or not phases:
        raise _err("needs a non-empty 'phases' list")
    every_raw = _get(plan, "snapshot_every", 1)
    every = 1 if every_raw is None else int(every_raw)
    if every < 1:
        raise _err(f"snapshot_every must be >= 1, got {every}")
    prev = 0
    for i, ph in enumerate(phases):
        if not isinstance(ph, dict):
            raise _err(f"phase {i} is not a dict: {ph!r}")
        until = _get(ph, "until")
        if not isinstance(until, (int, float)) or int(until) <= prev:
            raise _err(f"phase {i} 'until' must be an int > {prev}, "
                       f"got {until!r}")
        prev = int(until)
        for v in _get(ph, "crash", []) or []:
            _node_id(v, n_nodes, f"phase {i} crash victim")
        for e in _get(ph, "links", []) or []:
            if not isinstance(e, dict):
                raise _err(f"phase {i} link entry is not a dict: {e!r}")
            _node_id(_get(e, "dst"), n_nodes, f"phase {i} link dst")
            _node_id(_get(e, "src"), n_nodes, f"phase {i} link src")
            d = _get(e, "delay", 0) or 0
            if not 0 <= int(d) <= MAX_DELAY_TICKS:
                raise _err(f"phase {i} link delay {d} out of "
                           f"[0, {MAX_DELAY_TICKS}]")
            p = float(_get(e, "loss", 0.0) or 0.0)
            if not 0.0 <= p <= 1.0:
                raise _err(f"phase {i} link loss {p} out of [0, 1]")
        skew = _get(ph, "skew", {}) or {}
        if not isinstance(skew, dict):
            raise _err(f"phase {i} skew must be a dict, got {skew!r}")
        for node, rate in skew.items():
            _node_id(node, n_nodes, f"phase {i} skew node")
            r = float(rate)
            if not MIN_RATE <= r <= MAX_RATE:
                raise _err(f"phase {i} skew rate {r} out of "
                           f"[{MIN_RATE}, {MAX_RATE}]")
    # membership: the walk itself validates (empty cluster / capacity
    # errors name the offending phase)
    membership_walk(phases, n_nodes)


def compile_fault_plan(plan: Optional[Dict[str, Any]], n_nodes: int,
                       stop_tick: int,
                       snapshot_every: Optional[int] = None
                       ) -> FaultConfig:
    """Lower a plan dict to the static :class:`FaultConfig`.
    ``plan=None`` compiles the disabled config (the pre-fault tick).
    ``snapshot_every`` (the ``fault_snapshot_every`` opt) overrides the
    plan's own setting when given."""
    if not plan:
        return FaultConfig()
    validate_fault_plan(plan, n_nodes)
    plan_every = _get(plan, "snapshot_every", 1)
    every = int(snapshot_every if snapshot_every is not None
                else (1 if plan_every is None else plan_every))
    untils: List[int] = []
    crash: List[tuple] = []
    links: List[tuple] = []
    skew: List[tuple] = []
    members = membership_walk(_get(plan, "phases"), n_nodes)
    for ph in _get(plan, "phases"):
        untils.append(int(_get(ph, "until")))
        crash.append(tuple(sorted(
            int(v) for v in (_get(ph, "crash", []) or []))))
        links.append(tuple(
            (int(_get(e, "dst")), int(_get(e, "src")),
             1 if _get(e, "block", False) else 0,
             int(_get(e, "delay", 0) or 0),
             int(round(float(_get(e, "loss", 0.0) or 0.0) * 1000)))
            for e in (_get(ph, "links", []) or [])))
        skew.append(tuple(sorted(
            (int(node), max(1, int(round(float(rate) * NEUTRAL_RATE))))
            for node, rate in (_get(ph, "skew", {}) or {}).items())))
    return FaultConfig(enabled=True, stop_tick=int(stop_tick),
                       snapshot_every=every, untils=tuple(untils),
                       crash=tuple(crash), links=tuple(links),
                       skew=tuple(skew),
                       members=(None if members is None
                                else tuple(members)),
                       n_nodes=int(n_nodes))


# --- the composable --nemesis generators -----------------------------------


def generate_fault_plan(kinds: Sequence[str], n_nodes: int,
                        n_ticks: int, interval: int,
                        stop_tick: int) -> Dict[str, Any]:
    """Build a plan dict from the CLI's fault ``--nemesis`` kinds on
    the partition nemesis's interval grid (alternating heal/fault
    phases, deterministic rotation — the plan is shared by every
    instance, so the schedule itself carries no RNG; per-instance
    variation comes from latency/election randomness):

    - ``crash-restart`` — every second phase holds one victim (rotating
      ``phase % n``) crashed: a minority at a time, so a model with
      durable recovery must stay correct.
    - ``link-degrade`` — every second phase degrades a rotating triple
      of directed edges: one blocked (asymmetric partition), one slow
      (``2 * interval // 5`` extra ticks), one lossy (25%).
    - ``clock-skew`` — one whole-run phase spreading node clock rates
      over 0.75x..1.75x (node ``i`` gets ``(48 + 16 * (i % 5)) / 64``).
    - ``membership`` — every second phase REMOVES one rotating node
      (always a minority, so a reconfiguration-aware model must stay
      correct AND live), and the following heal phase explicitly adds
      it back — a rolling remove/rejoin churn that drives the Raft
      joint-consensus machinery through a full ``C_old,new`` ->
      ``C_new`` round per window.
    """
    kinds = [k for k in kinds if k in FAULT_KINDS]
    if not kinds:
        return {}
    horizon = min(int(n_ticks), int(stop_tick))
    # clamp the grid so even a short run gets at least one heal/fault
    # alternation (phase 1 — the first FAULT phase — needs
    # 2*interval <= horizon): asking for faults and silently getting a
    # fault-free plan would be a lie. The partition nemesis's default
    # 10s interval vs a 2-3s smoke run is exactly that trap.
    interval = max(1, min(int(interval), horizon // 4 or 1))
    phases: List[Dict[str, Any]] = []
    if kinds == ["clock-skew"]:
        # skew alone needs no interval grid: one whole-run phase
        phases.append({"until": max(1, horizon),
                       "skew": _skew_spread(n_nodes)})
        return {"phases": phases}
    p = 0
    t = interval
    while t <= horizon:
        ph: Dict[str, Any] = {"until": t}
        active = p % 2 == 1          # odd phases fault, even heal —
        #                              the partition nemesis's cadence
        if active and "crash-restart" in kinds and n_nodes > 1:
            ph["crash"] = [(p // 2) % n_nodes]
        if "membership" in kinds and n_nodes > 1:
            if active:
                victim = (p // 2) % n_nodes
                ph["members"] = [i for i in range(n_nodes)
                                 if i != victim]
            else:
                # explicit restore: membership INHERITS, so a heal
                # phase must say "everyone" to end the removal window
                ph["members"] = list(range(n_nodes))
        if active and "link-degrade" in kinds and n_nodes > 1:
            a = (p // 2) % n_nodes
            b = (a + 1) % n_nodes
            c = (a + 2) % n_nodes if n_nodes > 2 else a
            ph["links"] = [
                {"dst": b, "src": a, "block": True},
                {"dst": a, "src": b, "delay": max(2, 2 * interval // 5)},
                {"dst": c, "src": b, "loss": 0.25},
            ]
        if "clock-skew" in kinds:
            ph["skew"] = _skew_spread(n_nodes)
        phases.append(ph)
        p += 1
        t += interval
    if not phases:
        phases.append({"until": max(1, horizon)})
    return {"phases": phases}


def _skew_spread(n_nodes: int) -> Dict[str, float]:
    return {str(i): (48 + 16 * (i % 5)) / NEUTRAL_RATE
            for i in range(n_nodes)}
