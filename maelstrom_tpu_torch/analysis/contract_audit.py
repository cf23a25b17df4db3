"""Contract audit on ``meta`` tensors: every model's shapes and lanes.

Counterpart of ``maelstrom_tpu/analysis/contract_audit.py``. The tick
loop only works if each model's hooks are *shape fixed points*: the
carry that leaves a tick must be structurally identical (tree + shapes
+ dtypes) to the one that entered, and the lane constants a model
declares (``body_lanes``, ``op_lanes``, ``ev_vals``, ``max_out``,
``tick_out``) must match what its hooks produce — a mismatch either
fails late, deep inside a run, or (dtype drift) silently changes the
carry from tick to tick. JAX checks this with ``jax.eval_shape``; the
port runs the hooks and one full tick on ``meta`` tensors, which carry
shapes and dtypes and no values. No device is touched and no value is
ever read: a host read inside the tick (``.item()``, ``int()`` of a
tensor, a Python branch on one) raises on ``meta`` and is reported as
CON200, a second net under the trace pass's TRC104.

Rules (CON2xx):

=======  ======================  ========  =================================
rule     name                    severity  what it checks
=======  ======================  ========  =================================
CON200   trace-failure           error     a hook or the tick raised on
                                           ``meta`` tensors
CON201   carry-fixed-point       error     the carry's tree/shape/dtype is
                                           a fixed point of the tick
CON202   emit-shape-contract     error     ``handle``/``tick`` return
                                           ``(max_out|tick_out, lanes)``
                                           int32 rows per node and preserve
                                           the row tree
CON203   client-lane-contract    error     ``sample_op``/``encode_request``
                                           /``decode_reply(_wide)`` match
                                           ``op_lanes``/``lanes``/
                                           ``ev_vals``; event tensor width
                                           is ``2 + ev_vals``
CON204   int32-counter-overflow  error     runtime counters (NETID stamp,
                                           client op ids, delivery-priority
                                           horizon, declared flake-id
                                           splits) stay inside int32 within
                                           the tick horizon
=======  ======================  ========  =================================

``fused_node`` models (the raft family) are probed through their fused
protocol (``node_rng`` -> ``inbox_step`` -> ``fused_tick``, what
``runtime.node_phase`` drives), with ``inbox_step``'s one reply row per
node checked against ``(max_out=1, lanes)``. The port's hooks are
batched: a node hook takes the ``[N, ...]`` rows of one instance, a
client hook ``[1, C, ...]``; the contract is on the trailing axes.

The tick horizon of CON204 is ``TICK_HORIZON = 1 << 20``: the delivery
priority (``netsim.py``) ranks messages by ``((1 << 20) - deliver_tick)
* S``, so a simulation past 2^20 ticks would silently stop delivering —
``make_sim_config`` enforces the same bound.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Tuple

import torch

from .findings import Finding, SEV_ERROR

PASS_NAME = "contract"

# The hard tick ceiling implied by netsim's delivery priority encoding.
TICK_HORIZON = 1 << 20

INT32_MAX = 2**31 - 1

META = torch.device("meta")

# (workload, node_count) pairs audited by the repo-wide run (the JAX
# pass's); the mutants are appended from the model registry.
AUDIT_WORKLOADS: List[Tuple[str, int]] = [
    ("echo", 1), ("echo", 2),
    ("unique-ids", 3),
    ("broadcast", 5),
    ("g-set", 5),
    ("pn-counter", 3),
    ("g-counter", 3),
    ("lin-kv", 5),
    ("txn-list-append", 3),
    ("txn-rw-register", 3),
    ("kafka", 1),
]


def _buggy_workloads() -> List[Tuple[str, int]]:
    from ..models import MUTANTS
    return [(name, 5 if name.startswith("lin-kv") else
             1 if name.startswith("kafka") else 3) for name in MUTANTS]


def _model_path(model) -> str:
    return type(model).__module__.replace(".", os.sep) + ".py"


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _leaf_sig(tree, path: str = "") -> List[Tuple[str, Tuple[int, ...],
                                                  str]]:
    """(path, shape, dtype) per tensor of a tree of NamedTuples, dicts
    and tuples (``None`` leaves are kept as structure)."""
    if tree is None:
        return [(path, None, "None")]
    if isinstance(tree, torch.Tensor):
        return [(path, tuple(tree.shape), _dtype(tree))]
    if isinstance(tree, dict):
        return [s for k in tree for s in _leaf_sig(tree[k],
                                                   f"{path}[{k!r}]")]
    names = getattr(tree, "_fields", None)
    return [s for i, x in enumerate(tree) for s in _leaf_sig(
        x, f"{path}.{names[i]}" if names else f"{path}[{i}]")]


def _structure(tree) -> Any:
    if tree is None or isinstance(tree, torch.Tensor):
        return type(tree).__name__
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(v)) for k, v in tree.items()))
    return (type(tree).__name__, tuple(_structure(x) for x in tree))


def _tree_mismatches(a, b) -> List[str]:
    """Human-readable structural differences between two trees."""
    sa, sb = _structure(a), _structure(b)
    if sa != sb:
        return [f"tree structure changed: {sa} -> {sb}"]
    msgs = []
    for (ka, sha, da), (kb, shb, db) in zip(_leaf_sig(a), _leaf_sig(b)):
        if sha != shb:
            msgs.append(f"leaf {ka or '<root>'} shape {sha} -> {shb}")
        if da != db:
            msgs.append(f"leaf {ka or '<root>'} dtype {da} -> {db}")
    return msgs


def _audit_opts(node_count: int) -> dict:
    return dict(node_count=node_count, concurrency=2, time_limit=0.25,
                rate=50.0, latency=5.0, n_instances=4,
                record_instances=2, journal_instances=0, layout="lead")


def audit_model(model, node_count: int, label: Optional[str] = None,
                opts: Optional[dict] = None) -> List[Finding]:
    """Audit ONE model instance; testable entry point."""
    from .. import rng
    from ..harness import make_sim_config
    from ..runtime import init_carry, make_tick_fn

    label = label or getattr(model, "name", type(model).__name__)
    path = _model_path(model)
    cls = type(model).__name__
    findings: List[Finding] = []

    def flag(rule, name, message, severity=SEV_ERROR, symbol=cls):
        findings.append(Finding(
            rule=rule, name=name, severity=severity, pass_name=PASS_NAME,
            path=path, line=0, symbol=symbol,
            message=f"[{label}] {message}"))

    sim = make_sim_config(model, opts or _audit_opts(node_count))
    cfg = sim.net
    N, C, K, L = cfg.n_nodes, sim.client.n_clients, cfg.inbox_k, cfg.lanes
    try:
        params = model.make_params(N, META)
    except Exception as e:
        flag("CON200", "trace-failure",
             f"make_params({N}) raised: {e!r}")
        return findings

    # --- CON202/CON203: per-hook probes -----------------------------------
    fused = bool(getattr(model, "fused_node", False))
    i32 = torch.int32

    def probe():
        key = rng.prng_key(0, device=META)
        nkeys = rng.split(key[None], N)                       # [1, N, 2]
        state = model.init_state(N, nkeys)                    # [1, N, ...]
        from ..tree import tree_map
        row = tree_map(lambda x: x.reshape((N,) + x.shape[2:]), state)
        node_idx = torch.arange(N, dtype=i32, device=META)
        msg = torch.zeros((N, L), dtype=i32, device=META)
        if fused:
            mkeys = rng.fold_in(nkeys[:, :, None, :],
                                torch.arange(K + 1, device=META))
            slot_jit, tick_jit = model.node_rng(mkeys)
            row_h, out = model.inbox_step(row, node_idx, msg,
                                          slot_jit.reshape(N, K)[:, 0], 0,
                                          cfg)
            outs = out[:, None]   # one reply row per slot (max_out == 1)
            row_t, touts = model.fused_tick(row, node_idx, 0,
                                            tick_jit.reshape(N), cfg)
        else:
            nk = nkeys[0]
            row_h, outs = model.handle(row, node_idx, msg, 0, nk, cfg,
                                       params)
            row_t, touts = model.tick(row, node_idx, 0, nk, cfg, params)
        inv = model.invariants(state, cfg, params)
        ckeys = rng.split(key[None], C)                       # [1, C, 2]
        uniq = torch.zeros((1, C), dtype=i32, device=META)
        op = model.sample_op(ckeys, uniq, cfg, params)
        fop = model.sample_final_op(ckeys, uniq, cfg, params)
        req = model.encode_request(
            op, uniq, torch.arange(C, dtype=i32, device=META), ckeys, cfg,
            params)
        reply = torch.zeros((1, C, L), dtype=i32, device=META)
        if model.ev_vals == 4:
            et, val = model.decode_reply(op, reply, cfg, params)
        else:
            et, val = model.decode_reply_wide(op, reply, cfg, params)
        return dict(row=row, row_h=row_h, row_t=row_t, outs=outs,
                    touts=touts, inv=inv, op=op, fop=fop, req=req,
                    et=et, val=val)

    shapes = None
    try:
        with torch.no_grad():
            shapes = probe()
    except Exception as e:
        flag("CON200", "trace-failure",
             f"evaluation of the model's hooks on meta tensors raised "
             f"{type(e).__name__}: {e}")

    handle_name = "inbox_step" if fused else "handle"
    tick_name = "fused_tick" if fused else "tick"
    if shapes is not None:
        outs, touts = shapes["outs"], shapes["touts"]
        if tuple(outs.shape[1:]) != (model.max_out, L) \
                or outs.dtype != i32:
            flag("CON202", "emit-shape-contract",
                 symbol=f"{cls}.{handle_name}",
                 message=f"{handle_name}() emits {tuple(outs.shape[1:])} "
                         f"{_dtype(outs)} per node, declared (max_out="
                         f"{model.max_out}, lanes={L}) int32")
        if tuple(touts.shape[1:]) != (model.tick_out, L) \
                or touts.dtype != i32:
            flag("CON202", "emit-shape-contract",
                 symbol=f"{cls}.{tick_name}",
                 message=f"{tick_name}() emits {tuple(touts.shape[1:])} "
                         f"{_dtype(touts)} per node, declared (tick_out="
                         f"{model.tick_out}, lanes={L}) int32")
        for which, after in ((handle_name, shapes["row_h"]),
                             (tick_name, shapes["row_t"])):
            for m in _tree_mismatches(shapes["row"], after):
                flag("CON202", "emit-shape-contract",
                     symbol=f"{cls}.{which}",
                     message=f"row tree is not a fixed point of "
                             f"{which}(): {m}")
        inv = shapes["inv"]
        if tuple(inv.shape) != (1,) or inv.dtype != torch.bool:
            flag("CON202", "emit-shape-contract",
                 symbol=f"{cls}.invariants",
                 message=f"invariants() returns {tuple(inv.shape)} "
                         f"{_dtype(inv)} for one instance, expected (1,) "
                         f"bool")
        for which in ("op", "fop"):
            o = shapes[which]
            if tuple(o.shape[2:]) != (model.op_lanes,) or o.dtype != i32:
                name = "sample_final_op" if which == "fop" else "sample_op"
                flag("CON203", "client-lane-contract",
                     symbol=f"{cls}.sample_op",
                     message=f"{name}() returns {tuple(o.shape[2:])} "
                             f"{_dtype(o)} per client, declared "
                             f"op_lanes={model.op_lanes} int32")
        req = shapes["req"]
        if tuple(req.shape[2:]) != (L,) or req.dtype != i32:
            flag("CON203", "client-lane-contract",
                 symbol=f"{cls}.encode_request",
                 message=f"encode_request() returns {tuple(req.shape[2:])} "
                         f"{_dtype(req)} per client, expected wire row "
                         f"({L},) int32")
        want_val = (3,) if model.ev_vals == 4 else (model.ev_vals,)
        val = shapes["val"]
        decoder = ("decode_reply" if model.ev_vals == 4
                   else "decode_reply_wide")
        if tuple(val.shape[2:]) != want_val:
            flag("CON203", "client-lane-contract",
                 symbol=f"{cls}.{decoder}",
                 message=f"{decoder}() value lanes are "
                         f"{tuple(val.shape[2:])}, declared ev_vals="
                         f"{model.ev_vals} implies {want_val}")

    # --- CON201: full-tick carry fixed point ------------------------------
    try:
        with torch.no_grad():
            carry0 = init_carry(model, sim, 0, META)
            tick_fn = make_tick_fn(model, sim, None, META)
            carry1, ys = tick_fn(carry0, 0)
        for m in _tree_mismatches(carry0, carry1):
            flag("CON201", "carry-fixed-point",
                 message=f"carry is not a fixed point of the tick: {m}")
        ev = ys.events
        want_ev = (sim.record_instances, C, 2, 2 + model.ev_vals)
        if tuple(ev.shape) != want_ev:
            flag("CON203", "client-lane-contract",
                 message=f"per-tick event tensor is {tuple(ev.shape)}, "
                         f"declared ev_vals={model.ev_vals} implies "
                         f"{want_ev}")
    except Exception as e:
        flag("CON200", "trace-failure",
             f"the full tick on meta tensors raised "
             f"{type(e).__name__}: {e}")

    # --- CON204: int32 counter bounds at the tick horizon -----------------
    fanout = N * (K * model.max_out + model.tick_out) + C
    netid_max = TICK_HORIZON * fanout
    if netid_max > INT32_MAX:
        flag("CON204", "int32-counter-overflow",
             message=f"NETID stamp t * fanout ({fanout}/tick) reaches "
                     f"{netid_max} at the {TICK_HORIZON}-tick horizon "
                     f"> int32 max — journal send/recv pairing breaks")
    uniq_max = TICK_HORIZON * C + C
    if uniq_max > INT32_MAX:
        flag("CON204", "int32-counter-overflow",
             message=f"client op counter `uniq` (next_msg_id * {C} "
                     f"clients) reaches {uniq_max} at the horizon "
                     f"> int32 max — minted values collide")
    if sim.n_ticks > TICK_HORIZON:
        flag("CON204", "int32-counter-overflow",
             message=f"n_ticks={sim.n_ticks} exceeds the delivery-"
                     f"priority horizon {TICK_HORIZON} — messages past "
                     f"it rank negative and are never delivered")
    # models that partition an int32 id space declare the split
    bits = getattr(model, "flake_counter_bits", None)
    if bits is not None:
        per_node_max = TICK_HORIZON * K * model.max_out
        if per_node_max > (1 << bits):
            flag("CON204", "int32-counter-overflow",
                 message=f"flake counter field is {bits} bits but a "
                         f"node can handle {per_node_max} requests "
                         f"within the {TICK_HORIZON}-tick horizon — "
                         f"ids from different nodes collide past "
                         f"2^{bits} ops")
        if N << bits > INT32_MAX:
            flag("CON204", "int32-counter-overflow",
                 message=f"node_idx << {bits} overflows int32 at "
                         f"node_count={N}")
    return findings


def run_contract_audit(repo_root: str = ".",
                       workloads: Optional[List[Tuple[str, int]]] = None
                       ) -> List[Finding]:
    from ..models import get_model

    specs = list(workloads) if workloads is not None else (
        AUDIT_WORKLOADS + _buggy_workloads())
    findings: List[Finding] = []
    for workload, n in specs:
        try:
            model = get_model(workload, n, "grid")
        except Exception as e:
            findings.append(Finding(
                rule="CON200", name="trace-failure", severity=SEV_ERROR,
                pass_name=PASS_NAME, path="maelstrom_tpu_torch/models/"
                "__init__.py", line=0, symbol="get_model",
                message=f"get_model({workload!r}, {n}) raised: {e!r}"))
            continue
        findings.extend(audit_model(model, n, label=f"{workload}/n={n}"))
    return findings
