"""The tick loop: vectorized protocol instances stepped in lockstep.

Counterpart of ``maelstrom_tpu/tpu/runtime.py``. One *instance* is one
simulated cluster (N server nodes + C clients) with its own message
pool, partition matrix and RNG stream; the runtime stacks
``n_instances`` of them on one axis and steps them all each tick:

    nemesis     : per-instance partition matrices from the schedule
    faults      : the fault planes (faults/): crash and park wipes,
                  edge blocks folded into the partitions
    deliver     : the delivery kernel (kernels/delivery.py)
    node phase  : batched RNG, the per-slot handle (or fused core),
                  the tick hook
    client step : decode replies -> history events; draw/encode new ops
    enqueue     : crash/park send masks, client retarget, then
                  netsim.enqueue with latency, loss and the link planes
    faults      : the snapshot slab update
    invariants, the device verdict lanes (checkers/device_summary.py)
                  and the telemetry fold

Every random draw derives from (master key, purpose, [tick,] instance
id) through ``rng.fold_in``, exactly as in JAX, so an instance's
trajectory is a pure function of (seed, its id) and bit-identical to
the JAX runtime's. Tensors are updated out of place; nothing here is
jitted — PyTorch runs eagerly.

The carry has JAX's two layouts (``SimConfig.layout``). ``lead`` keeps
the instance axis first on every leaf. ``minor`` keeps it last on the
pool ``[S, L, I]``, the node state, the client state, the snapshot slab
and the fuzzed schedules, each contiguous between ticks; the telemetry,
the verdict lanes, the violations and the tick's outputs lead in both.
The minor tick runs the same batch-leading phases on ``movedim`` views
of those leaves and writes their new values back batch-last; delivery
and enqueue read and write the batch-last pool as it lies
(``kernels/delivery.deliver_minor``, ``netsim.enqueue(minor=True)``).
:func:`canonical_carry` gives any carry in the lead orientation, so the
two layouts' trajectories compare bit for bit.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import netsim, rng, wire, xla_math
from .checkers import device_summary
from .faults import engine as faults_engine
from .faults import fuzz as faults_fuzz
from .faults.engine import NO_PLANES, FaultConfig
from .kernels import delivery
from .netsim import NetConfig, NetStats, sum_i32
from .telemetry import recorder as flight
from .telemetry.profiler import phase
from .telemetry.recorder import TelemetryConfig
from .tree import tree_leaves, tree_map

# --- history events ---------------------------------------------------------

# event lanes: [etype, vals[ev_vals], msg_id]
EV_TYPE = 0

EV_NONE = 0
EV_INVOKE = 1
EV_OK = 2
EV_FAIL = 3
EV_INFO = 4

OP_LANES = 4
TYPE_ERROR = 127
_DEFINITE_CODES = (1, 10, 11, 12, 14, 20, 21, 22, 30)

_I32 = torch.int32


class ClientConfig(NamedTuple):
    n_clients: int
    rate: float              # P(new op per idle client per tick)
    timeout_ticks: int
    final_start: int = 1 << 30


class Model:
    """A vectorized node state machine with its client vocabulary.

    Hooks take batched tensors: node-level hooks a flat ``[B, ...]``
    batch of nodes, client-level hooks ``[I, C, ...]``. A model speaks
    one of two node protocols, as in JAX:

    - the legacy one (``fused_node = False``): ``handle`` runs on every
      inbox slot in turn, zero rows included (a model self-gates on the
      message type), emitting ``max_out`` rows per slot, then ``tick``
      emits ``tick_out`` rows; the runtime stamps SRC and ORIGIN;
    - the fused one (``fused_node = True``, Raft): ``node_rng`` draws
      the tick's randomness, ``inbox_step`` runs per slot and
      ``fused_tick`` ends the tick; rows come out stamped.

    ``params`` is the model's static parameter tensor (a topology's
    adjacency matrix), built once per run by ``make_params`` and passed
    to the legacy node hooks, the client hooks and the invariants."""

    name: str = "?"
    body_lanes: int = 6
    max_out: int = 1          # rows emitted per handled message (legacy)
    tick_out: int = 0         # rows emitted by the tick hook (legacy)
    fused_node: bool = False
    idempotent_fs: Tuple[int, ...] = ()
    op_lanes: int = OP_LANES
    ev_vals: int = 4

    def make_params(self, n_nodes: int, device=None):
        return None

    def validate_config(self, cfg: NetConfig) -> None:
        """Raise if the model cannot run on network config ``cfg``."""

    def init_state(self, n_nodes: int, keys: torch.Tensor):
        """Node state for keys ``[I, N, 2]``: leaves ``[I, N, ...]``."""
        raise NotImplementedError

    # --- the legacy protocol ------------------------------------------------

    def handle(self, row, node_idx, msg, t, keys, cfg, params):
        """One inbox slot: ``msg [B, L]``, slot keys ``[B, 2]``; returns
        ``(row', outs [B, max_out, L])``. An all-zero ``msg`` must leave
        the row as it is and emit invalid rows."""
        raise NotImplementedError

    def tick(self, row, node_idx, t, keys, cfg, params):
        """The per-tick hook with keys ``[B, 2]``: ``(row', outs [B,
        tick_out, L])``."""
        return row, torch.zeros((node_idx.shape[0], self.tick_out,
                                 cfg.lanes), dtype=_I32,
                                device=node_idx.device)

    # --- the fused protocol -------------------------------------------------

    def node_rng(self, mkeys):
        raise NotImplementedError

    def inbox_step(self, row, node_idx, msg, jitter, t, cfg):
        raise NotImplementedError

    def fused_tick(self, row, node_idx, t, jitter, cfg, m_bits=None):
        raise NotImplementedError

    # --- crash-restart and membership (faults/): a cold restart -------------

    def snapshot_row(self, row):
        """The durable subset of a row kept in the snapshot slab: all of
        it, unless the model says otherwise."""
        return row

    def restart_row(self, keys, snap, t):
        """Restart rows for node keys ``[I, N, 2]``: the init rows (the
        slab ``snap`` and the tick ``t`` ignored)."""
        return self.init_state(keys.shape[-2], keys)

    def join_row(self, row, m_bits):
        """A joining node's row from its restart rows: unchanged."""
        return row

    def boot_config(self, node_state, m_bits):
        return node_state

    def invariants(self, node_state, cfg: NetConfig, params=None
                   ) -> torch.Tensor:
        """Per-instance bool ``[I]``: True = violated this tick."""
        x = tree_leaves(node_state)[0]
        return torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)

    def summary_step(self, summ, node_state, events, cfg: NetConfig,
                     params=None) -> torch.Tensor:
        """The device verdict lanes' model hook
        (``checkers/device_summary.py``): fold each instance's committed
        frontier, prefix hash and divergence witness into its summary row
        — normally one ``device_summary.fold_frontier`` call. Runs every
        tick for every instance when ``check_mode`` is ``device`` or
        ``both``: ``summ [I, N_LANES]``, ``node_state`` leaves ``[I, N,
        ...]``, ``events [I, C, 2, 2 + ev_vals]`` (slot 0 the
        completions). A nonzero FLAGS lane routes the instance to the
        host farm. Default: the identity (the runtime still folds the
        availability and net counter twins)."""
        return summ

    def sample_op(self, keys, uniq, cfg, params=None):
        raise NotImplementedError

    def sample_final_op(self, keys, uniq, cfg, params=None):
        return self.sample_op(keys, uniq, cfg, params)

    def encode_request(self, op, msg_id, client_idx, keys, cfg,
                       params=None):
        raise NotImplementedError

    def decode_reply(self, op, msg, cfg, params=None):
        """``(etype [I, C], value [I, C, 3])`` of a reply ``msg [I, C,
        L]`` to ``op [I, C, op_lanes]``. Used when ``ev_vals == 4``; the
        completion records ``(op[0], value[0], value[1], value[2])``."""
        raise NotImplementedError

    def decode_reply_wide(self, op, msg, cfg, params=None):
        """Wide-payload models (``ev_vals != 4``): ``(etype [I, C],
        vals [I, C, ev_vals])``, the full value row recorded for the
        completion (the invocation records the op row, padded)."""
        raise NotImplementedError


def op_rows(f: int, a: torch.Tensor) -> torch.Tensor:
    """Client op rows ``[..., 4]``: ``(f, a, 0, 0)`` for an f code and
    an int32 lane ``a [...]``."""
    z = torch.zeros_like(a)
    return torch.stack([torch.full_like(a, f), a, z, z], dim=-1)


def decode_error_reply(msg: torch.Tensor) -> torch.Tensor:
    """Event type of an error reply ``[..., L]``: definite codes fail,
    others are indeterminate."""
    code = msg[..., wire.BODY]
    definite = torch.zeros_like(code, dtype=torch.bool)
    for c in _DEFINITE_CODES:
        definite = definite | (code == c)
    return torch.where(definite, EV_FAIL, EV_INFO).to(_I32)


def pad_op(op: torch.Tensor, V: int) -> torch.Tensor:
    """Op rows ``[..., op_lanes]`` as event value rows ``[..., V]``:
    truncated, or zero-padded on the right."""
    if op.shape[-1] >= V:
        return op[..., :V]
    return torch.nn.functional.pad(op, (0, V - op.shape[-1]))


# --- client machine -----------------------------------------------------------


class ClientState(NamedTuple):
    status: torch.Tensor       # [I, C] 0 idle / 1 waiting
    op: torch.Tensor           # [I, C, OP_LANES]
    msg_id: torch.Tensor       # [I, C]
    next_msg_id: torch.Tensor  # [I, C]
    invoked: torch.Tensor      # [I, C] tick of invocation

    @staticmethod
    def init(I: int, C: int, op_lanes: int = OP_LANES, device=None):
        z = lambda *s: torch.zeros((I, C) + s, dtype=_I32, device=device)
        return ClientState(status=z(), op=z(op_lanes),
                           msg_id=torch.full((I, C), -1, dtype=_I32,
                                             device=device),
                           next_msg_id=z(), invoked=z())


def client_step(model: Model, cs: ClientState, inbox_clients: torch.Tensor,
                t: int, key: torch.Tensor, cfg: NetConfig,
                ccfg: ClientConfig, params=None):
    """One tick for all clients of all instances. ``inbox_clients [I, C,
    K, L]``, ``key [I, 2]``. Returns ``(cs', requests [I, C, L], events
    [I, C, 2, 2 + ev_vals])``: slot 0 = completion, slot 1 = invocation.
    A model with ``ev_vals == 4`` decodes replies with ``decode_reply``
    (the completion records ``(f, value)``), a wider one with
    ``decode_reply_wide``; an error reply echoes the op row. Op rows
    enter events through :func:`pad_op`."""
    I, C = cs.status.shape
    V = model.ev_vals
    dev = cs.status.device
    events = torch.zeros((I, C, 2, 2 + V), dtype=_I32, device=dev)

    # completions: a reply matching the outstanding msg id
    msgs = inbox_clients
    match = ((msgs[..., wire.VALID] == 1)
             & (msgs[..., wire.REPLYTO] == cs.msg_id[..., None])
             & (cs.status[..., None] == 1))                  # [I, C, K]
    has_reply = match.any(dim=-1)
    idx = match.to(_I32).argmax(dim=-1)
    reply = msgs.gather(2, idx[..., None, None].expand(
        I, C, 1, msgs.shape[-1]))[:, :, 0]                     # [I, C, L]

    is_err = reply[..., wire.TYPE] == TYPE_ERROR
    if V == 4:
        et_ok, val_ok = model.decode_reply(cs.op, reply, cfg, params)
        value = torch.where(is_err[..., None], torch.zeros_like(val_ok),
                            val_ok)
        value_r = torch.cat([cs.op[..., 0:1], value], dim=-1)  # [I, C, 4]
    else:
        et_ok, vals_ok = model.decode_reply_wide(cs.op, reply, cfg, params)
        # errors echo the op row (the invocation's value)
        value_r = torch.where(is_err[..., None], pad_op(cs.op, V), vals_ok)
    etype_r = torch.where(is_err, decode_error_reply(reply), et_ok)

    timed_out = ((cs.status == 1) & ~has_reply
                 & ((t - cs.invoked) >= ccfg.timeout_ticks))
    idem = torch.zeros_like(timed_out)
    for f in model.idempotent_fs:
        idem = idem | (cs.op[..., 0] == f)
    etype_t = torch.where(idem, EV_FAIL, EV_INFO).to(_I32)

    completed = has_reply | timed_out
    comp_etype = torch.where(has_reply, etype_r, etype_t)
    comp_vals = torch.where(has_reply[..., None], value_r,
                            pad_op(cs.op, V))
    events[:, :, 0, EV_TYPE] = torch.where(completed, comp_etype,
                                           torch.zeros_like(comp_etype))
    events[:, :, 0, 1:1 + V] = comp_vals
    events[:, :, 0, 1 + V] = cs.msg_id
    status = torch.where(completed, torch.zeros_like(cs.status), cs.status)

    # new invocations from idle clients: k_rate, k_ops, k_enc = split(key,
    # 3); the rate draw and both per-client key splits share one call
    blocks = rng.split(rng.split(key, 3), C)                  # [I, 3, C, 2]
    idle = status == 0
    fire = idle & (rng.uniform_from_bits(rng.bits_of_split(blocks[:, 0]))
                   < xla_math.f32(ccfg.rate))
    op_keys = blocks[:, 1]                                     # [I, C, 2]
    cidx = torch.arange(C, dtype=_I32, device=dev)
    uniq = cs.next_msg_id * C + cidx
    if t >= ccfg.final_start:
        new_ops = model.sample_final_op(op_keys, uniq, cfg, params)
    else:
        new_ops = model.sample_op(op_keys, uniq, cfg, params)
    op = torch.where(fire[..., None], new_ops, cs.op)
    msg_id = torch.where(fire, cs.next_msg_id, cs.msg_id)
    next_msg_id = torch.where(fire, cs.next_msg_id + 1, cs.next_msg_id)
    invoked = torch.where(fire, torch.full_like(cs.invoked, t), cs.invoked)
    status = torch.where(fire, torch.ones_like(status), status)

    reqs = model.encode_request(op, msg_id, cidx, blocks[:, 2], cfg,
                                params)
    client_ids = cfg.n_nodes + cidx
    reqs[..., wire.VALID] = fire.to(_I32)
    reqs[..., wire.SRC] = client_ids
    reqs[..., wire.ORIGIN] = client_ids
    reqs[..., wire.MSGID] = msg_id

    events[:, :, 1, EV_TYPE] = torch.where(fire, EV_INVOKE, EV_NONE).to(_I32)
    events[:, :, 1, 1:1 + V] = pad_op(op, V)
    events[:, :, 1, 1 + V] = msg_id
    return (ClientState(status=status, op=op, msg_id=msg_id,
                        next_msg_id=next_msg_id, invoked=invoked),
            reqs, events)


# --- nemesis ------------------------------------------------------------------


class NemesisConfig(NamedTuple):
    enabled: bool = False
    interval: int = 50         # ticks between phase flips
    kind: str = "random-halves"
    stop_tick: int = 1 << 30   # final heal at/after this tick
    schedule: tuple = ()       # kind="scripted": ((until_tick, ((dst,
                               # src), ...)), ...) ordered by until_tick

NEMESIS_KINDS = ("random-halves", "isolated-node", "majorities-ring",
                 "scripted")


def scripted_isolate_groups(until_tick: int, groups, n_nodes: int
                            ) -> tuple:
    """One scripted-schedule phase where traffic is allowed only WITHIN
    each group in ``groups``; every cross-group server pair (and every
    pair with a node in no group) is blocked. Returns ``(until_tick,
    pairs)`` for :attr:`NemesisConfig.schedule`."""
    member = {}
    for gi, g in enumerate(groups):
        for node in g:
            member[node] = gi
    pairs = []
    for dst in range(n_nodes):
        for src in range(n_nodes):
            if dst == src:
                continue
            if member.get(dst) is None or member.get(src) is None \
                    or member[dst] != member[src]:
                pairs.append((dst, src))
    return (until_tick, tuple(pairs))


def partition_matrix(nem: NemesisConfig, cfg: NetConfig, t: int,
                     instance_keys: torch.Tensor) -> torch.Tensor:
    """Partition matrices ``[I, NT, NT]`` at tick ``t``: alternating
    heal/partition phases every ``interval`` ticks with a fresh random
    grudge each phase — a halving of the server nodes
    (``random-halves``), one node cut off from the others
    (``isolated-node``), or each node seeing a distinct majority around a
    random ring (``majorities-ring``) — or a fixed per-phase schedule
    (``scripted``). Clients are never cut."""
    NT, n = cfg.n_total, cfg.n_nodes
    I = instance_keys.shape[0]
    dev = instance_keys.device
    none = torch.zeros((I, NT, NT), dtype=torch.bool, device=dev)
    if not nem.enabled:
        return none
    if nem.kind not in NEMESIS_KINDS:
        raise ValueError(f"nemesis kind {nem.kind!r} is not ported "
                         f"(ported: {', '.join(NEMESIS_KINDS)})")
    server = torch.arange(NT, device=dev) < n
    smask = server[:, None] & server[None, :]
    if nem.kind == "scripted":
        if t >= nem.stop_tick:
            return none
        P = len(nem.schedule)
        untils = np.array([u for u, _ in nem.schedule]
                          + [np.iinfo(np.int32).max], dtype=np.int64)
        phase_i = min(int(np.searchsorted(untils, t, side="right")), P)
        mat = torch.zeros((NT, NT), dtype=torch.bool, device=dev)
        if phase_i < P:
            for dst, src in nem.schedule[phase_i][1]:
                mat[dst, src] = True
        return (mat & smask)[None].expand(I, NT, NT).contiguous()
    phase = t // nem.interval
    if not (phase % 2 == 1 and t < nem.stop_tick):
        return none
    key = rng.fold_in(instance_keys, phase)
    if nem.kind == "isolated-node":
        victim = rng.randint(key, (), 0, n)                    # [I]
        isolated = torch.arange(NT, device=dev) == victim[:, None]
        blocked = isolated[:, :, None] ^ isolated[:, None, :]
    elif nem.kind == "majorities-ring":
        perm = rng.permutation(key, n).long()                  # [I, n]
        pos = torch.zeros((I, NT), dtype=_I32, device=dev).scatter(
            1, perm, torch.arange(n, dtype=_I32, device=dev).expand(I, n))
        maj = n // 2 + 1
        dist = torch.remainder(pos[:, None, :] - pos[:, :, None], n)
        blocked = ~((dist <= maj // 2) | (dist >= n - (maj - 1) // 2))
    else:  # random-halves
        side = rng.bernoulli(key, 0.5, (NT,))                  # [I, NT]
        blocked = side[:, :, None] != side[:, None, :]
    return blocked & smask[None]


# --- node phase ---------------------------------------------------------------


def stamp(outs: torch.Tensor, node_idx: torch.Tensor) -> torch.Tensor:
    """The legacy driver's stamp of emitted rows ``outs [B, M, L]``
    (in place): SRC becomes the emitting node where it is still 0 (a
    model copies a client's SRC when it proxies), ORIGIN always."""
    src = outs[..., wire.SRC]
    outs[..., wire.SRC] = torch.where(src == 0, node_idx[:, None], src)
    outs[..., wire.ORIGIN] = node_idx[:, None]
    return outs


def node_phase(model: Model, node_state, inbox_nodes: torch.Tensor, t: int,
               keys: torch.Tensor, cfg: NetConfig,
               t_nodes: Optional[torch.Tensor] = None,
               m_bits: Optional[torch.Tensor] = None, params=None):
    """All nodes of all instances handle their inboxes, then run the
    tick hook. ``node_state`` leaves ``[I, N, ...]``, ``inbox_nodes
    [I, N, K, L]``, ``keys [I, 2]``. ``t_nodes [I, N]`` (clock-skew
    lane) replaces the global ``t`` with each node's local clock;
    ``m_bits [I]`` (membership lane) is the target member bitmask, read
    by fused models only. Without them every node sees the Python int
    ``t`` and the full cluster, as before the fault lanes. Node ``n``'s
    slot ``i`` draws from ``fold_in(split(keys, N)[n], i)`` and its tick
    hook from slot ``K``'s key. Returns ``(state', outs [I, N * M, L])``
    with each node's ``M`` rows in the JAX order: per slot its reply
    rows, then the tick hook's rows."""
    I, N, K, L = inbox_nodes.shape
    B = I * N
    dev = inbox_nodes.device
    nkeys = rng.split(keys, N)                                 # [I, N, 2]
    mkeys = rng.fold_in(nkeys[:, :, None, :],
                        torch.arange(K + 1, device=dev))       # [I,N,K+1,2]
    row = tree_map(lambda x: x.reshape((B,) + x.shape[2:]), node_state)
    node_idx = torch.arange(N, dtype=_I32, device=dev).repeat(I)
    msgs = inbox_nodes.reshape(B, K, L)
    if t_nodes is not None:
        t = t_nodes.reshape(B)
    outs = []
    if model.fused_node:
        slot_jit, tick_jit = model.node_rng(mkeys)
        slot_jit = slot_jit.reshape(B, K)
        if m_bits is not None:
            m_bits = m_bits[:, None].expand(I, N).reshape(B)
        for k in range(K):
            row, out = model.inbox_step(row, node_idx, msgs[:, k],
                                        slot_jit[:, k], t, cfg)
            outs.append(out[:, None])
        row, outs_t = model.fused_tick(row, node_idx, t,
                                       tick_jit.reshape(B), cfg,
                                       m_bits=m_bits)
        outs = torch.cat(outs + [outs_t], dim=1)
    else:
        mkeys = mkeys.reshape(B, K + 1, 2)
        for k in range(K):
            # handle self-gates on the zero rows of empty slots
            row, out = model.handle(row, node_idx, msgs[:, k], t,
                                    mkeys[:, k], cfg, params)
            outs.append(out)
        row, outs_t = model.tick(row, node_idx, t, mkeys[:, K], cfg,
                                 params)
        outs = stamp(torch.cat(outs + [outs_t], dim=1), node_idx)
    state = tree_map(lambda x: x.reshape((I, N) + x.shape[1:]), row)
    return state, outs.reshape(I, -1, L)


# --- the tick loop ------------------------------------------------------------


class SimConfig(NamedTuple):
    net: NetConfig
    client: ClientConfig
    nemesis: NemesisConfig
    n_instances: int
    n_ticks: int
    record_instances: int
    journal_instances: int = 0   # instances whose sent rows and inboxes
                                 # the tick returns (the per-message
                                 # journal); needs the NETID lane
    layout: str = "minor"        # the instance axis of the carry: "minor"
                                 # last, "lead" first (the JAX default;
                                 # make_sim_config resolves "auto")
    telemetry: TelemetryConfig = TelemetryConfig()
    faults: FaultConfig = FaultConfig()   # the fault plan or fuzz
                                          # distribution (faults/)
    check_summary: bool = False  # the device verdict lanes
                                 # (check_mode device or both)


class TickOutputs(NamedTuple):
    """What a tick returns besides the carry; a field is None when its
    instance count is zero."""
    events: Optional[torch.Tensor]         # [R, C, 2, 2 + ev_vals]
    journal_sends: Optional[torch.Tensor]  # [J, M, L] rows sent
    journal_recvs: Optional[torch.Tensor]  # [J, NT, K, L] delivered


class Carry(NamedTuple):
    """The whole simulation state. The shapes are the lead layout's; in
    the minor layout ``pool``, ``node_state``, ``client_state``,
    ``snapshots`` and ``fault_sched`` carry the instance axis last."""
    pool: torch.Tensor          # [I, S, L]  (minor: [S, L, I])
    node_state: Any             # a tensor or row tuple, leaves [I, N, ...]
    client_state: ClientState   # [I, C, ...]
    stats: NetStats             # int32 scalars (fleet sums)
    violations: torch.Tensor    # [I] ticks each instance violated
    key: torch.Tensor           # the constant master key [2]
    telemetry: Any = None       # flight recorder, None when disabled
    snapshots: Any = None       # snapshot slab: Model.snapshot_row's
                                # lanes [I, N, ...] (a dict for Raft); None
                                # unless a crash or membership lane runs
    fault_sched: Any = None     # faults.fuzz.FaultSchedule [I, ...],
                                # drawn at init; None unless fuzzing
    check_summary: Any = None   # the device verdict lanes [I, N_LANES]
                                # int32; None unless sim.check_summary


# RNG purpose tags (runtime.py in the JAX package)
_RNG_INIT = 0
_RNG_NEMESIS = 1
_RNG_NODE = 2
_RNG_CLIENT = 3
_RNG_ENQUEUE = 4
_RNG_RESTART = 5      # crash-restart and join re-init draws
_RNG_FAULTS = faults_fuzz.RNG_PURPOSE   # = 6: the fuzzed schedules


def instance_keys(master: torch.Tensor, purpose: int,
                  instance_ids: torch.Tensor, t: Optional[int] = None
                  ) -> torch.Tensor:
    """Per-instance keys ``[I, 2]``: fold in purpose, then tick (when
    given), then each instance id."""
    k = rng.fold_in(master, purpose)
    if t is not None:
        k = rng.fold_in(k, t)
    return rng.fold_in(k[None, :], instance_ids)


_TICK_PURPOSES = (_RNG_NEMESIS, _RNG_NODE, _RNG_CLIENT, _RNG_ENQUEUE)


def tick_keys(master: torch.Tensor, instance_ids: torch.Tensor, t: int,
              restart: bool = False) -> torch.Tensor:
    """The tick's instance keys for all four purposes in three batched
    calls: ``[4, I, 2]`` in ``_TICK_PURPOSES`` order, and with
    ``restart`` a fifth row for ``_RNG_RESTART``. The nemesis keys skip
    the tick fold (a grudge holds for its whole phase); the others
    equal ``instance_keys(master, purpose, ids, t)``."""
    # _TICK_PURPOSES and _RNG_RESTART are the contiguous range 1..5
    last = _RNG_RESTART if restart else _RNG_ENQUEUE
    kp = rng.fold_in(master[None, :],
                     torch.arange(_RNG_NEMESIS, last + 1,
                                  device=master.device))       # [4|5, 2]
    kt = torch.cat([kp[:1], rng.fold_in(kp[1:], t)], dim=0)
    return rng.fold_in(kt[:, None, :], instance_ids[None, :])


def default_instance_ids(sim: SimConfig, device=None) -> torch.Tensor:
    return torch.arange(sim.n_instances, dtype=_I32, device=device)


def init_carry(model: Model, sim: SimConfig, seed: int, device=None,
               instance_ids: Optional[torch.Tensor] = None) -> Carry:
    I = sim.n_instances
    cfg = sim.net
    key = rng.prng_key(seed, device=device)
    if instance_ids is None:
        instance_ids = default_instance_ids(sim, device)
    ikeys = instance_keys(key, _RNG_INIT, instance_ids)
    node_state = model.init_state(cfg.n_nodes, rng.split(ikeys, cfg.n_nodes))
    fx = sim.faults
    # a plan's phase-0 members provision the boot config before the slab
    # seeds, so a restart restores the same provisioning; fuzzed
    # membership starts from the full cluster, init_state's default
    if fx.has_members and not fx.has_fuzz:
        node_state = model.boot_config(
            node_state, sum(1 << v for v in fx.members[0]))
    snapshots = (model.snapshot_row(node_state)
                 if fx.has_crash or fx.has_members else None)
    fault_sched = (faults_fuzz.draw_schedule(
        instance_keys(key, _RNG_FAULTS, instance_ids), fx, cfg.n_nodes)
        if fx.has_fuzz else None)
    return carry_from_canonical(Carry(
        pool=torch.zeros((I, cfg.pool_slots, cfg.lanes), dtype=_I32,
                         device=device),
        node_state=node_state,
        client_state=ClientState.init(I, sim.client.n_clients,
                                      model.op_lanes, device),
        stats=NetStats.zeros(device),
        violations=torch.zeros((I,), dtype=_I32, device=device),
        key=key,
        telemetry=flight.init_telemetry(I, sim.telemetry, device),
        snapshots=snapshots,
        fault_sched=fault_sched,
        check_summary=(device_summary.init_summary(I, device)
                       if sim.check_summary else None),
    ), sim)


def _to_lead(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(-1, 0)


def _to_minor(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(0, -1).contiguous()


def canonical_carry(carry: Carry, sim: SimConfig) -> Carry:
    """The carry with the instance axis leading on every batched leaf,
    whatever ``sim.layout`` is: views, no copy, values untouched (JAX's
    ``canonical_carry``)."""
    if sim.layout != "minor":
        return carry
    return carry._replace(
        pool=_to_lead(carry.pool),
        node_state=tree_map(_to_lead, carry.node_state),
        client_state=tree_map(_to_lead, carry.client_state),
        snapshots=tree_map(_to_lead, carry.snapshots),
        fault_sched=tree_map(_to_lead, carry.fault_sched))


def carry_from_canonical(carry: Carry, sim: SimConfig) -> Carry:
    """The inverse of :func:`canonical_carry`: a lead-oriented carry in
    ``sim.layout``, every batch-last leaf contiguous."""
    if sim.layout != "minor":
        return carry
    return carry._replace(
        pool=_to_minor(carry.pool),
        node_state=tree_map(_to_minor, carry.node_state),
        client_state=tree_map(_to_minor, carry.client_state),
        snapshots=tree_map(_to_minor, carry.snapshots),
        fault_sched=tree_map(_to_minor, carry.fault_sched))


def _update_telemetry(tel, sim: SimConfig, t: int, events, invoked_prev,
                      pool_occ, inbox, deltas, part_active, violated):
    if tel is None:
        return None
    N = sim.net.n_nodes
    n_sent, n_del, n_dropp, n_lost, n_ovf = deltas
    serv = inbox[:, :N]
    n_del_serv = sum_i32((serv[..., wire.VALID] == 1)
                         & (serv[..., wire.ORIGIN] < N), dim=(1, 2))
    return flight.record_tick(
        tel, t, sim.telemetry,
        n_sent=n_sent, n_del=n_del, n_del_serv=n_del_serv,
        n_dropp=n_dropp, n_lost=n_lost, n_ovf=n_ovf,
        pool_occ=pool_occ, part_active=part_active, violated=violated,
        ok_mask=events[:, :, 0, EV_TYPE] == EV_OK,
        invoke_mask=events[:, :, 1, EV_TYPE] == EV_INVOKE,
        lat=t - invoked_prev)


def make_tick_fn(model: Model, sim: SimConfig,
                 instance_ids: Optional[torch.Tensor] = None,
                 device=None) -> Callable:
    """The tick: ``tick_fn(carry, t) -> (carry', outputs)`` with
    :class:`TickOutputs`: the recorded instances' events ``[R, C, 2, 2 +
    ev_vals]`` and the journaled instances' sent rows and inboxes. The
    model's static params are built here, once for the run. In the minor
    layout the phases see ``movedim`` views of the batch-last leaves,
    the pool is delivered and refilled batch-last, and each new
    batch-last leaf is written back contiguous in the phase that made
    it."""
    params = model.make_params(sim.net.n_nodes, device)
    cfg = sim.net
    ccfg = sim.client
    fx = sim.faults
    N = cfg.n_nodes
    L = cfg.lanes
    I = sim.n_instances
    if instance_ids is None:
        instance_ids = default_instance_ids(sim, device)
    tables = (faults_engine.plan_tables(fx, cfg, device)
              if fx.active and not fx.has_fuzz else None)
    wipes = fx.has_crash or fx.has_members
    minor = sim.layout == "minor"
    to_lead = (lambda tree: tree_map(_to_lead, tree)) if minor else \
        (lambda tree: tree)
    to_minor = (lambda tree: tree_map(_to_minor, tree)) if minor else \
        (lambda tree: tree)
    deliver = delivery.deliver_minor if minor else delivery.deliver

    def fault_planes(carry: Carry, t: int):
        if fx.has_fuzz:
            # a lane configured at rate 0 stays in the tick
            return faults_fuzz.schedule_planes(to_lead(carry.fault_sched),
                                               fx, cfg, t)
        if tables is not None:
            return faults_engine.tick_planes(fx, tables, t, I)
        return NO_PLANES

    # the phases (the JAX runtime's named scopes) are torch.profiler
    # ranges, and the device profiler's marks while a capture is armed
    def tick_fn(carry: Carry, t: int):
        key = carry.key
        with phase("nemesis"):
            keys = tick_keys(key, instance_ids, t, restart=wipes)
            nem_keys, node_keys, client_keys, enq_keys = keys[:4]
            partitions = partition_matrix(sim.nemesis, cfg, t, nem_keys)

        node_state = to_lead(carry.node_state)
        snapshots = to_lead(carry.snapshots)
        m_bits = park = None
        with phase("faults"):
            planes = fault_planes(carry, t)
            if planes.member is not None:
                m_bits = faults_engine.member_bits(planes.member)
                # every non-member tick and the join tick itself
                park = ~(planes.member & planes.member_prev)
            if wipes:
                # crashed nodes are held in reset, non-(stable-)members
                # parked at their join rows, both rebuilt from the slab
                fresh = faults_engine.restart_rows(
                    model, snapshots,
                    t if planes.t_nodes is None else planes.t_nodes,
                    keys[4], N)
                if planes.crash is not None:
                    node_state = faults_engine.wipe_crashed(
                        node_state, fresh, planes.crash)
                if park is not None:
                    node_state = faults_engine.wipe_parked(
                        model, node_state, fresh, park, m_bits)
            if planes.block is not None:
                # edge blocks and crashed or parked receivers
                partitions = partitions | planes.block

        with phase("deliver"):
            pool, inbox, n_del, n_dropp = deliver(carry.pool, partitions,
                                                  t, cfg)

        with phase("node_phase"):
            node_state, node_outs = node_phase(
                model, node_state, inbox[:, :N], t, node_keys, cfg,
                t_nodes=planes.t_nodes, m_bits=m_bits, params=params)
            node_state_out = to_minor(node_state)

        client_in = to_lead(carry.client_state)
        invoked_prev = client_in.invoked
        with phase("client_step"):
            client_state, reqs, events = client_step(
                model, client_in, inbox[:, N:], t, client_keys, cfg, ccfg,
                params)
            client_state = to_minor(client_state)

        with phase("enqueue"):
            sends = None if planes.crash is None else ~planes.crash
            if planes.member is not None:
                sends = (planes.member if sends is None
                         else sends & planes.member)
                # clients only target nodes that exist
                reqs = faults_engine.retarget_clients(reqs, planes.member)
            if sends is not None:
                # crashed and parked nodes send nothing
                per_node = node_outs.view(I, N, -1, L)
                per_node[..., wire.VALID] *= sends.to(_I32)[:, :, None]
            outs = torch.cat([node_outs, reqs], dim=1)
            if cfg.netid:
                # network-unique message ids, allocated at send time
                M = outs.shape[1]
                outs[:, :, cfg.netid_lane] = (
                    t * M + torch.arange(M, dtype=_I32, device=outs.device))
            pool, n_sent, n_lost, n_ovf = netsim.enqueue(
                pool, outs, t, enq_keys, cfg, edge_delay=planes.delay,
                edge_loss_pm=planes.loss_pm, minor=minor)

        if snapshots is not None:
            with phase("faults"):
                # held nodes never overwrite their slab row: it keeps the
                # state the next restart or join restores
                hold = planes.crash
                if park is not None:
                    hold = park if hold is None else hold | park
                snapshots = to_minor(faults_engine.update_snapshots(
                    model, node_state, snapshots, hold, t,
                    fx.snapshot_every))

        with phase("telemetry"):
            s = carry.stats
            stats = NetStats(
                sent=s.sent + sum_i32(n_sent),
                delivered=s.delivered + sum_i32(n_del),
                dropped_partition=s.dropped_partition + sum_i32(n_dropp),
                dropped_loss=s.dropped_loss + sum_i32(n_lost),
                dropped_overflow=s.dropped_overflow + sum_i32(n_ovf))
            violated = model.invariants(node_state, cfg, params)
        with phase("check_summary"):
            # the full fleet's events, before the [:R] slice below
            summ = device_summary.update_summary(
                model, carry.check_summary, node_state, events, n_sent,
                n_del, cfg, params)
        with phase("telemetry"):
            # each layout sums its own VALID lane: no [I, S, L] copy
            tel = _update_telemetry(
                carry.telemetry, sim, t, events, invoked_prev,
                (sum_i32(pool[:, wire.VALID] & 1, dim=0) if minor
                 else netsim.pool_occupancy(pool)), inbox,
                (n_sent, n_del, n_dropp, n_lost, n_ovf),
                partitions.any(dim=2).any(dim=1), violated)
        new_carry = Carry(pool=pool, node_state=node_state_out,
                          client_state=client_state, stats=stats,
                          violations=carry.violations + violated.to(_I32),
                          key=key, telemetry=tel, snapshots=snapshots,
                          fault_sched=carry.fault_sched,
                          check_summary=summ)
        R, J = sim.record_instances, sim.journal_instances
        # copies: a view would hold the whole fleet's rows until the
        # chunk's journal is stacked
        return new_carry, TickOutputs(
            events=events[:R] if R > 0 else None,
            journal_sends=outs[:J].clone() if J > 0 else None,
            journal_recvs=inbox[:J].clone() if J > 0 else None)

    return tick_fn


def run_sim(model: Model, sim: SimConfig, seed: int, device=None,
            instance_ids: Optional[torch.Tensor] = None
            ) -> Tuple[Carry, TickOutputs]:
    """Run the whole horizon in one loop; returns the final carry and
    :class:`TickOutputs` stacked on a leading tick axis."""
    carry = init_carry(model, sim, seed, device, instance_ids)
    tick_fn = make_tick_fn(model, sim, instance_ids, device)
    ys = []
    with torch.no_grad():
        for t in range(sim.n_ticks):
            carry, y = tick_fn(carry, t)
            ys.append(y)
    return carry, TickOutputs(*(
        None if xs[0] is None else torch.stack(xs) for xs in zip(*ys)))
