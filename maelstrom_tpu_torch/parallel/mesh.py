"""Multi-GPU scaling: shard the instance batch over devices.

Counterpart of ``maelstrom_tpu/parallel/mesh.py``. Protocol instances
are independent, so the parallelism is data parallelism along the
instance axis: each shard simulates its own block of clusters on its
own device, and the only cross-shard traffic is the sum of the five
NetStats counters and of the telemetry series, done on the host after
the shards' work (the JAX executor's ``psum``; int32, wrapping alike).

Shard assignment is round-robin over GLOBAL instance ids under one
master key: shard *s* of *S* simulates global ids ``{j*S + s}``, and
every draw folds ``(purpose, tick, global id)`` into the one
``PRNGKey(seed)``. An instance's trajectory is therefore a pure function
of ``(seed, global id)``, whatever the shard count — which is what lets
a checkpoint written at S shards resume at S' shards bit-identically
(``campaign/checkpoint.reshard_carry``). The recorded set is the first
R locals of every shard, global ids ``{0 .. R*S-1}`` for any S.
Per-shard outputs are joined shard-major and reordered to global-id
order on the host (:func:`deinterleave`).

Each shard has its own carry, instance ids and tick function on its
device, and its work stays on that device's current stream; the
delivery kernel launches once per tick on every shard's device. The
shards' chunks are issued one after another from the calling thread:
on a card the ops return once queued, so shard s+1 is issued while
shard s's kernels run. (One issuing thread per shard was slower on the
card: the threads hand the interpreter lock to each other at every op;
``PERF.md``.)

Over several processes (``multihost``) each process issues the shards
of its own mesh row, with their global shard indices and global ids, and
the places where the shards are joined all-gather every process's
partials in rank order first (:func:`_all_rows`): the chunk snapshots
and scans, the events, and the final wire. Every rank returns the same
global outputs as a one-process run at the same S; rank 0 alone writes
the heartbeat, calls ``checkpoint_cb`` and fills ``perf``.

The wire carry — what a checkpoint holds — is the JAX executor's: every
leaf of a shard's carry leads with a shard-divisible axis (the NetStats
slots ``[1]``, the key ``[1, 2]``, the telemetry series ``[1, ...]``),
and the global wire is the shards' wires joined shard-major, leaf by
leaf, in ``convert.carry_leaves`` order.
"""

from __future__ import annotations

import contextlib
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import convert
from ..netsim import NetStats
from ..pipeline import (DEFAULT_SCAN_TOP_K, finish_fetch, resume_plans,
                        plan_chunks, scan_source, start_fetch,
                        violation_scan)
from ..runtime import (Carry, Model, SimConfig, canonical_carry,
                       carry_from_canonical, init_carry, make_tick_fn)
from ..telemetry.recorder import Telemetry
from ..telemetry.stream import (combine_shard_scans, scan_to_violation,
                                scan_to_violations, stats_vec_to_net)

AXIS = "instances"

# reshard kinds of the wire-carry leaves (recorded per leaf in a sharded
# checkpoint, so campaign/checkpoint.reshard_carry can re-chunk a wire
# written at S shards onto S' shards; see wire_leaf_kinds)
SHARD_LEAF_INSTANCE = "instance"   # chunks along the global instance axis
SHARD_LEAF_SUM = "sum"             # one additive partial-sum slot per shard
SHARD_LEAF_KEY = "key"             # the replicated master RNG key

class Mesh:
    """Devices in row-major order over named axes. A device may repeat:
    ``[cpu] * 4`` or ``[cuda:0] * 2`` puts several shards on one device,
    the counterpart of JAX's virtual CPU mesh. Shard ``s`` runs on
    ``devices[s]``; its flat index is row-major over the axes.

    A mesh over ``process_count`` processes (``multihost.
    make_hybrid_mesh``) has one row per process: this process issues the
    shards of row ``process_index`` (:attr:`local_shards`), and the
    other rows name the other processes' devices. ``size`` is the global
    shard count either way."""

    def __init__(self, devices: Sequence, axis_names=(AXIS,),
                 shape: Optional[Sequence[int]] = None,
                 process_index: int = 0, process_count: int = 1):
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        self.shape = (tuple(int(n) for n in shape) if shape is not None
                      else (len(self.devices),))
        if len(self.shape) != len(self.axis_names) \
                or int(np.prod(self.shape)) != len(self.devices) \
                or not self.devices:
            raise ValueError(f"mesh of shape {self.shape} over axes "
                             f"{self.axis_names} cannot hold "
                             f"{len(self.devices)} devices")
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        if self.process_count > 1 and self.shape[0] != self.process_count:
            raise ValueError(f"a mesh over {self.process_count} processes "
                             f"needs one row per process, not shape "
                             f"{self.shape}")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local_shards(self) -> range:
        """The global indices of the shards this process issues."""
        per = self.size // self.process_count
        return range(self.process_index * per,
                     (self.process_index + 1) * per)


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the first ``n_devices`` (default: all) visible CUDA
    devices, or over ``devices`` as given (repeats allowed: several
    shards on one device). Nothing falls back to the CPU: with no card,
    CPU shards must be asked for (``devices=[torch.device("cpu")] *
    S``)."""
    if devices is None:
        n_vis = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if n_vis == 0:
            raise RuntimeError(
                "make_mesh: no CUDA device is visible; pass "
                "devices=[torch.device('cpu')] * S for a mesh of CPU "
                "shards")
        devices = [torch.device("cuda", i) for i in range(n_vis)]
    devices = list(devices)
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested a {n_devices}-device mesh but only "
                f"{len(devices)} devices are visible (pass devices= to "
                f"put several shards on one device)")
        devices = devices[:n_devices]
    return Mesh(devices)


def _seed32(seed: int) -> int:
    """Wrap a Python-int seed into int32 range, as every sharded path
    and the unsharded oracle derive their key from it."""
    return (int(seed) + 2**31) % 2**32 - 2**31


def shard_instance_ids(n_instances: int, n_shards: int) -> np.ndarray:
    """``[n_shards, n_instances]`` GLOBAL instance ids per shard under
    the round-robin assignment: shard ``s`` simulates ``{j * n_shards +
    s : j < n_instances}`` (``n_instances`` is PER SHARD)."""
    return np.arange(n_shards * n_instances, dtype=np.int32).reshape(
        n_instances, n_shards).T.copy()


def deinterleave(x, n_shards: int, axis: int = 0) -> np.ndarray:
    """Reorder a shard-major joined axis (shard s's block of I locals at
    ``[s*I, (s+1)*I)``; local j holding global id ``j*S + s``) into
    global-id order, on the host."""
    x = np.asarray(x)
    if n_shards <= 1:
        return x
    x = np.moveaxis(x, axis, 0)
    s = int(n_shards)
    t = x.shape[0]
    x = x.reshape((s, t // s) + x.shape[1:]).swapaxes(0, 1).reshape(
        (t,) + x.shape[1:])
    return np.moveaxis(x, 0, axis)


def interleave(x, n_shards: int, axis: int = 0) -> np.ndarray:
    """Inverse of :func:`deinterleave`: a global-id-ordered axis into the
    shard-major round-robin layout of the wire."""
    x = np.asarray(x)
    if n_shards <= 1:
        return x
    x = np.moveaxis(x, axis, 0)
    s = int(n_shards)
    t = x.shape[0]
    x = x.reshape((t // s, s) + x.shape[1:]).swapaxes(0, 1).reshape(
        (t,) + x.shape[1:])
    return np.moveaxis(x, 0, axis)


def _empty_events(model: Model, sim: SimConfig,
                  n_ticks: Optional[int] = None) -> np.ndarray:
    """Zero-size dense event block of a shard that records nothing."""
    ticks = sim.n_ticks if n_ticks is None else n_ticks
    return np.zeros((ticks, 0, sim.client.n_clients, 2, 2 + model.ev_vals),
                    np.int32)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def merge_unsharded_telemetry(tels) -> Telemetry:
    """The shards' recorders merged on the host: per-instance leaves
    joined across shards, the fleet series summed (int32, wrapping)."""
    tels = [Telemetry(*(_np(x) for x in t)) for t in tels]
    merged = Telemetry(*(np.concatenate(xs, axis=0) for xs in zip(*tels)))
    return merged._replace(series=sum(t.series for t in tels))


def _deinterleave_telemetry(tel: Optional[Telemetry], series,
                            n_shards: int) -> Optional[Telemetry]:
    """Per-instance leaves to global-id order, the series as given."""
    if tel is None:
        return None
    return Telemetry(*(series if f == "series"
                       else deinterleave(_np(x), n_shards, axis=0)
                       for f, x in zip(tel._fields, tel)))


def _sum_i32(xs) -> int:
    """The int32 sum of per-shard counters, wrapping as ``psum``."""
    return int(np.int64(sum(int(x) for x in xs)).astype(np.int32))


# the cross-shard reductions of the executors, when a census is open
# (shard_audit.trace_sharded_run): one (primitive, per-shard bytes) each
_CENSUS: List[list] = []


@contextlib.contextmanager
def reduction_census():
    """Collect the cross-shard reductions the executors make while the
    block runs: ``[(primitive, per-shard payload bytes), ...]``, in
    JAX's vocabulary (a sum over the shards is a ``psum``)."""
    got: list = []
    _CENSUS.append(got)
    try:
        yield got
    finally:
        _CENSUS.remove(got)


def _psum(parts):
    """The sum over the shards of one per-shard array (int32, wrapping),
    the counterpart of a ``psum`` over the instance axis; counted by an
    open :func:`reduction_census`."""
    parts = [np.asarray(p) for p in parts]
    for c in _CENSUS:
        c.append(("psum", int(parts[0].nbytes)))
    if parts[0].ndim == 0:
        return _sum_i32(parts)
    return sum(parts[1:], parts[0].copy())


# --- the exchange between the processes of a mesh ---------------------------


def _check_group(mesh: Mesh) -> None:
    """A mesh over several processes needs the process group it names."""
    if mesh.process_count == 1:
        return
    import torch.distributed as dist
    if not dist.is_initialized() \
            or dist.get_world_size() != mesh.process_count \
            or dist.get_rank() != mesh.process_index:
        raise RuntimeError(
            f"a mesh over {mesh.process_count} processes (this one rank "
            f"{mesh.process_index}) needs the matching process group: "
            f"multihost.init() before multihost.make_hybrid_mesh()")


def _all_rows(mesh: Mesh, obj) -> list:
    """``obj`` from every process of the mesh, in rank (row) order, on
    every rank; ``[obj]`` in one process."""
    if mesh.process_count == 1:
        return [obj]
    import torch.distributed as dist
    rows = [None] * mesh.process_count
    dist.all_gather_object(rows, obj)
    return rows


def _root_rows(mesh: Mesh, obj) -> Optional[list]:
    """:func:`_all_rows` gathered on rank 0 only (None elsewhere)."""
    if mesh.process_count == 1:
        return [obj]
    import torch.distributed as dist
    rows = [None] * mesh.process_count if mesh.process_index == 0 else None
    dist.gather_object(obj, rows, dst=0)
    return rows


def _flat(rows) -> list:
    return [x for row in rows for x in row]


def _prepare(sim: SimConfig, seed: int, params) -> int:
    """The sharded runners' shared preamble: the refusals, and the one
    master seed (per-shard decorrelation comes from the global instance
    ids, never from per-shard seeds)."""
    # the per-message journal is a single-device feature
    if sim.journal_instances != 0:
        raise ValueError("journal_instances is not supported under "
                         "sharding (the per-message journal is a "
                         "single-device feature)")
    if params is not None:
        raise ValueError("params: the port's tick builds the model's "
                         "static params from its options "
                         "(runtime.make_tick_fn); pass params=None")
    return _seed32(seed)


@contextlib.contextmanager
def _on(device: torch.device):
    """The shard's device as the thread's current CUDA device, so its
    work and its copies' events go to that device's current stream."""
    with torch.no_grad():
        if device.type == "cuda":
            with torch.cuda.device(device):
                yield
        else:
            yield


def run_sim_unsharded(model: Model, sim: SimConfig, seed: int,
                      n_shards: int, params=None,
                      return_telemetry: bool = False, device=None):
    """The equivalence oracle of :func:`run_sim_sharded`: every shard's
    horizon replayed one after another on one device (``device``,
    default ``cuda``) with the same master seed and global ids
    (:func:`shard_instance_ids`), the same (stats, violations, events)
    — plus, with ``return_telemetry``, the merged recorder. The stats
    are Python-int sums, as JAX's oracle adds them."""
    from ..runtime import run_sim
    seed32 = _prepare(sim, seed, params)
    dev = torch.device(device or "cuda")
    all_ids = shard_instance_ids(sim.n_instances, n_shards)
    stats, viol, evs, tels = None, [], [], []
    for s in range(n_shards):
        carry, ys = run_sim(model, sim, seed32, dev,
                            torch.from_numpy(all_ids[s]).to(dev))
        st = [int(x) for x in carry.stats]
        stats = st if stats is None else [a + b for a, b in zip(stats, st)]
        viol.append(_np(carry.violations))
        evs.append(_np(ys.events) if ys.events is not None
                   else _empty_events(model, sim))
        if carry.telemetry is not None:
            tels.append(carry.telemetry)
    tel = merge_unsharded_telemetry(tels) if tels else None
    violations = deinterleave(np.concatenate(viol, axis=0), n_shards)
    events = deinterleave(np.concatenate(evs, axis=1), n_shards, axis=1)
    out = (NetStats(*stats), violations, events)
    if return_telemetry:
        out = out + (_deinterleave_telemetry(
            tel, None if tel is None else tel.series, n_shards),)
    return out


def run_sim_sharded(model: Model, sim: SimConfig, seed: int, params=None,
                    mesh: Optional[Mesh] = None,
                    return_telemetry: bool = False):
    """Run one ``sim``-sized shard per mesh device (``sim`` describes ONE
    shard), the whole horizon in one pass.

    Returns (fleet-wide NetStats summed over shards with int32 wrap, as
    Python ints; per-instance violation tick counts ``[n_instances *
    S]``; events ``[T, R * S, C, 2, 2 + ev_vals]``) — plus, with
    ``return_telemetry``, the merged recorder (instance leaves
    ``[n_instances * S]``, the fleet series summed), or None when
    telemetry is off. Per-instance axes are in global-id order."""
    from ..runtime import run_sim
    seed32 = _prepare(sim, seed, params)
    mesh = mesh or make_mesh()
    _check_group(mesh)
    S = mesh.size
    all_ids = shard_instance_ids(sim.n_instances, S)

    runs = []
    for s in mesh.local_shards:
        dev = mesh.devices[s]
        with _on(dev):
            runs.append(run_sim(model, sim, seed32, dev,
                                torch.from_numpy(all_ids[s]).to(dev)))
    # every local shard is issued before the first copy to the host waits
    parts = []
    for c, ys in runs:
        c = convert.carry_to_numpy(c)
        parts.append((tuple(c.stats), c.violations,
                      _np(ys.events) if ys.events is not None
                      else _empty_events(model, sim),
                      None if c.telemetry is None else tuple(c.telemetry)))
    # every shard's parts, in global shard order
    parts = _flat(_all_rows(mesh, parts))
    # the single-dispatch runner's cross-shard reductions (JAX psums
    # them inside shard_map): one per NetStats counter, and the series
    stats = NetStats(*(_psum(xs) for xs in zip(*(p[0] for p in parts))))
    violations = deinterleave(
        np.concatenate([p[1] for p in parts], axis=0), S)
    events = deinterleave(np.concatenate([p[2] for p in parts], axis=1),
                          S, axis=1)
    if not return_telemetry:
        return stats, violations, events
    tel = None
    if parts[0][3] is not None:
        tels = [Telemetry(*(_np(x) for x in p[3])) for p in parts]
        merged = Telemetry(*(np.concatenate(xs, axis=0)
                             for xs in zip(*tels)))
        series = _psum([t.series for t in tels])
        tel = _deinterleave_telemetry(merged, series, S)
    return stats, violations, events, tel


def _carry_to_wire(c: Carry, sim: SimConfig) -> Carry:
    """A shard's carry with EVERY leaf leading with a shard-divisible
    axis: scalars -> ``[1]``, the key ``[2] -> [1, 2]``, the telemetry
    series ``[W, lanes] -> [1, W, lanes]``; the instance leaves in the
    canonical (batch-leading) orientation whatever ``sim.layout`` is,
    so the wire is the same for both layouts."""
    c = canonical_carry(c, sim)
    tel = c.telemetry
    if tel is not None:
        tel = tel._replace(series=tel.series.reshape(
            (1,) + tuple(tel.series.shape)))
    return c._replace(stats=NetStats(*(x.reshape(1) for x in c.stats)),
                      key=c.key.reshape((1,) + tuple(c.key.shape)),
                      telemetry=tel)


def _carry_from_wire(w: Carry, sim: SimConfig) -> Carry:
    tel = w.telemetry
    if tel is not None:
        tel = tel._replace(series=tel.series.reshape(
            tuple(tel.series.shape[1:])))
    return carry_from_canonical(w._replace(
        stats=NetStats(*(x.reshape(()) for x in w.stats)),
        key=w.key.reshape(tuple(w.key.shape[1:])), telemetry=tel), sim)


def _shard_wire_structure(model: Model, sim: SimConfig):
    """A one-instance shard's wire carry with numpy leaves (the key as
    uint32): the structure, leaf names and dtypes of every shard's wire,
    whose instance leaves lead with 1 instead of ``n_instances``."""
    one = sim._replace(n_instances=1, record_instances=0,
                       journal_instances=0)
    return convert.carry_to_numpy(_carry_to_wire(
        init_carry(model, one, 0, torch.device("cpu")), one))


def _leaf_kind(name: str) -> str:
    if name.startswith("carry.stats.") or name == "carry.telemetry.series":
        return SHARD_LEAF_SUM
    if name == "carry.key":
        return SHARD_LEAF_KEY
    return SHARD_LEAF_INSTANCE


def wire_leaf_kinds(model: Model, sim: SimConfig) -> List[str]:
    """Per-leaf reshard kind of the wire carry, in leaf order (aligned
    with a sharded checkpoint's ``carry/{i}`` arrays): ``"instance"``
    leaves chunk along the global round-robin instance axis, ``"sum"``
    leaves are per-shard partial sums (the NetStats slots, the fleet
    telemetry series), ``"key"`` is the replicated master key."""
    return [_leaf_kind(name) for name, _ in convert.carry_leaves(
        _shard_wire_structure(model, sim))]


def wire_template(model: Model, sim: SimConfig, mesh) -> Carry:
    """The GLOBAL wire carry's structure, shapes and dtypes at
    ``mesh.size`` shards, as a carry of zero-stride numpy leaves (no
    memory): every shard's leading axis times the shard count.
    ``campaign/checkpoint.restore_carry`` checks a sharded checkpoint
    against it, and reshards a pure shard-count change. Only
    ``mesh.size`` is read."""
    n = int(mesh.size)
    shard = _shard_wire_structure(model, sim)
    leaves = []
    for name, a in convert.carry_leaves(shard):
        lead = (sim.n_instances if _leaf_kind(name) == SHARD_LEAF_INSTANCE
                else 1) * n
        leaves.append(np.broadcast_to(np.zeros((), a.dtype),
                                      (lead,) + a.shape[1:]))
    return convert.carry_with_leaves(shard, leaves)


def _row_type(carry: Carry):
    ns = carry.node_state
    return type(ns) if hasattr(ns, "_fields") else None


def _gather_wire(carries: List[Carry], sim: SimConfig) -> Carry:
    """The wire (numpy leaves, key uint32) of the shards' carries: each
    leaf joined shard-major. Copies each shard to the host."""
    wires = [convert.carry_to_numpy(_carry_to_wire(c, sim))
             for c in carries]
    leaves = [np.concatenate(xs, axis=0) for xs in zip(*(
        [a for _, a in convert.carry_leaves(w)] for w in wires))]
    return convert.carry_with_leaves(wires[0], leaves)


def _exchange_wire(mesh: Mesh, carries: List[Carry], sim: SimConfig,
                   root_only: bool = False) -> Optional[Carry]:
    """The GLOBAL wire of the mesh: this process's shards joined, then
    every process's rows joined in rank order (a process's shards are
    consecutive global shards). With ``root_only`` only rank 0 gets it
    (None elsewhere)."""
    local = _gather_wire(carries, sim)
    if mesh.process_count == 1:
        return local
    leaves = [a for _, a in convert.carry_leaves(local)]
    rows = (_root_rows if root_only else _all_rows)(mesh, leaves)
    if rows is None:
        return None
    return convert.carry_with_leaves(
        local, [np.concatenate(xs, axis=0) for xs in zip(*rows)])


def _split_wire(wire: Carry, mesh: Mesh, sim: SimConfig,
                shards: Optional[Sequence[int]] = None) -> List[Carry]:
    """A global wire (numpy or tensor leaves) into one carry per shard of
    ``shards`` (global indices; default all), each on its shard's
    device."""
    if isinstance(wire.pool, torch.Tensor):
        wire = convert.carry_to_numpy(wire)
    S = mesh.size
    n_instances = sim.n_instances
    named = list(convert.carry_leaves(wire))
    for name, a in named:
        want = (n_instances if _leaf_kind(name) == SHARD_LEAF_INSTANCE
                else 1) * S
        if a.shape[0] != want:
            raise ValueError(
                f"resume wire leaf {name}: leading axis {a.shape[0]}, "
                f"expected {want} at {S} shards of {n_instances} — a "
                f"checkpoint written at another shard count is restored "
                f"with campaign.checkpoint.restore_carry(wire_template("
                f"...), leaves, shard=meta['shard'])")
    out = []
    for s in (range(S) if shards is None else shards):
        leaves = [a[s * (a.shape[0] // S):(s + 1) * (a.shape[0] // S)]
                  for _, a in named]
        part = convert.carry_with_leaves(wire, leaves)
        out.append(_carry_from_wire(convert.carry_from_numpy(
            part, _row_type(wire), mesh.devices[s]), sim))
    return out


def shard_chunk(tick, carry: Carry, ids: torch.Tensor, t0: int,
                length: int, R: int, scan_k: int):
    """One shard's chunk of :func:`run_sim_sharded_chunked`: ``length``
    ticks from ``t0``, then the chunk-end ``[1, 5]`` NetStats snapshot
    and ``[1, k, 3]`` violation scan with global ids. Returns ``(carry',
    outputs)``: the chunk's dense events (when ``R``), the snapshot and
    the scan, which the executor copies to the host and joins there
    (the shard_map boundary of the JAX executor: no reduction runs
    here)."""
    evs = []
    for t in range(t0, t0 + length):
        carry, ys = tick(carry, t)
        if R > 0:
            evs.append(ys.events)
    svec = torch.stack(list(carry.stats)).reshape(1, -1)
    scan = violation_scan(scan_source(carry), carry.telemetry, ids,
                          k=scan_k)[None]
    return carry, (*((torch.stack(evs),) if evs else ()), svec, scan)


def record_shard_chunk(model: Model, sim: SimConfig, n_shards: int,
                       length: int = 4, scan_k: int = DEFAULT_SCAN_TOP_K):
    """The aten graph of shard 0's :func:`shard_chunk` at ``n_shards``
    shards, on ``meta`` tensors (``analysis/cost_model.record_call``): a
    collective the tick issues is recorded at ``n_shards`` (the shard
    pass's census; the executable store's certificate)."""
    from ..analysis.cost_model import META, record_call
    ids = torch.from_numpy(shard_instance_ids(sim.n_instances,
                                              n_shards)[0]).to(META)
    carry = init_carry(model, sim, 0, META, ids)
    tick = make_tick_fn(model, sim, ids, META)
    return record_call(
        lambda c: shard_chunk(tick, c, ids, 0, length,
                              sim.record_instances, scan_k),
        carry, group_size=n_shards)


def run_sim_sharded_chunked(model: Model, sim: SimConfig, seed: int,
                            params=None, mesh: Optional[Mesh] = None,
                            chunk: int = 100,
                            return_telemetry: bool = False,
                            perf: Optional[dict] = None,
                            heartbeat=None, fail_fast: bool = False,
                            scan_k: Optional[int] = None,
                            checkpoint_cb=None,
                            checkpoint_every: int = 0,
                            resume=None, check_mode: Optional[str] = None,
                            return_check_summary: bool = False,
                            profiler=None,
                            aot_store: Optional[str] = None):
    """:func:`run_sim_sharded` in ``chunk``-tick pieces — the production
    executor — with each shard's carry left on its device between
    chunks. ``sim`` describes ONE shard.

    Per chunk every shard runs its ticks with its own global ids and,
    at the chunk's end, takes a detached ``[1, 5]`` NetStats snapshot
    and a ``[1, K, 3]`` violation scan with GLOBAL ids (counting the
    device verdict lanes' flags when ``sim.check_summary`` is on);
    their copies and the chunk's dense events are queued behind the
    work and read once the next chunk is issued. The host joins the
    events in global-id order, sums the snapshots and merges the scans
    (``stream.combine_shard_scans``) for the ``heartbeat`` record (with
    ``fault-fuzz`` span counters over all ``I*S`` global ids on a fuzz
    run and, with ``check_mode``, the ``check`` lane ``{mode, flagged,
    of: I*S}``). ``fail_fast`` stops issuing within one chunk of a
    consumed scan showing a trip. ``scan_k`` defaults to
    ``pipeline.DEFAULT_SCAN_TOP_K``.

    Returns (NetStats summed with int32 wrap, violations ``[I*S]``,
    events ``[T, R*S, C, 2, 2 + ev_vals]`` in global-id order) plus the
    merged telemetry with ``return_telemetry`` and the device verdict
    lanes ``[I*S, N_LANES]`` with ``return_check_summary``.

    ``checkpoint_cb(wire, ticks, host)`` gets, every ``checkpoint_every``
    chunks (not after the last), the global wire carry (numpy leaves) at
    a consistent cut — every shard's chunk just issued is consumed
    before any copy — with ``host = {"events", "chunks", "shard"}``,
    ``shard`` the per-leaf reshard metadata. ``resume`` (a
    ``pipeline.ResumeState`` whose ``carry`` is a global wire, restored
    at any shard count by ``campaign.checkpoint.restore_carry``)
    continues such a cut. ``perf`` (a dict) receives the executor's
    counts and times: per-shard issue seconds, merge seconds, saves.

    ``profiler`` (a ``telemetry.profiler.DeviceProfiler``) captures the
    chunks its ``should_capture`` picks, by absolute chunk index: a
    captured chunk spans every shard's issue, its heartbeat record gains
    ``device-s``, ``device-ms`` and ``device-source``, and ``perf`` the
    roll-up under ``device``. ``aot_store`` (a directory, or None) is
    the certified store of the kernel libraries (``aot_store.py``), as
    on ``pipeline.run_sim_pipelined``: the first chunk of each length
    loads the libraries of this process's shards from the store (a
    hit) or builds and stores them (a miss); the outcome lands under
    ``perf["aot"]``, and the outputs are the same warm or cold.

    On a mesh over several processes every rank calls this with the
    same arguments and issues its own row's shards. Each chunk's
    snapshots, scans and events are all-gathered before they are
    merged, so every rank takes the same ``fail_fast`` decision and
    returns the same outputs; with ``checkpoint_every`` every rank
    stops at the same cuts. Rank 0 alone writes ``heartbeat``, calls
    ``checkpoint_cb`` (with the global wire) and fills ``perf`` (every
    shard's issue seconds, and each process's seconds in the exchange,
    ``process-gather-s``); its ``profiler`` captures its own shards."""
    seed32 = _prepare(sim, seed, params)
    mesh = mesh or make_mesh()
    _check_group(mesh)
    S = mesh.size
    local = list(mesh.local_shards)
    root = mesh.process_index == 0
    if not root:
        heartbeat = None
    I, R = sim.n_instances, sim.record_instances
    if scan_k is None:
        scan_k = DEFAULT_SCAN_TOP_K
    plans = resume_plans(sim.n_ticks, chunk, resume)
    all_ids = shard_instance_ids(I, S)

    # this process's shards: j local, local[j] global
    t_init = time.monotonic()
    devs = [mesh.devices[s] for s in local]
    ids = [torch.from_numpy(all_ids[s]).to(d) for s, d in zip(local, devs)]
    ticks = [make_tick_fn(model, sim, i, d) for i, d in zip(ids, devs)]
    if resume is not None:
        carries = _split_wire(resume.carry, mesh, sim, local)
    else:
        carries = [init_carry(model, sim, seed32, d, i)
                   for i, d in zip(ids, devs)]
    init_s = time.monotonic() - t_init

    events_chunks = ([np.asarray(e) for e in resume.events]
                     if resume is not None else [])
    chunk_idx = [resume.chunks if resume is not None else 0]
    fuzz_windows = None
    if heartbeat is not None and sim.faults.has_fuzz:
        from ..faults import fuzz as faults_fuzz
        fuzz_windows = faults_fuzz.fleet_windows(
            sim.faults, sim.net.n_nodes, seed32,
            np.arange(I * S, dtype=np.int32))
    stats = {"issue-s": [0.0] * len(local), "merge-s": 0.0,
             "gather-s": 0.0, "checkpoint-s": []}

    def issue(j: int, t0: int, length: int):
        """Local shard ``j``'s chunk: the ticks, then the snapshots and
        the queued copies."""
        t_i = time.monotonic()
        with _on(devs[j]):
            carries[j], out = shard_chunk(ticks[j], carries[j], ids[j], t0,
                                          length, R, scan_k)
            fetch = start_fetch(*out)
        stats["issue-s"][j] += time.monotonic() - t_i
        return fetch

    def issue_all(t0: int, length: int):
        return [issue(j, t0, length) for j in range(len(local))]

    from ..aot_store import wrap_sharded
    wrapped, aot_rec = wrap_sharded(issue_all, model=model, sim=sim,
                                    mesh=mesh, carry=carries[0],
                                    scan_k=scan_k, store_dir=aot_store)
    if wrapped is not None:
        issue_all = wrapped

    def consume(fetches, t0: int, length: int, prof_rec=None) -> bool:
        t_m = time.monotonic()
        hosts = [[x.numpy() for x in finish_fetch(f)] for f in fetches]
        # every shard's copies, in global shard order
        t_g = time.monotonic()
        hosts = _flat(_all_rows(mesh, hosts))
        stats["gather-s"] += time.monotonic() - t_g
        if R > 0:
            events = deinterleave(np.concatenate(
                [h[0] for h in hosts], axis=1), S, axis=1)
        else:
            events = _empty_events(model, sim, length)
        # global-id order: chunks written at any shard count join
        events_chunks.append(events)
        svec = np.concatenate([h[-2] for h in hosts], axis=0)
        scan_np = combine_shard_scans(
            np.concatenate([h[-1] for h in hosts], axis=0), None)
        if heartbeat is not None:
            extra = None
            if fuzz_windows is not None:
                from ..faults import fuzz as faults_fuzz
                extra = {"fault-fuzz": faults_fuzz.span_counters(
                    fuzz_windows, t0, length)}
            if sim.check_summary and check_mode:
                extra = dict(extra or {})
                extra["check"] = {"mode": check_mode,
                                  "flagged": int(scan_np[0, 0]),
                                  "of": I * S}
            if prof_rec is not None:
                extra = dict(extra or {})
                extra["device-ms"] = prof_rec["per-phase-ms"]
                extra["device-source"] = prof_rec["source"]
            heartbeat.record_chunk(
                chunk=chunk_idx[0], t0=t0, ticks=length,
                net=stats_vec_to_net(svec.sum(axis=0)),
                violation=scan_to_violation(scan_np),
                violations=scan_to_violations(scan_np),
                device_s=(prof_rec["device-s"] if prof_rec is not None
                          else None),
                extra=extra)
        chunk_idx[0] += 1
        stats["merge-s"] += time.monotonic() - t_m
        return int(scan_np[0, 0]) > 0

    # over several processes every rank cuts at the same chunks, whether
    # or not it was given the callback (rank 0 calls it)
    shard_meta = {"n-shards": S, "instances-per-shard": I,
                  "interleaved": True,
                  "leaf-kinds": wire_leaf_kinds(model, sim)} \
        if checkpoint_every > 0 and (checkpoint_cb is not None
                                     or mesh.process_count > 1) else None
    pending = None
    issued = 0
    ticks_dispatched = resume.ticks if resume is not None else 0
    stopped = False
    t_run = time.monotonic()
    dispatch_idx = resume.chunks if resume is not None else 0
    for i, (t0, length) in enumerate(plans):
        prof_rec = None
        if profiler is not None and profiler.should_capture(dispatch_idx):
            fetches, prof_rec = profiler.capture(
                issue_all, (t0, length), length, devices=devs)
        else:
            fetches = issue_all(t0, length)
        dispatch_idx += 1
        ticks_dispatched = t0 + length
        # chunk k's copies are read once chunk k+1 is issued
        tripped = consume(*pending) if pending is not None else False
        pending = (fetches, t0, length, prof_rec)
        issued += 1
        if shard_meta is not None and issued % checkpoint_every == 0 \
                and i + 1 < len(plans):
            # a consistent cut: every shard's chunk just issued is
            # consumed before any copy of the carry
            tripped = consume(*pending) or tripped
            pending = None
            t_c = time.monotonic()
            wire = _exchange_wire(mesh, carries, sim, root_only=True)
            if wire is not None and checkpoint_cb is not None:
                checkpoint_cb(wire, ticks_dispatched,
                              {"events": list(events_chunks),
                               "chunks": chunk_idx[0], "shard": shard_meta})
            stats["checkpoint-s"].append(round(time.monotonic() - t_c, 4))
        if fail_fast and tripped:
            stopped = True
            break
    if pending is not None:
        consume(*pending)
    wire = _exchange_wire(mesh, carries, sim)
    rows = _all_rows(mesh, (stats["issue-s"], round(stats["gather-s"], 4)))
    if perf is not None and root:
        perf.update({
            "chunks": issued, "chunk-ticks": plan_chunks(sim.n_ticks,
                                                         chunk)[0][1],
            "shards": S,
            "init-s": round(init_s, 4),
            "run-s": round(time.monotonic() - t_run, 4),
            "shard-issue-s": [round(x, 4) for x in _flat(r[0]
                                                          for r in rows)],
            "merge-s": round(stats["merge-s"], 4),
            "ticks-dispatched": ticks_dispatched})
        if mesh.process_count > 1:
            perf["processes"] = mesh.process_count
            perf["process-gather-s"] = [r[1] for r in rows]
        if stats["checkpoint-s"]:
            perf["checkpoints"] = len(stats["checkpoint-s"])
            perf["checkpoint-s"] = round(sum(stats["checkpoint-s"]), 4)
            perf["checkpoint-save-s"] = stats["checkpoint-s"]
        if resume is not None:
            perf["resumed-from-ticks"] = resume.ticks
        if stopped:
            perf["stopped-early"] = True
        if profiler is not None and profiler.records:
            perf["device"] = profiler.summary()
        if aot_rec is not None:
            from ..aot_store import finalize_record
            perf["aot"] = finalize_record(aot_rec)

    # the per-shard NetStats slots summed with int32 wrap; int adds
    # commute, so the total is invariant to how a reshard regrouped them
    net = NetStats(*(_sum_i32(x) for x in wire.stats))
    violations = deinterleave(wire.violations, S, axis=0)
    out = (net, violations, np.concatenate(events_chunks, axis=0))
    if return_telemetry:
        tel = wire.telemetry
        if tel is not None:
            # the series crossed as one [S, W, lanes] block: fleet-merge it
            tel = _deinterleave_telemetry(tel, tel.series.sum(axis=0), S)
        out = out + (tel,)
    if return_check_summary:
        cs = wire.check_summary
        out = out + (None if cs is None else deinterleave(cs, S, axis=0),)
    return out
