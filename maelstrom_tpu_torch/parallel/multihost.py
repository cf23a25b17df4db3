"""Runs over several processes: one process per shard row of a hybrid
mesh, joined by a ``torch.distributed`` process group.

Counterpart of ``maelstrom_tpu/parallel/multihost.py``. At multi-host
scale the same data parallelism factors over two axes — processes over
the data-center network (``dcn``), the cards of each process (``ici``)
— and only the reduced fleet counters and the merged per-instance
outputs cross processes. The sharded executor
(:func:`.mesh.run_sim_sharded`, :func:`.mesh.run_sim_sharded_chunked`)
issues the shards of its own row and exchanges the rest::

    from maelstrom_tpu_torch.parallel import mesh, multihost
    multihost.init()                       # from MASTER_ADDR, RANK, ...
    m = multihost.make_hybrid_mesh()       # ("dcn", "ici"), (P, n_cards)
    stats, violations, events = mesh.run_sim_sharded(
        model, sim, seed=0, mesh=m)        # the same on every rank

With one process :func:`init` does nothing and the mesh is ``(1,
n_cards)``. :func:`spawn` starts ``P`` processes on this host, each
joined to the group before it calls its function.

The process group is **gloo**, not NCCL, for two reasons:

- the executor joins its shards on the host (the NetStats sums, the
  scans, events, violations and telemetry are numpy), so the
  collectives carry host data;
- NCCL refuses two ranks on one card, and a process per shard row on a
  one-card host puts every rank on ``cuda:0``.

Every group is opened with a ``timeout``: a rank that raises leaves the
others waiting in a collective, and they raise when it runs out. No
rank ever returns a one-process result.
"""

from __future__ import annotations

import datetime
import os
import queue
import socket
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh

DCN_AXIS = "dcn"
ICI_AXIS = "ici"

DEFAULT_TIMEOUT_S = 300.0


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v in (None, "") else int(v)


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None,
         timeout: float = DEFAULT_TIMEOUT_S) -> None:
    """Join this process to a gloo process group of ``num_processes``.

    Takes ``jax.distributed.initialize``'s keyword names; what is not
    given comes from the variables torch's launchers set:
    ``coordinator_address`` from ``MASTER_ADDR`` and ``MASTER_PORT``
    (``"host:port"``), ``num_processes`` from ``WORLD_SIZE``,
    ``process_id`` from ``RANK``. With one process it does nothing.
    ``timeout`` (seconds) bounds the rendezvous and every collective.
    Raises when several processes are asked for without a coordinator
    address or a rank, or when a group of another size is already
    open."""
    n = num_processes if num_processes is not None else _env_int(
        "WORLD_SIZE")
    n = int(n or 1)
    if n <= 1:
        return
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise RuntimeError(
                f"multihost.init: a group of {dist.get_world_size()} "
                f"processes is already open, {n} asked for")
        return
    if coordinator_address is None:
        host, port = os.environ.get("MASTER_ADDR"), os.environ.get(
            "MASTER_PORT")
        if not host or not port:
            raise ValueError(
                f"multihost.init: {n} processes need a coordinator "
                f"address: pass coordinator_address='host:port' or set "
                f"MASTER_ADDR and MASTER_PORT")
        coordinator_address = f"{host}:{port}"
    rank = process_id if process_id is not None else _env_int("RANK")
    if rank is None:
        raise ValueError(f"multihost.init: {n} processes need this "
                         f"process's rank: pass process_id= or set RANK")
    if not 0 <= int(rank) < n:
        raise ValueError(f"multihost.init: rank {rank} outside 0..{n - 1}")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}", world_size=n,
        rank=int(rank), timeout=datetime.timedelta(seconds=float(timeout)))


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def shutdown() -> None:
    """Leave the process group (nothing to do without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_hybrid_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """The ``(n_processes, per_host)`` mesh named ``("dcn", "ici")``.

    This process's row is every visible card, or ``devices`` as given
    (CPU devices, or a card repeated); the other rows name the other
    processes' devices, gathered from them. Raises on every rank when
    the processes hold different numbers of devices (JAX assumes they
    are equal)."""
    local = make_mesh(devices=devices).devices
    P = process_count()
    if P == 1:
        return Mesh(local, (DCN_AXIS, ICI_AXIS), (1, len(local)))
    rows: List = [None] * P
    dist.all_gather_object(rows, [str(d) for d in local])
    counts = [len(r) for r in rows]
    if len(set(counts)) != 1:
        raise ValueError(
            f"make_hybrid_mesh: the processes hold different numbers of "
            f"devices {counts} (by rank); every row of the mesh must be "
            f"as wide")
    return Mesh([d for r in rows for d in r], (DCN_AXIS, ICI_AXIS),
                (P, counts[0]), process_index=process_index(),
                process_count=P)


# --- spawning the processes of one host ---------------------------------------


def _free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child(rank: int, nprocs: int, port: int, timeout: float,
           threads: Optional[int], fn: Callable, args: tuple,
           results) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE=str(nprocs), RANK=str(rank))
    if threads:
        torch.set_num_threads(threads)
    try:
        init(timeout=timeout)
        out = fn(*args)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        shutdown()


def spawn(fn: Callable, args: tuple = (), nprocs: int = 2,
          timeout: float = DEFAULT_TIMEOUT_S,
          threads: Optional[int] = None,
          group_timeout: Optional[float] = None) -> list:
    """Run ``fn(*args)`` in ``nprocs`` processes started with the
    ``spawn`` method, each joined by :func:`init` to one gloo group on a
    free localhost port (``fn`` must be importable by name). Returns
    each rank's return value, in rank order. Raises, after killing the
    others, when any rank raises or dies, or when ``timeout`` seconds
    pass. ``group_timeout`` (default ``timeout``) is the group's own
    collective timeout; ``threads`` sets each process's torch
    threads."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_child,
                         args=(r, nprocs, port, group_timeout or timeout,
                               threads, fn, args, results))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    out: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < nprocs:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"multihost.spawn: {nprocs - len(out)} of {nprocs} "
                    f"processes did not finish within {timeout:.0f} s")
            try:
                rank, ok, val = results.get(timeout=min(left, 1.0))
            except queue.Empty:   # look for a dead process
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    # its message may still be in the pipe
                    try:
                        rank, ok, val = results.get(timeout=2.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"multihost.spawn: rank {dead[0]} died with "
                            f"exit code {procs[dead[0]].exitcode}") from None
                else:
                    continue
            if not ok:
                raise RuntimeError(f"multihost.spawn: rank {rank} "
                                   f"raised:\n{val}")
            out[rank] = val
    finally:
        for p in procs:
            p.join(timeout=10.0 if len(out) == nprocs else 0.1)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return [out[r] for r in range(nprocs)]
