"""The sharded flagship at one shard and at several, on the card.

    python -m maelstrom_tpu_torch.bench_mesh [--instances 8192]
        [--ticks 300] [--shards 1,2] [--processes P] [--rounds 2]
        [--out FILE]

Runs ``parallel.mesh.run_sim_sharded_chunked`` on the lin-kv flagship
(``fleets.FLAGSHIP`` and its model; 4 recorded instances in all) at
``--instances`` global instances for ``--ticks`` ticks in 100-tick
chunks, at each shard count of ``--shards``, after a short warm-up run.
The shards sit round-robin on the visible cards (all on ``cuda:0`` on a
one-card host). The shard counts run in turns, ``--rounds`` times (the
order reversed every other round), and every run must equal the first
one-shard run (stats, violations, events, the merged telemetry). Prints
the card's name and power limit and one JSON object per run — ticks/s,
simulated msgs/s, the executor's per-shard issue seconds and merge
seconds, the delivery launches by device — and writes them all to
``--out`` when given. Needs a CUDA card.

``--processes P`` adds, in every round, a run over ``P`` processes
(``parallel.multihost.spawn``: the ``spawn`` start method, a gloo group
on localhost), one shard each, on the visible cards round-robin — all
on ``cuda:0`` on a one-card host — at the same global instance count:
its ticks/s beside the one-process runs of the same call, every shard's
issue seconds, each process's gather seconds and its launches by
device. It too must equal the one-shard run.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from . import fleets, harness
from .kernels import delivery, devtime
from .parallel import mesh, multihost

RECORDED = 4


def run_once(model, opts, n_global: int, n_shards: int):
    """One timed run: ``(outputs, record)``."""
    sim = harness.make_sim_config(model, dict(
        opts, n_instances=n_global // n_shards,
        record_instances=RECORDED // n_shards))
    vis = torch.cuda.device_count()
    devices = [torch.device("cuda", s % vis) for s in range(n_shards)]
    perf = {}
    delivery.reset_launches()
    for d in set(devices):
        torch.cuda.synchronize(d)
    t0 = time.monotonic()
    out = mesh.run_sim_sharded_chunked(
        model, sim, int(opts["seed"]), mesh=mesh.make_mesh(devices=devices),
        chunk=100, perf=perf, return_telemetry=True)
    wall = time.monotonic() - t0
    return out, {
        "shards": n_shards, "devices": [str(d) for d in devices],
        "ticks": sim.n_ticks,
        "wall-s": wall, "ticks-per-s": sim.n_ticks / wall,
        "msgs-per-s": int(out[0].delivered) / wall,
        "shard-issue-s": perf["shard-issue-s"], "merge-s": perf["merge-s"],
        "init-s": perf["init-s"],
        "launches-by-device": dict(delivery.deliver.launches_by_device)}


def process_run(opts, n_global: int) -> dict:
    """One rank of a ``--processes`` run (in a spawned process joined to
    the group): a warm-up, then the timed run of this process's shard.
    Returns its record; rank 0 adds the outputs."""
    model, _ = fleets.fleet("lin-kv")
    P, rank = multihost.process_count(), multihost.process_index()
    device = torch.device("cuda", rank % torch.cuda.device_count())
    m = multihost.make_hybrid_mesh(devices=[device])
    seed = int(opts["seed"])
    # the process's first run pays for the CUDA context and the kernel
    warm = harness.make_sim_config(model, dict(
        opts, time_limit=0.01, n_instances=RECORDED // P,
        record_instances=RECORDED // P))
    mesh.run_sim_sharded_chunked(model, warm, seed, mesh=m, chunk=100)
    sim = harness.make_sim_config(model, dict(
        opts, n_instances=n_global // P, record_instances=RECORDED // P))
    perf = {}
    delivery.reset_launches()
    torch.cuda.synchronize(device)
    torch.distributed.barrier()
    t0 = time.monotonic()
    out = mesh.run_sim_sharded_chunked(model, sim, seed, mesh=m, chunk=100,
                                       perf=perf, return_telemetry=True)
    wall = time.monotonic() - t0
    rec = {"rank": rank, "device": str(device), "wall-s": wall,
           "launches-by-device": dict(delivery.deliver.launches_by_device)}
    if rank == 0:
        rec.update(perf=perf, ticks=sim.n_ticks, out=out)
    return rec


def run_processes(opts, n_global: int, n_procs: int):
    """A ``--processes`` run: ``(outputs, record)``, the record's wall and
    rates rank 0's."""
    ranks = multihost.spawn(process_run, (opts, n_global), nprocs=n_procs,
                            timeout=900.0)
    r0 = ranks[0]
    perf = r0["perf"]
    return r0["out"], {
        "shards": perf["shards"], "processes": n_procs,
        "devices": [r["device"] for r in ranks], "ticks": r0["ticks"],
        "wall-s": r0["wall-s"], "ticks-per-s": r0["ticks"] / r0["wall-s"],
        "msgs-per-s": int(r0["out"][0].delivered) / r0["wall-s"],
        "shard-issue-s": perf["shard-issue-s"],
        "process-gather-s": perf["process-gather-s"],
        "merge-s": perf["merge-s"], "init-s": perf["init-s"],
        "launches-by-device": [r["launches-by-device"] for r in ranks]}


def same(a, b) -> bool:
    return (tuple(a[0]) == tuple(b[0]) and np.array_equal(a[1], b[1])
            and np.array_equal(a[2], b[2])
            and all(np.array_equal(x, y) for x, y in zip(a[3], b[3])))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--instances", type=int, default=8192)
    ap.add_argument("--ticks", type=int, default=300)
    ap.add_argument("--shards", default="1,2")
    ap.add_argument("--processes", type=int, default=0,
                    help="add a run over this many processes, one shard "
                         "each (0: none)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_mesh needs a CUDA card")
    model, opts = fleets.fleet("lin-kv")
    card = devtime.card_line()
    print(card, flush=True)
    # the first run in a process pays for the CUDA context and the build
    run_once(model, dict(opts, time_limit=0.01), RECORDED, 1)
    opts = dict(opts, time_limit=args.ticks / 1000.0)
    configs = [int(s) for s in args.shards.split(",")]
    if args.processes:
        configs.append(("processes", args.processes))
    records, ref = [], None
    for r in range(args.rounds):
        for cfg in (configs if r % 2 == 0 else configs[::-1]):
            if isinstance(cfg, tuple):
                out, rec = run_processes(opts, args.instances, cfg[1])
                what = f"{cfg[1]}-process"
            else:
                out, rec = run_once(model, opts, args.instances, cfg)
                what = f"{cfg}-shard"
                if ref is None and cfg == 1:
                    ref = out
            rec.update(round=r, card=card,
                       equal_to_one_shard=None if ref is None
                       else same(ref, out))
            if rec["equal_to_one_shard"] is False:
                raise AssertionError(f"the {what} run differs from the "
                                     f"one-shard run")
            print(json.dumps(rec), flush=True)
            records.append(rec)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "instances": args.instances,
                       "runs": records}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
