"""The sharded flagship at one shard and at several, on the card.

    python -m maelstrom_tpu_torch.bench_mesh [--instances 8192]
        [--ticks 300] [--shards 1,2] [--rounds 2] [--out FILE]

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
from .parallel import mesh

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


def same(a, b) -> bool:
    return (tuple(a[0]) == tuple(b[0]) and np.array_equal(a[1], b[1])
            and np.array_equal(a[2], b[2])
            and all(np.array_equal(x, y) for x, y in zip(a[3], b[3])))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--instances", type=int, default=8192)
    ap.add_argument("--ticks", type=int, default=300)
    ap.add_argument("--shards", default="1,2")
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
    records, ref = [], None
    for r in range(args.rounds):
        for n_shards in (configs if r % 2 == 0 else configs[::-1]):
            out, rec = run_once(model, opts, args.instances, n_shards)
            if ref is None and n_shards == 1:
                ref = out
            rec.update(round=r, card=card,
                       equal_to_one_shard=None if ref is None
                       else same(ref, out))
            if rec["equal_to_one_shard"] is False:
                raise AssertionError(f"the {n_shards}-shard run differs "
                                     f"from the one-shard run")
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
