"""The delivery kernel against an earlier version of it, on one card.

    python -m maelstrom_tpu_torch.bench_deliver --baseline OLD.cu
        [--iters 200] [--out chiprun_out/bench_deliver.json]

``OLD.cu`` is an earlier ``csrc/deliver.cu`` with the first port's C
interface: ``deliver_launch(pool, part, t, pool_out, inbox, n_del,
n_drop, I, S, L, NT, K, instances_per_block, threads, stream)`` and a
kernel named ``deliver_kernel`` (get it with ``git show
<commit>:maelstrom_tpu_torch/csrc/deliver.cu``). Both are built here
with the same flags, held bit-equal to ``deliver_reference``, and timed
in turns (old, new, new, old) at the flagship and the CLI-default shapes
by :func:`kernels.devtime.device_ms`, with the L2 cache flushed before
each launch and without. Prints the card's name and power limit and one
JSON object, which it also writes to ``--out``. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os

import numpy as np
import torch

from . import netsim
from .kernels import build, delivery, delivery_cases, devtime

# the first port's launch geometry: a block of 256 threads holds as many
# instances' rows as fit in 48 KB of shared memory, at most 16
_OLD_THREADS = 256


def _old_ipb(S: int, L: int) -> int:
    return max(1, min(16, 48 * 1024 // (S * L * 4 + 2 * S)))


def old_deliver(src: str):
    """A callable ``(pool, parts, t, cfg) -> outputs`` for the kernel in
    ``src``, launched as the first port's wrapper launched it."""
    fn = build.load_file(src).deliver_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] \
        + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(pool, parts, t, cfg):
        I, S, L = pool.shape
        NT, K = cfg.n_total, cfg.inbox_k
        out = (torch.empty_like(pool),
               torch.empty((I, NT, K, L), dtype=torch.int32,
                           device=pool.device),
               torch.empty((I,), dtype=torch.int32, device=pool.device),
               torch.empty((I,), dtype=torch.int32, device=pool.device))
        err = fn(pool.data_ptr(), parts.data_ptr(), int(t),
                 *(o.data_ptr() for o in out), I, S, L, NT, K,
                 _old_ipb(S, L), _OLD_THREADS,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"old deliver kernel: CUDA error {err}")
        return out
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m maelstrom_tpu_torch."
                                      "bench_deliver")
    ap.add_argument("--baseline", required=True)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--out", default="chiprun_out/bench_deliver.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_deliver needs a CUDA card")
    build.build_all([delivery.SOURCE])
    kernels = {"old": (old_deliver(args.baseline), "deliver_kernel"),
               "new": (delivery.deliver, delivery.KERNEL_NAME)}
    rec = {"card": devtime.card_line(), "iters": args.iters, "shapes": {}}
    for shape in delivery_cases.TIMED:
        n, c, S, K, body, I = delivery_cases.SHAPES[shape]
        cfg = delivery_cases.net_config(n, c, S, K, body)
        pools, parts = delivery_cases.random_pools(
            np.random.RandomState(5), I, cfg)
        pool = torch.from_numpy(pools).cuda()
        part = torch.from_numpy(parts).cuda()
        t = 15
        ref = netsim.deliver_reference(pool, part, t, cfg)
        for who, (fn, _) in kernels.items():
            if not all(torch.equal(g, r)
                       for g, r in zip(fn(pool, part, t, cfg), ref)):
                raise AssertionError(f"{who} kernel != plain version at "
                                     f"{shape}")
        bound_ms = delivery_cases.bound(pool, part, t, cfg)[0]
        runs = {who: {"device_ms": [], "device_warm_ms": []}
                for who in kernels}
        for who in ("old", "new", "new", "old"):
            fn, name = kernels[who]
            call = lambda: fn(pool, part, t, cfg)
            runs[who]["device_ms"].append(
                devtime.device_ms(call, name, args.iters))
            runs[who]["device_warm_ms"].append(
                devtime.device_ms(call, name, args.iters, flush_l2=False))
        for r in runs.values():
            r["bound_share"] = [bound_ms / x for x in r["device_ms"]]
        rec["shapes"][shape] = {"I": I, "S": S, "K": K, "NT": cfg.n_total,
                                "L": cfg.lanes, "bound_ms": bound_ms,
                                **runs}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(rec["card"])
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
